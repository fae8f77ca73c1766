"""Hybrid dense∥sparse fusion benchmark: recall vs fusion weight
(DESIGN.md §13; port of ``benchmarks/hybrid_fusion.py``).

    python -m repro_torch.benchmarks.hybrid_fusion --smoke --check \\
        --device cpu --out /tmp/BENCH_hybrid.json                 # CPU
    python -m repro_torch.benchmarks.hybrid_fusion --check        # card

Builds the index with the BM25 impact plane (``sparse=True``) over the
*weaker* model-B encoder of the synthetic corpus — the paper's
robustness setting (§5.3): when the dense model is imperfect, the
lexical channel rescues queries the embedding space misses.  Then
sweeps the RRF dense weight from 0.0 (pure lexical) to 1.0 (pure
dense) and reports recall@R against the generator's qrels at each
point, next to the dense-only baseline.

With ``--check`` it exits nonzero if

  · ``fusion_weight=1.0`` is not bit-identical to dense-only search
    (the §13 degenerate-weight contract: zero sparse contributions
    must change nothing), or
  · a FusionSpec on an index without the impact plane does not fall
    back to the exact dense result (ids AND scores), or
  · the best fused recall@R falls below dense-only recall@R — fusion
    must never cost quality at its operating point.

All quality fields are deterministic on one device; the
``search_us_per_batch`` fields are host-clock µs of synchronized calls.
:func:`build` makes the corpus and index, :func:`run_rows` sweeps a
given index.  The report goes to stdout and, with ``--out``, to that
file only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

from repro_torch import device as dev_mod
from repro_torch.benchmarks import timing
from repro_torch.core import codecs, hybrid_index as hi, metrics
from repro_torch.core import exec as qexec
from repro_torch.data import synthetic

WEIGHTS = (0.0, 0.25, 0.5, 0.75, 1.0)


def _time_call(fn, dev: torch.device) -> float:
    return timing.mean_us(fn, device=dev, warmup=2, iters=5)  # µs per call


def scale(args) -> tuple:
    """(n_docs, n_queries, build kwargs, vocab, hidden, topics)."""
    codec = args.codec or codecs.DEFAULT
    if args.smoke:
        return 4000, 64, dict(n_clusters=64, k1_terms=8, codec=codec,
                              pq_m=4, pq_k=64, cluster_capacity=192,
                              term_capacity=96, kmeans_iters=5), 2048, 32, 32
    return 20_000, 256, dict(n_clusters=256, k1_terms=12, codec=codec,
                             pq_m=8, pq_k=256, cluster_capacity=256,
                             term_capacity=128, kmeans_iters=10), 8192, 64, 128


def build(args) -> tuple:
    """(corpus, the model-B index with the impact plane, on
    ``args.device``)."""
    dev = dev_mod.resolve(args.device)
    codecs.get(args.codec or codecs.DEFAULT)   # fail fast on typos
    n_docs, n_queries, build_kwargs, vocab, hidden, topics = scale(args)
    corpus = synthetic.generate(seed=0, n_docs=n_docs, n_queries=n_queries,
                                hidden=hidden, vocab_size=vocab,
                                n_topics=topics)
    index = hi.build(0, corpus.doc_emb_b, corpus.doc_tokens,
                     corpus.vocab_size, sparse=True, device=dev,
                     **build_kwargs)
    return corpus, index


def run_rows(args, corpus, index) -> dict:
    """The report over ``index`` (built as :func:`build` does)."""
    dev = dev_mod.resolve(args.device)
    codec = args.codec or codecs.DEFAULT
    n_docs, n_queries = corpus.doc_emb.shape[0], corpus.query_emb.shape[0]
    # model B: the degraded encoder — the robustness setting where the
    # sparse channel has signal the dense one lacks
    qe = torch.from_numpy(corpus.query_emb_b).to(dev)
    qt = torch.from_numpy(corpus.query_tokens).to(dev)
    kc, k2, top_r = 6, 8, args.top_r

    def search(idx, fusion=None):
        return hi.search(idx, qe, qt, kc=kc, k2=k2, top_r=top_r,
                         fusion=fusion, device=dev)

    report = {
        "bench": "hybrid",
        "smoke": bool(args.smoke),
        "codec": codec,
        "encoder": "model_b",
        "n_docs": n_docs,
        "n_queries": n_queries,
        "top_r": top_r,
        "rrf_k": qexec.FusionSpec().rrf_k,
        "candidate_budget": hi.candidate_budget(index, kc, k2),
        "points": [],
    }
    failures = []

    # --- dense-only baseline ---------------------------------------------
    dense = search(index)
    dense_recall = metrics.recall_at_k(dense.doc_ids, corpus.qrels, top_r)
    report["dense_only"] = {
        f"R@{top_r}": dense_recall,
        "mean_candidates": float(dense.n_candidates.cpu().float().mean()),
        "search_us_per_batch": round(_time_call(lambda: search(index),
                                                dev), 1),
    }

    # --- fallback contract: FusionSpec without the impact plane ----------
    stripped = dataclasses.replace(index, sparse_weights=None)
    fb = search(stripped, qexec.FusionSpec(weight=0.5))
    fallback_ok = (torch.equal(dense.doc_ids, fb.doc_ids)
                   and torch.equal(dense.scores, fb.scores))
    report["fallback_equals_dense"] = bool(fallback_ok)
    if not fallback_ok:
        failures.append("dense-only fallback is not bit-identical")

    # --- fusion-weight sweep ---------------------------------------------
    best_weight, best_recall = None, -1.0
    for w in WEIGHTS:
        fus = qexec.FusionSpec(weight=w)
        res = search(index, fus)
        us = _time_call(lambda: search(index, fus), dev)
        recall = metrics.recall_at_k(res.doc_ids, corpus.qrels, top_r)
        point = {
            "fusion_weight": w,
            f"R@{top_r}": recall,
            "mean_candidates": float(res.n_candidates.cpu().float().mean()),
            "search_us_per_batch": round(us, 1),
        }
        if w == 1.0:
            identical = torch.equal(res.doc_ids, dense.doc_ids)
            point["ids_equal_dense_only"] = bool(identical)
            if not identical:
                failures.append("fusion_weight=1.0 is not bit-identical "
                                "to dense-only search")
        report["points"].append(point)
        if recall > best_recall:
            best_weight, best_recall = w, recall

    report["best_weight"] = best_weight
    report[f"best_R@{top_r}"] = best_recall
    report["fused_ge_dense"] = bool(best_recall >= dense_recall)
    if best_recall < dense_recall:
        failures.append(
            f"best fused R@{top_r} {best_recall:.4f} < dense-only "
            f"{dense_recall:.4f}")

    report["check_failures"] = failures
    return report


def run(args) -> dict:
    return run_rows(args, *build(args))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized corpus")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero on contract violations")
    ap.add_argument("--codec", default=None,
                    help="codec spec (default: registry default)")
    ap.add_argument("--top-r", type=int, default=100)
    ap.add_argument("--out", default=None, help="also write JSON here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (their plain "
                         "versions)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    report = run(args)
    text = json.dumps(report, indent=1, sort_keys=True)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    if args.check and report["check_failures"]:
        sys.exit("hybrid-fusion contract violated: "
                 + "; ".join(report["check_failures"]))


if __name__ == "__main__":
    main()

"""Streaming-updates benchmark (port of ``benchmarks/streaming_updates.py``;
DESIGN.md §8): search throughput against delta fill, tombstone honesty
and compaction cost.

    python -m repro_torch.benchmarks.streaming_updates --smoke --check \\
        --device cpu                                    # CPU, plain path
    python -m repro_torch.benchmarks.streaming_updates --check --out F.json

Builds a mutable index over most of the synthetic corpus on ``--device``,
streams the held-out tail through ``add_docs`` in fill steps, deletes a
quarter of the streamed docs, compacts, and reports per-step recall (a
function of the data and the seed) and timings (a synchronize-ended host
clock, µs per batch over 5 calls after 2 warm-up calls).  The report has
the reference's keys.  ``--check`` exits non-zero if a tombstoned doc
surfaces or the compacted index differs from a from-scratch rebuild over
the survivors (ids or scores).  The report goes to stdout and, with
``--out``, to that file only.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch import device as dev_mod
from repro_torch.core import codecs
from repro_torch.core import hybrid_index as hi
from repro_torch.core import metrics
from repro_torch.core import segments as seg
from repro_torch.data import synthetic

FILL_STEPS = (0.25, 0.5, 1.0)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_call(fn, dev: torch.device, warmup: int = 2, iters: int = 5
               ) -> float:
    """µs per call, host clock, synchronized at both ends."""
    for _ in range(warmup):
        fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / iters * 1e6


def run(args) -> dict:
    codec = args.codec or codecs.DEFAULT
    codecs.get(codec)    # fail fast on typos, listing registered names
    dev = dev_mod.resolve(args.device)

    if args.smoke:
        n_docs, stream, n_queries = 4000, 512, 64
        build_kwargs = dict(n_clusters=64, k1_terms=8, codec=codec,
                            pq_m=4, pq_k=64, cluster_capacity=192,
                            term_capacity=96, kmeans_iters=5)
        vocab, hidden, topics = 2048, 32, 32
    else:
        n_docs, stream, n_queries = 20_000, 2048, 256
        build_kwargs = dict(n_clusters=256, k1_terms=12, codec=codec,
                            pq_m=8, pq_k=256, cluster_capacity=256,
                            term_capacity=128, kmeans_iters=10)
        vocab, hidden, topics = 8192, 64, 128

    corpus = synthetic.generate(seed=0, n_docs=n_docs, n_queries=n_queries,
                                hidden=hidden, vocab_size=vocab,
                                n_topics=topics)
    qe = torch.from_numpy(corpus.query_emb).to(dev)
    qt = torch.from_numpy(corpus.query_tokens).to(dev).long()
    kc, k2, top_r = 6, 8, args.top_r

    t0 = time.perf_counter()
    mut = seg.MutableHybridIndex.create(
        0, corpus.doc_emb[:-stream], corpus.doc_tokens[:-stream],
        corpus.vocab_size, delta_capacity=stream, device=dev,
        **build_kwargs)
    _sync(dev)
    build_s = time.perf_counter() - t0

    def search(index):
        return index.search(qe, qt, kc=kc, k2=k2, top_r=top_r)

    def point(fill_fraction: float) -> dict:
        r = search(mut)
        return {
            "fill_fraction": fill_fraction,
            "delta_docs": mut.delta_count,
            "R@100": metrics.recall_at_k(r.doc_ids.cpu(), corpus.qrels, 100),
            "mean_candidates": float(r.n_candidates.float().mean()),
            "search_us_per_batch": round(
                _time_call(lambda: search(mut), dev), 1),
        }

    report = {
        "bench": "streaming",
        "smoke": bool(args.smoke),
        "codec": codec,
        "n_docs": n_docs,
        "streamed_docs": stream,
        "n_queries": n_queries,
        "top_r": top_r,
        "candidate_budget_base": hi.candidate_budget(mut.base, kc, k2),
        "candidate_budget_mutable": mut.candidate_budget(kc, k2),
        "candidate_cost_mutable": mut.candidate_cost(kc, k2, top_r),
        "base_build_seconds": round(build_s, 2),
        "points": [point(0.0)],
    }

    # --- stream the held-out tail in fill-fraction steps -----------------
    tail_emb = corpus.doc_emb[-stream:]
    tail_tok = corpus.doc_tokens[-stream:]
    added_ids, done = [], 0
    add_s = 0.0
    for frac in FILL_STEPS:
        upto = int(round(frac * stream))
        t0 = time.perf_counter()
        ids = mut.add_docs(tail_emb[done:upto], tail_tok[done:upto])
        add_s += time.perf_counter() - t0
        added_ids.append(ids)
        done = upto
        report["points"].append(point(frac))
    added = np.concatenate(added_ids)
    report["add_seconds_total"] = round(add_s, 2)
    report["dropped_postings"] = mut.dropped_postings

    # --- deletes: a slice of the streamed docs must vanish ---------------
    doomed = added[:stream // 4]
    mut.delete_docs(doomed)
    r = search(mut)
    ids = r.doc_ids.cpu().numpy()
    report["deletes"] = {
        "n_deleted": int(doomed.size),
        "tombstones_absent": not bool(np.isin(ids, doomed).any()),
        "R@100": metrics.recall_at_k(ids, corpus.qrels, 100),
        "search_us_per_batch": round(
            _time_call(lambda: search(mut), dev), 1),
    }

    # --- compaction: cost + equality with a from-scratch rebuild ---------
    t0 = time.perf_counter()
    compacted = mut.compact()
    _sync(dev)
    compact_s = time.perf_counter() - t0
    emb, tok = mut.surviving_corpus()
    rebuilt = hi.build(0, emb, tok, corpus.vocab_size, device=dev,
                       **build_kwargs)
    rc = search(compacted)
    rr = hi.search(rebuilt, qe, qt, kc=kc, k2=k2, top_r=top_r, device=dev)
    equal = (torch.equal(rc.doc_ids, rr.doc_ids)
             and torch.equal(rc.scores, rr.scores))
    # compaction renumbers survivors contiguously: map the qrels through
    # the old → new ids (a deleted positive becomes -2, never found)
    old_to_new = np.full(mut.n_docs, -2, np.int64)
    old_to_new[mut.survivors()] = np.arange(compacted.n_base)
    qrels_new = old_to_new[corpus.qrels]
    report["compaction"] = {
        "seconds": round(compact_s, 2),
        "equal_to_rebuild": bool(equal),
        "n_live": compacted.n_base,
        "R@100": metrics.recall_at_k(rc.doc_ids.cpu(), qrels_new, 100),
        "search_us_per_batch": round(
            _time_call(lambda: search(compacted), dev), 1),
    }
    return report


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small corpus (CI scale)")
    ap.add_argument("--codec", default=None,
                    help="codec spec (default: the registry default)")
    ap.add_argument("--top-r", type=int, default=100)
    ap.add_argument("--out", default=None,
                    help="also write the JSON report here")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero if a tombstoned doc surfaces or "
                         "compact() diverges from a from-scratch rebuild")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the hand-written kernels) or cpu "
                         "(their plain PyTorch versions)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    report = run(args)
    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    if args.check:
        failures = []
        if not report["deletes"]["tombstones_absent"]:
            failures.append("a tombstoned doc surfaced in the top-R")
        if not report["compaction"]["equal_to_rebuild"]:
            failures.append("compact() != from-scratch rebuild")
        if failures:
            sys.exit("; ".join(failures))


if __name__ == "__main__":
    main()

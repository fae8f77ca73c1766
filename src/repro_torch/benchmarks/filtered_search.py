"""Filtered-search benchmark: recall vs filter selectivity (DESIGN.md §9;
port of ``benchmarks/filtered_search.py``).

    python -m repro_torch.benchmarks.filtered_search --smoke --check \\
        --device cpu --out /tmp/BENCH_filtered.json               # CPU
    python -m repro_torch.benchmarks.filtered_search --check      # card

Partitions the corpus into N namespaces, then sweeps the per-query
filter from pass-everything down to a single namespace.  At each
selectivity point it reports:

  · recall@R against the *filtered* exact oracle (brute-force top-R
    restricted to each query's allowed namespaces) — the quality a
    tenant actually experiences;
  · mean surviving candidates (the paper's QL under filtering) next to
    the static candidate budget — the budget is selectivity-independent
    (the §2 fixed-shape contract: filtering masks slots, it never
    shrinks the compute), which is exactly what makes filtered latency
    flat;
  · tenant isolation (no returned doc outside the allowed set).

With ``--check`` it exits nonzero if isolation is violated or if the
pass-everything filter is not bit-identical to unfiltered search (the
filter stage must be a no-op at selectivity 1.0 — the §9 contract).
All quality fields are deterministic on one device; the
``search_us_per_batch`` fields are host-clock µs of synchronized calls.
:func:`build` makes the corpus, the namespaces and the index,
:func:`run_rows` sweeps a given index.  The report goes to stdout and,
with ``--out``, to that file only.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from repro_torch import device as dev_mod
from repro_torch.benchmarks import timing
from repro_torch.core import codecs, hybrid_index as hi, metrics
from repro_torch.core.codecs import flat
from repro_torch.core.exec import filters as ns_filters
from repro_torch.data import synthetic


def _time_call(fn, dev: torch.device) -> float:
    return timing.mean_us(fn, device=dev, warmup=2, iters=5)  # µs per call


def _filtered_oracle(qe, doc_emb, doc_ns, allowed_sets, top_r,
                     dev: torch.device) -> np.ndarray:
    """Exact top-R per query restricted to its allowed namespaces, via
    one brute-force pass per distinct namespace set (fixed shapes)."""
    out = np.full((qe.shape[0], top_r), -1, np.int64)
    ns = np.asarray(doc_ns)
    for key in sorted({tuple(s) for s in allowed_sets}):
        rows = [i for i, s in enumerate(allowed_sets) if tuple(s) == key]
        mask = np.isin(ns, list(key))
        sub = np.flatnonzero(mask)
        q = torch.from_numpy(np.asarray(qe)[rows]).to(dev)
        docs = torch.from_numpy(np.asarray(doc_emb)[sub]).to(dev)
        _, ids = flat.search(q, docs, k=min(top_r, sub.size))
        ids = ids.cpu().numpy()
        mapped = np.where(ids >= 0, sub[np.clip(ids, 0, None)], -1)
        out[rows, :mapped.shape[1]] = mapped
    return out


def scale(args) -> tuple:
    """(n_docs, n_queries, n_namespaces, build kwargs, vocab, hidden,
    topics)."""
    codec = args.codec or codecs.DEFAULT
    if args.smoke:
        return 4000, 64, 16, dict(n_clusters=64, k1_terms=8, codec=codec,
                                  pq_m=4, pq_k=64, cluster_capacity=192,
                                  term_capacity=96, kmeans_iters=5), \
            2048, 32, 32
    return 20_000, 256, 16, dict(n_clusters=256, k1_terms=12, codec=codec,
                                 pq_m=8, pq_k=256, cluster_capacity=256,
                                 term_capacity=128, kmeans_iters=10), \
        8192, 64, 128


def build(args) -> tuple:
    """(corpus, per-doc namespace ids, the filtered index on
    ``args.device``)."""
    dev = dev_mod.resolve(args.device)
    codecs.get(args.codec or codecs.DEFAULT)   # fail fast on typos
    n_docs, n_queries, n_ns, build_kwargs, vocab, hidden, topics = \
        scale(args)
    corpus = synthetic.generate(seed=0, n_docs=n_docs, n_queries=n_queries,
                                hidden=hidden, vocab_size=vocab,
                                n_topics=topics)
    rng = np.random.RandomState(0)
    doc_ns = rng.randint(0, n_ns, size=n_docs).astype(np.int32)
    index = hi.build(0, corpus.doc_emb, corpus.doc_tokens, corpus.vocab_size,
                     doc_namespaces=doc_ns, device=dev, **build_kwargs)
    return corpus, doc_ns, index


def run_rows(args, corpus, doc_ns, index) -> dict:
    """The report over ``index`` (built as :func:`build` does)."""
    dev = dev_mod.resolve(args.device)
    codec = args.codec or codecs.DEFAULT
    n_docs, n_queries = corpus.doc_emb.shape[0], corpus.query_emb.shape[0]
    n_ns = scale(args)[2]
    qe = torch.from_numpy(corpus.query_emb).to(dev)
    qt = torch.from_numpy(corpus.query_tokens).to(dev)
    kc, k2, top_r = 6, 8, args.top_r
    hist = ns_filters.namespace_histogram(doc_ns, n_ns)

    def search(flt=None):
        return hi.search(index, qe, qt, kc=kc, k2=k2, top_r=top_r,
                         filter=flt, device=dev)

    report = {
        "bench": "filtered",
        "smoke": bool(args.smoke),
        "codec": codec,
        "n_docs": n_docs,
        "n_queries": n_queries,
        "n_namespaces": n_ns,
        "namespace_docs_min": int(hist.min()),
        "namespace_docs_max": int(hist.max()),
        "top_r": top_r,
        "candidate_budget": hi.candidate_budget(index, kc, k2),
        "candidate_cost": hi.candidate_cost(index, kc, k2, top_r),
        "points": [],
    }
    failures = []

    # --- selectivity 1.0 sanity: all-namespaces filter == no filter ------
    ref = search()
    full = search(ns_filters.allow_all(n_queries, n_ns, device=dev))
    noop = (torch.equal(ref.doc_ids, full.doc_ids)
            and torch.equal(ref.scores, full.scores))
    report["allow_all_equals_unfiltered"] = bool(noop)
    if not noop:
        failures.append("pass-everything filter changed results")

    # --- selectivity sweep: k allowed namespaces per query ---------------
    for k_ns in (n_ns, n_ns // 2, n_ns // 4, 2, 1):
        # query b sees namespaces {b, b+1, ..., b+k-1} mod N — spread so
        # every namespace is exercised at every selectivity
        allowed = [[(b + j) % n_ns for j in range(k_ns)]
                   for b in range(n_queries)]
        bitmap = ns_filters.make_filter(allowed, n_ns, device=dev)
        res = search(bitmap)
        us = _time_call(lambda: search(bitmap), dev)
        ids = res.doc_ids.cpu().numpy()
        # tenant isolation: every returned doc inside the allowed set
        isolated = all(
            np.isin(doc_ns[row[row >= 0]], allowed[b]).all()
            for b, row in enumerate(ids))
        if not isolated:
            failures.append(f"isolation violated at k_ns={k_ns}")
        oracle = _filtered_oracle(corpus.query_emb, corpus.doc_emb, doc_ns,
                                  allowed, top_r, dev)
        # mean fraction of the corpus each query may see (≈ k/N for the
        # uniform assignment; exact from the namespace histogram)
        pass_frac = float(np.mean([hist[a].sum() for a in allowed])
                          / n_docs)
        report["points"].append({
            "allowed_namespaces": k_ns,
            "pass_rate": round(k_ns / n_ns, 4),
            "corpus_pass_fraction": round(pass_frac, 4),
            "R@R_vs_filtered_oracle": metrics.recall_at_k(
                res.doc_ids, oracle, top_r),
            "mean_candidates": float(res.n_candidates.cpu().float().mean()),
            "tenant_isolated": bool(isolated),
            "search_us_per_batch": round(us, 1),
        })

    report["check_failures"] = failures
    return report


def run(args) -> dict:
    return run_rows(args, *build(args))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized corpus")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero on isolation/no-op violations")
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
        sys.exit("filtered-search contract violated: "
                 + "; ".join(report["check_failures"]))


if __name__ == "__main__":
    main()

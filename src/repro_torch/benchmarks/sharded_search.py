"""Sharded-search benchmark: throughput against shard count beside the
single-device baseline (DESIGN.md §6; port of
``benchmarks/sharded_search.py``).

    python -m repro_torch.benchmarks.sharded_search --device cpu \\
        --devices 4 --out /tmp/sharded_search.json                # CPU
    python -m repro_torch.benchmarks.sharded_search --devices 4   # card

Builds the reference's index (its corpus, widths and codec) on
``--device`` and reports, under the reference's keys, the single-device
baseline and one entry per shard count in {2, 4, ..., --devices}: batch
µs and q/s (host clock around synchronized calls,
:func:`repro_torch.benchmarks.timing.mean_us`), whether the top-R ids
equal the baseline's, and shard 0's plane bytes (doc planes and list
entries).  ``--devices N`` is N mesh positions, every one on
``--device``: the reference's emulated devices on the CPU, and on the
card N positions sharing one card.  Each entry's ``positions_per_card``
says so, so ``speedup_vs_baseline`` is the cost of the split (the
merge, the worker threads and one launch per shard), not scaling.  The
report goes to stdout and, with ``--out``, to that file only; the exit
code is 1 unless every sharded entry's ids are identical.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from repro_torch import device as dev_mod
from repro_torch.benchmarks import timing
from repro_torch.core import codecs, hybrid_index as hi, sharded_index as shi
from repro_torch.data import synthetic


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=4,
                    help="mesh positions on --device (= max shard count)")
    ap.add_argument("--docs", type=int, default=20_000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--top-r", type=int, default=100)
    ap.add_argument("--codec", default=None,
                    help="codec spec to serve (default: the registry "
                         "default; any repro_torch.core.codecs name works)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the hand-written kernels) or cpu")
    ap.add_argument("--out", default=None, help="also write JSON here")
    return ap.parse_args(argv)


def _bytes(planes: dict) -> int:
    """Doc-plane plus list-entry bytes of one shard's (or the whole
    index's) planes, as the reference counts them."""
    doc = sum(x.nbytes for x in planes["doc_planes"].values())
    return (doc + planes["cluster_entries"].nbytes
            + planes["term_entries"].nbytes)


def run(args) -> dict:
    codec = args.codec or codecs.DEFAULT
    codecs.get(codec)   # fail fast (with the registered names) on typos
    if args.devices < 2:
        sys.exit(f"--devices {args.devices}: nothing to shard")
    dev = dev_mod.resolve(args.device)
    corpus = synthetic.generate(seed=0, n_docs=args.docs,
                                n_queries=args.queries, hidden=64,
                                vocab_size=8192, n_topics=128)
    index = hi.build(0, corpus.doc_emb, corpus.doc_tokens, corpus.vocab_size,
                     n_clusters=256, k1_terms=12, codec=codec, pq_m=8,
                     pq_k=256, cluster_capacity=256, term_capacity=128,
                     kmeans_iters=10, device=dev)
    qe = torch.from_numpy(corpus.query_emb).to(dev)
    qt = torch.from_numpy(corpus.query_tokens).to(dev).long()
    kc, k2, top_r = 6, 8, args.top_r

    def time_call(fn):
        return timing.mean_us(fn, device=dev, warmup=2, iters=5)

    us = time_call(lambda: hi.search(index, qe, qt, kc=kc, k2=k2,
                                     top_r=top_r, device=dev))
    ref = hi.search(index, qe, qt, kc=kc, k2=k2, top_r=top_r, device=dev)
    report = {
        "n_docs": args.docs,
        "n_queries": args.queries,
        "top_r": top_r,
        "codec": codec,
        "candidate_budget": hi.candidate_budget(index, kc, k2),
        "candidate_cost": hi.candidate_cost(index, kc, k2, top_r),
        "devices": args.devices,
        "baseline": {
            "us_per_batch": round(us, 1),
            "qps": round(args.queries / us * 1e6, 1),
            "doc_plane_bytes_per_device": _bytes(dict(
                doc_planes=index.doc_planes,
                cluster_entries=index.cluster_lists.entries,
                term_entries=index.term_lists.entries)),
        },
        "sharded": [],
    }
    n = 2
    while n <= args.devices:
        mesh = shi.make_shard_mesh(n, devices=[dev] * n)
        sidx = shi.device_put(shi.partition(index, n), mesh)
        us_n = time_call(lambda: shi.search(sidx, qe, qt, kc=kc, k2=k2,
                                            top_r=top_r, mesh=mesh))
        out = shi.search(sidx, qe, qt, kc=kc, k2=k2, top_r=top_r, mesh=mesh)
        report["sharded"].append({
            "shards": n,
            "us_per_batch": round(us_n, 1),
            "qps": round(args.queries / us_n * 1e6, 1),
            "speedup_vs_baseline": round(us / us_n, 3),
            # every position on one card (None: on the CPU)
            "positions_per_card": n if dev.type == "cuda" else None,
            "doc_ids_identical": bool(torch.equal(out.doc_ids, ref.doc_ids)),
            "doc_plane_bytes_per_device": _bytes(shi.shard_block(sidx, 0)),
        })
        mesh.close()
        n *= 2
    return report


def main(argv=None) -> None:
    args = parse_args(argv)
    report = run(args)
    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    if not all(e["doc_ids_identical"] for e in report["sharded"]):
        sys.exit(1)


if __name__ == "__main__":
    main()

"""Repeatability and cost of the index build on the card: the same
``hybrid_index.build`` run twice from one seed, with the build's float
segment sums (KMeans' centroid sums, the term selector's s̄) in the
port's fixed order and, for comparison, as float ``index_add_`` (the
atomics the sums used before they were ordered).

    python -m repro_torch.benchmarks.build_repeat [--docs 1048576] [--parts]
    python -m repro_torch.benchmarks.build_repeat --small

The corpus is ``chip_smoke.py`` phase 10's (``synthetic.generate`` at the
``serve_msmarco`` widths: h 768, L 10,000, V 30,528) and the build its
``opq`` build with the BM25 impact plane (K₁ᵀ 3, OPQ m 96 k 256,
capacities 1,024, 15 KMeans steps), KMeans included; ``--small`` takes
instead the on-card test's corpus and build (``tests/test_torch_cuda.py::
test_two_builds_on_the_card_are_equal_leaf_for_leaf``: 3,000 docs, h 64,
V 1,024, L 32, OPQ m 8, 4 KMeans steps).  The builds run in
the order ordered, atomic, ordered, atomic.  Prints, per build, its
stage seconds (``timings=``, synchronized) and, per sum order, whether
its two builds are equal leaf for leaf and which leaves differ, as one
JSON object.  ``--parts`` adds one more ordered build whose every
``segment_sum`` call is split into the steps of both its layouts (key
cast and stable sort, counts by ``searchsorted``; rows: ``index_select``
of the rows in sorted order, ``segment_reduce`` along the first axis;
columns, the layout of rows narrower than ``kmeans.NARROW``: a (w, n)
copy, a gather inside each column, ``segment_reduce`` along the last
axis, checked equal), each timed with CUDA events after a synchronize,
beside the row gather through int64 and complex128 views and as an
index expression, and float ``index_add_`` with its bincount, on the
same inputs; milliseconds summed per call site (its segment count and
row width).  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from repro_torch.benchmarks.synth_msmarco import (
    CLUSTER_CAP, HIDDEN, K1_TERMS, N_CLUSTERS, PQ_K, PQ_M, QUERY_LEN,
    TERM_CAP, VOCAB)
from repro_torch.core import hybrid_index as hi
from repro_torch.core import kmeans
from repro_torch.data import synthetic


def _atomic_segment_sum(values: torch.Tensor, segments: torch.Tensor,
                        n_segments: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sums as the build computed them before: float ``index_add_``
    (atomic adds on the card) and an integer bincount."""
    segments = segments.long()
    sums = torch.zeros((n_segments,) + tuple(values.shape[1:]),
                       dtype=torch.float32, device=values.device)
    sums.index_add_(0, segments, values.float())
    return sums, torch.bincount(segments, minlength=n_segments)


SUMS = {"ordered": kmeans.segment_sum, "atomic": _atomic_segment_sum}


def _timed_parts(parts: dict):
    """A ``segment_sum`` that computes what the port's does, step by
    step, adding each step's CUDA-event milliseconds to ``parts``."""
    def event_ms(fn):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def segment_sum(values, segments, n_segments):
        site = parts.setdefault(
            f"segments {n_segments}, width "
            f"{values[0].numel() if values.dim() > 1 else 1}",
            {"calls": 0, "rows": 0})
        site["calls"] += 1
        site["rows"] = max(site["rows"], int(values.shape[0]))
        steps = {}
        dtype = (torch.int16 if n_segments < torch.iinfo(torch.int16).max
                 else torch.int32)
        (key, order), steps["sort"] = event_ms(
            lambda: torch.sort(segments.to(dtype), stable=True))
        counts, steps["searchsorted"] = event_ms(
            lambda: torch.searchsorted(key, torch.arange(
                n_segments + 1, dtype=dtype, device=key.device)).diff())
        flat = values.reshape(values.shape[0], -1)
        rows, steps["index_select"] = event_ms(
            lambda: torch.index_select(flat, 0, order))
        for name, dtype in (("f32", None), ("i64", torch.int64),
                            ("c128", torch.complex128)):
            if dtype is None or (flat.shape[1] * 4) % dtype.itemsize == 0:
                _, steps[f"index_select_view_{name}"] = event_ms(
                    lambda: torch.index_select(
                        flat if dtype is None else flat.view(dtype), 0,
                        order))
        _, steps["index_expression"] = event_ms(lambda: flat[order])
        # the same sums column by column: a (w, n) copy, a gather inside
        # each column, segment_reduce along the last axis
        w = flat.shape[1]
        cols, steps["col_transpose"] = event_ms(
            lambda: flat.T.contiguous())
        cols, steps["col_gather"] = event_ms(
            lambda: torch.gather(cols, 1, order.expand(w, -1)))
        col_sums, steps["col_segment_reduce"] = event_ms(
            lambda: torch.segment_reduce(
                cols, "sum", lengths=counts.expand(w, -1).contiguous(),
                axis=1))
        sums, steps["segment_reduce"] = event_ms(
            lambda: torch.segment_reduce(rows, "sum", lengths=counts,
                                         axis=0))
        _, steps["index_add_"] = event_ms(
            lambda: _atomic_segment_sum(values, segments, n_segments))
        for k, v in steps.items():
            site[k + "_ms"] = site.get(k + "_ms", 0.0) + v
        site["columns_equal_rows"] = site.get("columns_equal_rows", True) and (
            torch.equal(col_sums.T, sums))
        return (sums.reshape((n_segments,) + tuple(values.shape[1:])),
                counts)

    return segment_sum


def differing_leaves(a, b) -> list:
    """Paths of the leaves two indexes do not share bit for bit."""
    return [p for (p, x), (_, y) in zip(hi.index_leaves(a),
                                        hi.index_leaves(b))
            if x.dtype != y.dtype or not torch.equal(x, y)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=1_048_576)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--small", action="store_true",
                    help="the on-card test's corpus and build instead")
    ap.add_argument("--parts", action="store_true",
                    help="also time the steps of every segment_sum call "
                         "of one more build")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("build_repeat needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    if args.small:
        corpus = synthetic.generate(seed=1, n_docs=3000, n_queries=8,
                                    hidden=64, vocab_size=1024)
        kw = dict(n_clusters=32, k1_terms=4, pq_m=8, cluster_capacity=256,
                  term_capacity=64, kmeans_iters=4)
    else:
        corpus = synthetic.generate(args.seed, n_docs=args.docs,
                                    n_queries=8, hidden=HIDDEN,
                                    vocab_size=VOCAB, query_len=QUERY_LEN,
                                    make_model_b=False)
        kw = dict(n_clusters=N_CLUSTERS, k1_terms=K1_TERMS, pq_m=PQ_M,
                  pq_k=PQ_K, cluster_capacity=CLUSTER_CAP,
                  term_capacity=TERM_CAP, kmeans_iters=15)
    emb = torch.from_numpy(corpus.doc_emb).to(dev)
    tokens = torch.from_numpy(corpus.doc_tokens).to(dev).long()
    vocab = corpus.vocab_size
    del corpus

    def build(timings: dict):
        index = hi.build(args.seed, emb, tokens, vocab, codec="opq",
                         sparse=True, device=dev, timings=timings, **kw)
        torch.cuda.synchronize()
        return index.to("cpu")

    runs = {mode: [] for mode in SUMS}
    for mode in ("ordered", "atomic", "ordered", "atomic"):
        kmeans.segment_sum = SUMS[mode]
        timings = {}
        runs[mode].append((build(timings), timings))
        print(f"[build_repeat] {mode}: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in timings.items()), flush=True)
    report = {"card": smi, "docs": int(emb.shape[0]), "seed": args.seed}
    if args.parts:
        parts: dict = {}
        kmeans.segment_sum = _timed_parts(parts)
        if differing_leaves(build({}), runs["ordered"][0][0]):
            raise SystemExit("the timed steps built another index")
        report["parts"] = parts
    kmeans.segment_sum = SUMS["ordered"]
    for mode, ((a, ta), (b, tb)) in runs.items():
        diff = differing_leaves(a, b)
        report[mode] = {"stage_seconds": [ta, tb],
                        "equal_leaf_for_leaf": not diff,
                        "differing_leaves": diff,
                        "n_leaves": len(hi.index_leaves(a))}
    print(json.dumps(report, sort_keys=True), flush=True)


if __name__ == "__main__":
    main()

"""Serving-load benchmark (port of ``benchmarks/serving_load.py``;
DESIGN.md §10): the micro-batching runtime under one-request-at-a-time
traffic, on every serving layout.

    python -m repro_torch.benchmarks.serving_load --smoke --check \\
        --device cpu                                     # CPU, plain path
    python -m repro_torch.benchmarks.serving_load --check --out F.json

Builds a namespaced index over the synthetic corpus on ``--device``
(default ``cuda``) for each layout (``plain``: ``Server``; ``sharded``:
``ShardedServer`` over ``--shards`` mesh positions; ``mutable``:
``MutableServer`` over the same corpus with an empty delta;
``sharded_mutable``: ``ShardedMutableServer``; every mesh position on
``--device``, so on the card they share it) and reports, under the
reference's keys:

  · the warmup ledger (exactly one program per bucket, none built by
    serving afterwards: on the card, one CUDA graph capture each, over
    a mesh one graph across its positions' streams);
  · bit-identity of runtime rows against direct ``Server.query`` rows,
    unfiltered and under per-query namespace filters;
  · ``qps_serial`` (one synchronous ``Server.query`` per request, padded
    to ``max_batch``, its rows copied to the host) against
    ``qps_runtime`` (the same requests through ``submit``, coalesced
    into buckets);
  · open-loop Poisson arrivals at a quarter of the measured burst rate:
    sustained throughput and p50/p95/p99 latency;
  · the LRU cache replay: every repeat hits, bit-identical rows.

``--check`` exits non-zero unless the rows are bit-identical, each
bucket built once and none after warmup, the runtime is at least 2× the
serial rate and the cache replays every query.  Times are host clocks
(the ends of a request are the host's).  The report goes to stdout and,
with ``--out``, to that file only.  The reference runs each layout in a
subprocess (device emulation, a cold jit cache); the port's program
ledger is counted per runtime, so every layout runs in this process.
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
from repro_torch.core import hybrid_index as hi
from repro_torch.core import segments as seg
from repro_torch.data import synthetic
from repro_torch.launch import runtime as rt_mod
from repro_torch.launch import serve

LAYOUTS = ("plain", "sharded", "mutable", "sharded_mutable")
N_NAMESPACES = 8


def _build_server(layout: str, args, dev: torch.device):
    corpus = synthetic.generate(seed=0, n_docs=args.docs,
                                n_queries=args.queries,
                                hidden=args.hidden, vocab_size=args.vocab,
                                n_topics=32)
    build_kwargs = dict(n_clusters=args.clusters, k1_terms=8,
                        codec=args.codec, pq_m=4, pq_k=64,
                        cluster_capacity=192, term_capacity=96,
                        kmeans_iters=5)
    sharded = layout in ("sharded", "sharded_mutable")
    n = args.shards if sharded else 1
    cfg = serve.ServeConfig(max_batch=args.max_batch, n_shards=n,
                            mutable=layout in ("mutable", "sharded_mutable"),
                            delta_capacity=256, n_namespaces=N_NAMESPACES)
    doc_ns = np.arange(args.docs) % N_NAMESPACES
    if cfg.mutable:
        mut = seg.MutableHybridIndex.create(
            0, corpus.doc_emb, corpus.doc_tokens, corpus.vocab_size,
            delta_capacity=256, doc_namespaces=doc_ns, device=dev,
            **build_kwargs)
        server = (serve.ShardedMutableServer(mut, cfg, devices=[dev] * n)
                  if sharded else serve.make_mutable_server(mut, cfg,
                                                            device=dev))
    else:
        index = hi.build(0, corpus.doc_emb, corpus.doc_tokens,
                         corpus.vocab_size, doc_namespaces=doc_ns,
                         device=dev, **build_kwargs)
        server = (serve.ShardedServer(index, cfg, devices=[dev] * n)
                  if sharded else serve.make_server(index, cfg, device=dev))
    return corpus, server


def _host(res) -> tuple:
    """A result's three planes as host numpy arrays."""
    return tuple(np.asarray(torch.as_tensor(x).cpu())
                 for x in (res.doc_ids, res.scores, res.n_candidates))


def _equal(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(_host(a), _host(b)))


def _percentiles(lat_s: list) -> dict:
    ms = np.asarray(lat_s) * 1e3
    return {"p50_ms": round(float(np.percentile(ms, 50)), 2),
            "p95_ms": round(float(np.percentile(ms, 95)), 2),
            "p99_ms": round(float(np.percentile(ms, 99)), 2)}


def poisson(rt, req: list, rate: float, seed: int = 0) -> dict:
    """Open-loop Poisson arrivals at ``rate`` requests/s through ``rt``:
    sustained rate and latency percentiles (arrival to resolution)."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=len(req)))
    done_at = [None] * len(req)

    def _mark(i):
        def cb(_):
            done_at[i] = time.perf_counter()
        return cb

    futures = []
    t0 = time.perf_counter()
    for i, (e, t) in enumerate(req):
        lead = t0 + arrivals[i] - time.perf_counter()
        if lead > 0:
            time.sleep(lead)
        f = rt.submit(e, t)
        f.add_done_callback(_mark(i))
        futures.append(f)
    for f in futures:
        f.result(timeout=600)
    span = max(done_at) - t0
    latencies = [done_at[i] - (t0 + arrivals[i]) for i in range(len(req))]
    return {"qps_offered": round(rate, 1),
            "qps_sustained": round(len(req) / span, 1),
            **_percentiles(latencies)}


def run_layout(layout: str, args) -> dict:
    dev = dev_mod.resolve(args.device)
    corpus, server = _build_server(layout, args, dev)
    qe, qt = corpus.query_emb, corpus.query_tokens
    n_req = args.requests
    # request stream: cycle the distinct query pool
    req = [(qe[i % qe.shape[0]], qt[i % qt.shape[0]]) for i in range(n_req)]

    rt = rt_mod.ServingRuntime(
        server, rt_mod.RuntimeConfig(linger_ms=args.linger_ms,
                                     queue_depth=max(n_req, 64),
                                     cache_size=0))
    rt.warmup(args.hidden, qt.shape[1])

    # --- bit-identity: runtime rows == direct Server.query rows ---------
    b = min(args.max_batch, qe.shape[0])
    direct = server.query(qe[:b], qt[:b])
    bit_identical = _equal(direct, rt.query(qe[:b], qt[:b], timeout=600))
    want = [i % N_NAMESPACES for i in range(b)]
    direct_f = server.query(qe[:b], qt[:b], namespaces=want)
    bit_identical_filtered = _equal(
        direct_f, rt.query(qe[:b], qt[:b], namespaces=want, timeout=600))

    # --- serial baseline: one synchronous Server.query per request ------
    t0 = time.perf_counter()
    for e, t in req:
        _host(server.query(e[None], t[None]))
    qps_serial = n_req / (time.perf_counter() - t0)

    # --- burst through the runtime: micro-batching capacity -------------
    t0 = time.perf_counter()
    futures = [rt.submit(e, t) for e, t in req]
    for f in futures:
        f.result(timeout=600)
    qps_runtime = n_req / (time.perf_counter() - t0)

    # --- open-loop Poisson at a quarter of the burst rate: sparse
    # arrivals ride small buckets, and 1/4 keeps the queue stable so the
    # percentiles measure service + linger, not a backlog ---------------
    pois = poisson(rt, req, max(qps_runtime / 4.0, 1.0))
    rt.close(drain=True)
    stats = rt.stats()

    # --- LRU cache replay: second pass all hits, bit-identical ----------
    cached = rt_mod.ServingRuntime(
        server, rt_mod.RuntimeConfig(linger_ms=args.linger_ms,
                                     queue_depth=max(n_req, 64),
                                     cache_size=2 * b))
    cached.warmup(args.hidden, qt.shape[1])
    first = cached.query(qe[:b], qt[:b], timeout=600)
    again = cached.query(qe[:b], qt[:b], timeout=600)
    cached.close(drain=True)
    cstats = cached.stats()["cache"]
    if getattr(server, "mesh", None) is not None:
        server.mesh.close()
    return {
        "layout": layout,
        "shards": server.cfg.n_shards,
        "mutable": server.cfg.mutable,
        "n_requests": n_req,
        "buckets": stats["buckets"],
        "warm_compiles": {str(k): v for k, v in
                          sorted(stats["warm_traces"].items())},
        "post_warmup_compiles": stats["post_warmup_traces"],
        "bit_identical": bool(bit_identical),
        "bit_identical_filtered": bool(bit_identical_filtered),
        "qps_serial": round(qps_serial, 1),
        "qps_runtime": round(qps_runtime, 1),
        "poisson": pois,
        "cache": {"queries": b, "hits": cstats["hits"],
                  "bit_identical": (_equal(first, again)
                                    and _equal(direct, again))},
    }


def check_layout(rep: dict) -> list:
    """The reference's ``--check`` contract for one layout's report."""
    fails = []
    name = rep["layout"]
    if not rep["bit_identical"]:
        fails.append(f"{name}: runtime results != direct Server.query")
    if not rep["bit_identical_filtered"]:
        fails.append(f"{name}: filtered runtime results != direct")
    bad = {b: n for b, n in rep["warm_compiles"].items() if n != 1}
    if bad:
        fails.append(f"{name}: warmup programs per bucket != 1: {bad}")
    if rep["post_warmup_compiles"]:
        fails.append(f"{name}: {rep['post_warmup_compiles']} programs "
                     "built by serving after warmup")
    speedup = rep["qps_runtime"] / rep["qps_serial"]
    if speedup < 2.0:
        fails.append(f"{name}: micro-batched throughput only "
                     f"{speedup:.2f}x the serial baseline (< 2x)")
    if rep["cache"]["hits"] != rep["cache"]["queries"]:
        fails.append(f"{name}: cache replay hit {rep['cache']['hits']}"
                     f"/{rep['cache']['queries']}")
    if not rep["cache"]["bit_identical"]:
        fails.append(f"{name}: cached rows != uncached rows")
    return fails


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small corpus (CI scale)")
    ap.add_argument("--layout", default=None, choices=LAYOUTS,
                    help="run ONE layout (default: all four)")
    ap.add_argument("--codec", default="pq")
    ap.add_argument("--shards", type=int, default=2,
                    help="mesh positions of the sharded layouts, all on "
                         "--device")
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--linger-ms", type=float, default=2.0)
    ap.add_argument("--out", default=None, help="write the report here")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero unless results are bit-identical "
                         "to direct serving, each bucket built once, and "
                         "micro-batching is >= 2x the serial baseline")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: one CUDA graph per bucket) or cpu")
    args = ap.parse_args(argv)
    if args.smoke:
        args.docs, args.queries = 4000, 128
        args.hidden, args.vocab, args.clusters = 32, 2048, 64
        args.max_batch = args.max_batch or 32
        args.requests = args.requests or 192
    else:
        args.docs, args.queries = 20_000, 512
        args.hidden, args.vocab, args.clusters = 64, 8192, 256
        args.max_batch = args.max_batch or 64
        args.requests = args.requests or 1024
    return args


def run(args) -> dict:
    """The report of ``args.layout``, or of every layout by default."""
    if args.layout:
        return run_layout(args.layout, args)
    return {
        "bench": "serving",
        "smoke": bool(args.smoke),
        "codec": args.codec,
        "n_docs": args.docs,
        "max_batch": args.max_batch,
        "n_requests": args.requests,
        "linger_ms": args.linger_ms,
        "n_namespaces": N_NAMESPACES,
        "device": str(dev_mod.resolve(args.device)),
        "layouts": {name: run_layout(name, args) for name in LAYOUTS},
    }


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
        reps = ([report] if args.layout
                else [report["layouts"][n] for n in LAYOUTS])
        failures = [msg for rep in reps for msg in check_layout(rep)]
        if failures:
            sys.exit("; ".join(failures))


if __name__ == "__main__":
    main()

"""2-D mesh serving benchmark (port of ``benchmarks/mesh_serving.py``;
DESIGN.md §12): query throughput across (data, model) serving-mesh
geometries, the serving runtime over each mesh, and the shard-loss
drill, under the reference's report keys.

    python -m repro_torch.benchmarks.mesh_serving --smoke --check \\
        --device cpu                                     # CPU, plain path
    python -m repro_torch.benchmarks.mesh_serving --check --out F.json

Builds the reference's index (its corpus, widths and ``sq8`` codec) on
``--device`` (default ``cuda``) once, and serves it on each geometry of
:data:`GEOMETRIES` with every mesh position on ``--device``: the
reference's emulated devices on the CPU, and on the card d·m positions
sharing one card (each entry's ``positions_per_card`` says so).  Per
geometry it reports:

  · wall time per full query batch through the layout's server (host
    clock, rows copied to the host; every geometry's server is built
    first and the reps take the geometries in turns, so a drift in the
    machine's load falls on all of them alike), and a fingerprint of a
    fixed probe batch's doc ids, which must be identical across every
    geometry (the data axis splits queries, the model axis merges to the
    §6 order);
  · ``qps_emulated = qps_wall · data``, the reference's proxy for
    data-axis scaling on emulated devices, with its ≥ 1.6× gate on
    (2, 1) against (1, 1) (``--check``).  On the CPU each mesh position
    is an emulated device of one core: the run holds torch to one
    intra-op thread, so a (d, m) mesh computes on d·m cores and the
    (1, 1) baseline on one.  On one card the slices' streams share the
    card, so there the proxy measures what overlapping them buys, which
    the reference's premise does not cover: ``--check`` applies the
    gate to emulated devices only and, on a card, prints its reading;
  · the serving runtime over the mesh: one program per bucket per mesh
    (not per replica; on a card whose positions share it, one CUDA
    graph captured across their streams, ``captured``), burst and
    open-loop Poisson latency percentiles, and round-robin dispatch
    reaching every data-axis replica;
  · the shard-loss drill at (2, 2): checkpoint, eject one model-axis
    shard, results served from the survivors' ranges flagged
    ``partial=True`` (also through a runtime), rejoin from the
    checkpoint bit-identical to the results before the failure.

The reference runs each geometry in a subprocess (device emulation
before the jax import, a cold jit cache); the port's mesh positions are
threads and its program ledger is counted per runtime, so every
geometry runs in this process.  The report goes to stdout and, with
``--out``, to that file only (the drill's checkpoint goes to a
temporary directory that is removed).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch import device as dev_mod
from repro_torch.benchmarks import serving_load
from repro_torch.core import hybrid_index as hi
from repro_torch.data import synthetic
from repro_torch.launch import runtime as rt_mod
from repro_torch.launch import serve

#: (data, model) sweep: data-axis scaling, model-axis scaling, and the
#: full 2-D product
GEOMETRIES = ((1, 1), (2, 1), (4, 1), (1, 2), (2, 2))
DRILL_GEOMETRY = (2, 2)
N_DEVICES = 4


def _gname(d: int, m: int) -> str:
    return f"{d}x{m}"


def build(args, dev: torch.device):
    """The reference's corpus and index on ``dev``."""
    corpus = synthetic.generate(seed=0, n_docs=args.docs,
                                n_queries=args.queries, hidden=args.hidden,
                                vocab_size=args.vocab, n_topics=32)
    index = hi.build(0, corpus.doc_emb, corpus.doc_tokens, corpus.vocab_size,
                     n_clusters=args.clusters, k1_terms=8, codec=args.codec,
                     pq_m=4, pq_k=64, cluster_capacity=192, term_capacity=96,
                     kmeans_iters=5, device=dev)
    return corpus, index


def make_layout(index, d: int, m: int, max_batch: int, dev: torch.device):
    """The reference's ``make_server`` layout for (d, m), its d·m mesh
    positions on ``dev``."""
    cfg = serve.ServeConfig(max_batch=max_batch, n_shards=m,
                            data_parallel=d)
    if d > 1:
        return serve.MeshServer(index, cfg, devices=[dev] * (d * m))
    if m > 1:
        return serve.ShardedServer(index, cfg, devices=[dev] * m)
    return serve.Server(index, cfg, device=dev)


def _ids(res) -> np.ndarray:
    return np.asarray(torch.as_tensor(res.doc_ids).cpu())


def _fingerprint(res) -> str:
    return hashlib.sha256(_ids(res).tobytes()).hexdigest()


def _close(server) -> None:
    if getattr(server, "mesh", None) is not None:
        server.mesh.close()


def batch_walls(args, servers: dict, corpus) -> dict:
    """Mean host-clock seconds of a full batch through each server (rows
    to the host), over ``args.reps`` rounds that take the servers in
    turns."""
    b = args.max_batch
    qe, qt = corpus.query_emb[:b], corpus.query_tokens[:b]
    total = dict.fromkeys(servers, 0.0)
    for _ in range(args.reps):
        for g, server in servers.items():
            t0 = time.perf_counter()
            _ids(server.query(qe, qt))
            total[g] += time.perf_counter() - t0
    return {g: t / args.reps for g, t in total.items()}


def run_geometry(args, d: int, m: int, corpus, server, wall: float) -> dict:
    """One geometry's report: ``server`` (warmed) and its batch ``wall``
    seconds from :func:`batch_walls`; closes the server's mesh."""
    dev = dev_mod.resolve(args.device)
    b = args.max_batch
    qe, qt = corpus.query_emb[:b], corpus.query_tokens[:b]
    probe = server.query(qe, qt)
    qps_wall = b / wall

    # --- serving runtime over the mesh -----------------------------------
    n_req = args.requests
    req = [(corpus.query_emb[i % corpus.query_emb.shape[0]],
            corpus.query_tokens[i % corpus.query_tokens.shape[0]])
           for i in range(n_req)]
    rt = rt_mod.ServingRuntime(
        server, rt_mod.RuntimeConfig(linger_ms=args.linger_ms,
                                     queue_depth=max(n_req, 64),
                                     cache_size=0))
    rt.warmup(args.hidden, qt.shape[1])
    via_rt = rt.query(qe, qt, timeout=600)
    runtime_bit_identical = np.array_equal(_ids(probe), _ids(via_rt))

    t0 = time.perf_counter()
    for f in [rt.submit(e, t) for e, t in req]:
        f.result(timeout=600)
    qps_runtime = n_req / (time.perf_counter() - t0)
    pois = serving_load.poisson(rt, req, max(qps_runtime / 4.0, 1.0))
    rt.close(drain=True)
    stats = rt.stats()
    _close(server)
    return {
        "data": d,
        "model": m,
        # every position on --device: d·m share one card (None: the CPU)
        "positions_per_card": d * m if dev.type == "cuda" else None,
        "buckets": stats["buckets"],
        "warm_compiles": {str(k): v for k, v in
                          sorted(stats["warm_traces"].items())},
        "post_warmup_compiles": stats["post_warmup_traces"],
        "captured": all(stats["captured"].values()),
        # compared across geometries by the caller, then dropped
        "_fingerprint": _fingerprint(probe),
        "runtime_bit_identical": bool(runtime_bit_identical),
        "dispatch_all_replicas": bool(
            all(n > 0 for n in stats["replica_dispatch"].values())),
        "us_per_batch": round(wall * 1e6, 1),
        "qps_wall": round(qps_wall, 1),
        "qps_emulated": round(qps_wall * d, 1),
        "qps_runtime": round(qps_runtime, 1),
        "poisson": pois,
    }


def run_drill(args, built) -> dict:
    """Shard-loss drill at (2, 2): checkpoint → eject → degraded but
    served (``partial=True``, survivors only, through a runtime too) →
    rejoin → bit-identical."""
    dev = dev_mod.resolve(args.device)
    corpus, index = built
    d, m = DRILL_GEOMETRY
    server = make_layout(index, d, m, args.max_batch, dev)
    b = args.max_batch
    qe, qt = corpus.query_emb[:b], corpus.query_tokens[:b]
    server.warmup(args.hidden, qt.shape[1])
    full = server.query(qe, qt)
    epoch0 = server.epoch

    with tempfile.TemporaryDirectory() as td:
        path = server.checkpoint(td)
        server.eject_shard(1)
        degraded = server.query(qe, qt)
        ids = _ids(degraded)
        live = ids[ids >= 0]
        excluded = all(not ((live >= lo) & (live < hi_)).any()
                       for lo, hi_ in server.lost_doc_ranges())

        # the runtime keeps serving the degraded mesh and must carry the
        # partial flag through to every client row
        rt = rt_mod.ServingRuntime(server, rt_mod.RuntimeConfig(
            linger_ms=args.linger_ms, queue_depth=64, cache_size=0))
        rt.warmup(args.hidden, qt.shape[1])
        via_rt = rt.query(qe, qt, timeout=600)
        rt.close(drain=True)

        server.rejoin(path)
        restored = server.query(qe, qt)
    _close(server)
    return {
        "data": d,
        "model": m,
        "ejected_shard": 1,
        "partial_flagged": bool(degraded.partial),
        "runtime_partial_flagged": bool(via_rt.partial),
        "lost_range_excluded": bool(excluded),
        "degraded_differs": _fingerprint(degraded) != _fingerprint(full),
        "restored_not_partial": not bool(restored.partial),
        "rejoin_bit_identical": _fingerprint(restored) == _fingerprint(full),
        "epoch_bumps": int(server.epoch - epoch0),
    }


def check_serving(report: dict) -> list:
    """The reference's ``--check`` result contracts: ids identical across
    geometries, at most one program per bucket and none while serving,
    runtime rows equal to direct ones, every replica dispatched, and the
    drill's partial-result contract."""
    fails = []
    geos = report["geometries"]
    if not report["doc_ids_identical_across_geometries"]:
        fails.append("doc_ids differ across geometries")
    for g, r in geos.items():
        bad = {b: n for b, n in r["warm_compiles"].items() if n > 1}
        if bad:
            fails.append(f"{g}: warmup programs per bucket > 1: {bad}")
        if r["post_warmup_compiles"]:
            fails.append(f"{g}: {r['post_warmup_compiles']} programs "
                         "built by serving after warmup")
        if not r["runtime_bit_identical"]:
            fails.append(f"{g}: runtime rows != direct Server.query")
        if not r["dispatch_all_replicas"]:
            fails.append(f"{g}: some data-axis replica never dispatched")
    drill = report["failover"]
    for key in ("partial_flagged", "runtime_partial_flagged",
                "lost_range_excluded", "degraded_differs",
                "restored_not_partial", "rejoin_bit_identical"):
        if not drill[key]:
            fails.append(f"failover drill: {key} is False")
    return fails


def check_scaling(report: dict) -> list:
    """The reference's emulated data-axis scaling gate."""
    speedup = report["speedup_emulated_2x1"]
    if speedup < 1.6:
        return [f"emulated (2,1) throughput only {speedup:.2f}x the (1,1) "
                "baseline (< 1.6x)"]
    return []


def emulated(report: dict) -> bool:
    """Whether the mesh positions were emulated devices, one processor
    each (the CPU run), the premise of :func:`check_scaling`; on a card
    they share it (``positions_per_card``)."""
    return report["geometries"][_gname(2, 1)]["positions_per_card"] is None


def check(report: dict) -> list:
    """Every contract of the reference's ``--check``: the result
    contracts, and the emulated scaling gate where its premise holds."""
    fails = check_serving(report)
    return fails + check_scaling(report) if emulated(report) else fails


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small corpus (CI scale)")
    ap.add_argument("--codec", default="sq8")
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--reps", type=int, default=None)
    ap.add_argument("--linger-ms", type=float, default=2.0)
    ap.add_argument("--out", default=None, help="write the report here")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero unless doc_ids are bit-identical "
                         "across geometries, emulated (2,1) QPS is >= "
                         "1.6x the (1,1) baseline (emulated devices "
                         "only), and the shard-loss "
                         "drill upholds the partial-result contract")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: every position on the card, one "
                         "CUDA graph per bucket per mesh) or cpu")
    args = ap.parse_args(argv)
    if args.smoke:
        args.docs, args.queries = 4000, 64
        args.hidden, args.vocab, args.clusters = 32, 2048, 64
        args.max_batch = args.max_batch or 32
        args.requests = args.requests or 96
        args.reps = args.reps or 10
    else:
        args.docs, args.queries = 20_000, 128
        args.hidden, args.vocab, args.clusters = 64, 8192, 256
        args.max_batch = args.max_batch or 64
        args.requests = args.requests or 512
        args.reps = args.reps or 20
    return args


def run(args) -> dict:
    dev = dev_mod.resolve(args.device)
    threads = torch.get_num_threads()
    if dev.type == "cpu":
        torch.set_num_threads(1)      # one core per emulated device
    try:
        return _run(args, dev)
    finally:
        torch.set_num_threads(threads)


def _run(args, dev: torch.device) -> dict:
    built = build(args, dev)
    corpus, index = built
    servers = {(d, m): make_layout(index, d, m, args.max_batch, dev)
               for d, m in GEOMETRIES}
    for server in servers.values():
        server.warmup(args.hidden, corpus.query_tokens.shape[1])
    walls = batch_walls(args, servers, corpus)
    geos = {_gname(d, m): run_geometry(args, d, m, corpus, servers[d, m],
                                       walls[d, m])
            for d, m in GEOMETRIES}
    fps = {g: r.pop("_fingerprint") for g, r in geos.items()}
    base = geos[_gname(1, 1)]["qps_wall"]
    dp2 = geos[_gname(2, 1)]["qps_emulated"]
    return {
        "bench": "mesh_serving",
        "smoke": bool(args.smoke),
        "codec": args.codec,
        "n_docs": args.docs,
        "max_batch": args.max_batch,
        "n_requests": args.requests,
        "n_devices": N_DEVICES,
        "device": str(dev),
        "geometries": geos,
        "doc_ids_identical_across_geometries": len(set(fps.values())) == 1,
        # the reference's proxy, computed as it does (module docstring)
        "speedup_emulated_2x1": round(dp2 / base, 2),
        "failover": run_drill(args, built),
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
        if not emulated(report):
            print(f"mesh_serving: speedup_emulated_2x1 "
                  f"{report['speedup_emulated_2x1']}; the emulated (2,1) "
                  f"gate is not applied, every position shares "
                  f"{report['device']}", file=sys.stderr)
        failures = check(report)
        if failures:
            sys.exit("; ".join(failures))


if __name__ == "__main__":
    main()

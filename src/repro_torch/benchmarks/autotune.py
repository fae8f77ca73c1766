"""Width-autotuning benchmark (port of ``benchmarks/autotune.py``;
DESIGN.md §14): the offline tuner's frontier selection, the
tuned-vs-default cost win, and the adaptive rung ladder's serving
contracts, under the reference's report keys.

    python -m repro_torch.benchmarks.autotune --smoke --check \\
        --device cpu                                     # CPU, plain path
    python -m repro_torch.benchmarks.autotune --check --out F.json

Three stages, each over the one deterministic corpus and index
(``refine:pq:4``) built on ``--device`` (default ``cuda``):

  · **tune**: ``repro_torch.launch.tune.tune_index`` over the shared
    grid against the exact top-10 oracle, and three operating points on
    the held-out queries — the hand-picked default
    (``serve.DEFAULT_KC/K2``), the tuned-static selection, and the
    adaptive ladder (per-query rung by dispatch margin, cost averaged
    over the resolved rungs).
  · **variants**: with adaptivity off and explicit widths, every
    serving layout (``plain``: ``Server``; ``sharded``: ``ShardedServer``
    on two mesh positions; ``mutable``: ``MutableServer``;
    ``sharded_mutable``: ``ShardedMutableServer`` on two positions; the
    positions on ``--device``) returns rows bit-identical to the direct
    search at those widths, and a default-config server returns the
    same rows.
  · **runtime**: adaptive serving through the micro-batching runtime —
    warmup builds exactly one program per (batch-bucket, width-rung)
    (on the card one captured CUDA graph each), serving builds none,
    every row is bit-identical to the direct search at its resolved
    rung's widths, a replay pass hits the cache on every repeat, and
    the cache key separates the rungs.

The reference runs the last two stages in subprocesses (emulated
devices, a cold jit cache); the port's program ledger is counted per
runtime, so all three run in one process.  ``--stage`` runs one of the
last two alone, as the reference's does.

``--check`` exits non-zero unless the §14 contracts hold: (a)
tuned-static meets the recall target at strictly lower candidate cost
than the default, (b) the adaptive ladder's mean per-query cost is <=
tuned-static at equal-or-better recall, (c) explicit-width bit-identity
on every layout, (d) one program per (bucket, rung) and none
built while serving, (e) no cross-rung cache replay.  Every report
field is deterministic (no wall clock).  The report goes to stdout and,
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

LAYOUTS = ("plain", "sharded", "mutable", "sharded_mutable")
CODEC = "refine:pq:4"
REFINE_MULTS = (2, 4, 8)

#: oracle width: the tune scores recall@top_r of the exact top-10
#: neighbors (the standard ANN ground-truth framing)
ORACLE_WIDTH = 10

#: the tuner's recall@R target as a fraction of the DEFAULT config's
#: measured recall
TARGET_FRAC = 0.96


def _scale(args) -> None:
    # the reference's geometry: few large clusters and tight topics put
    # the default (6, 8) past the knee of the recall curve
    if args.smoke:
        args.docs, args.queries = 4000, 256
        args.hidden, args.vocab, args.clusters = 32, 2048, 16
        args.pq_m, args.pq_k, args.kmeans_iters = 4, 64, 5
        args.max_batch = args.max_batch or 32
    else:
        args.docs, args.queries = 8000, 384
        args.hidden, args.vocab, args.clusters = 64, 4096, 32
        args.pq_m, args.pq_k, args.kmeans_iters = 8, 256, 8
        args.max_batch = args.max_batch or 64


def _build_kwargs(args) -> dict:
    return dict(n_clusters=args.clusters, k1_terms=8, codec=CODEC,
                pq_m=args.pq_m, pq_k=args.pq_k, cluster_capacity=512,
                term_capacity=96, kmeans_iters=args.kmeans_iters)


def _corpus(args):
    from repro_torch.data import synthetic
    return synthetic.generate(seed=0, n_docs=args.docs,
                              n_queries=args.queries, hidden=args.hidden,
                              vocab_size=args.vocab, n_topics=args.clusters,
                              sigma_doc=0.18)


def _build(args, dev):
    """The one deterministic corpus + index every stage builds (same
    seed and params → the same planes, so the tuned record of the tune
    stage applies to the runtime stage's index)."""
    from repro_torch.core import hybrid_index as hi
    corpus = _corpus(args)
    index = hi.build(0, corpus.doc_emb, corpus.doc_tokens, corpus.vocab_size,
                     device=dev, **_build_kwargs(args))
    return corpus, index


def _host(res) -> tuple:
    return tuple(np.asarray(torch.as_tensor(x).cpu())
                 for x in (res.doc_ids, res.scores, res.n_candidates))


def _equal(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(_host(a), _host(b)))


# --------------------------------------------------------------------------
# stage: tune
# --------------------------------------------------------------------------

def run_tune(args, built=None) -> tuple:
    from repro_torch.core import hybrid_index as hi
    from repro_torch.core.exec import frontier
    from repro_torch.launch import serve, tune

    dev = dev_mod.resolve(args.device)
    corpus, index = built or _build(args, dev)
    top_r = args.top_r
    qe, qt = corpus.query_emb, corpus.query_tokens
    oracle = tune.exact_oracle(corpus.doc_emb, corpus.query_emb,
                               ORACLE_WIDTH)

    # the pre-§14 operating point: hand-picked widths, as-built codec
    d_res = hi.search(index, qe, qt, kc=serve.DEFAULT_KC,
                      k2=serve.DEFAULT_K2, top_r=top_r, device=dev)
    d_recall = float(tune.per_query_recall(d_res.doc_ids, oracle,
                                           top_r).mean())
    d_cost = hi.candidate_cost(index, serve.DEFAULT_KC, serve.DEFAULT_K2,
                               top_r)
    target = round(TARGET_FRAC * d_recall, 4)

    tuned, points = tune.tune_index(index, qe, qt, oracle,
                                    recall_target=target, top_r=top_r,
                                    refine_mults=REFINE_MULTS, device=dev)
    tuned_idx = tune.apply_tuned(index, tuned)

    # adaptive ladder on the held-out sample: per-query rung by margin,
    # recall composed from the per-rung searches, cost averaged
    m = frontier.margins(index.cluster_sel.embeddings, qe)
    rung = frontier.resolve_rung(m, tuned.margin_cuts)
    rung_recall, rung_cost = [], []
    for kc, k2 in tuned.rungs:
        res = hi.search(tuned_idx, qe, qt, kc=kc, k2=k2, top_r=top_r,
                        device=dev)
        rung_recall.append(tune.per_query_recall(res.doc_ids, oracle,
                                                 top_r))
        rung_cost.append(hi.candidate_cost(tuned_idx, kc, k2, top_r))
    per_q = np.stack(rung_recall)[rung, np.arange(rung.shape[0])]
    costs = np.asarray(rung_cost, np.float64)[rung]
    report = {
        "codec": CODEC,
        "top_r": top_r,
        "oracle_width": ORACLE_WIDTH,
        "recall_target": target,
        "default": {"kc": serve.DEFAULT_KC, "k2": serve.DEFAULT_K2,
                    "refine_mult": 4, "cost": int(d_cost),
                    "recall": round(d_recall, 4)},
        "tuned": frontier.to_json(tuned),
        "pareto_frontier": [
            {"kc": p.kc, "k2": p.k2, "refine_mult": p.refine_mult,
             "cost": p.cost, "recall": round(p.recall, 4)}
            for p in frontier.pareto_frontier(points)],
        "adaptive": {
            "n_rungs": len(tuned.rungs),
            "rung_fractions": [round(float((rung == r).mean()), 4)
                               for r in range(len(tuned.rungs))],
            "mean_cost": round(float(costs.mean()), 1),
            "recall": round(float(per_q.mean()), 4),
        },
    }
    return report, tuned


# --------------------------------------------------------------------------
# stage: variants (explicit-width bit-identity)
# --------------------------------------------------------------------------

def run_variant(layout: str, args, built=None) -> dict:
    """One layout's explicit/default-width rows against the direct
    search at (DEFAULT_KC, DEFAULT_K2)."""
    from repro_torch.core import hybrid_index as hi
    from repro_torch.core import segments as seg
    from repro_torch.launch import serve

    dev = dev_mod.resolve(args.device)
    corpus, index = built or _build(args, dev)
    b = args.max_batch
    qe, qt = corpus.query_emb[:b], corpus.query_tokens[:b]
    kc, k2 = serve.DEFAULT_KC, serve.DEFAULT_K2
    mutable = layout in ("mutable", "sharded_mutable")
    n = 2 if layout in ("sharded", "sharded_mutable") else 1
    kw = dict(top_r=args.top_r, max_batch=b, n_shards=n, mutable=mutable,
              delta_capacity=256)

    def make(cfg):
        if mutable:
            mut = seg.MutableHybridIndex.create(
                0, corpus.doc_emb, corpus.doc_tokens, corpus.vocab_size,
                delta_capacity=256, device=dev, **_build_kwargs(args))
            if n > 1:
                return serve.ShardedMutableServer(mut, cfg,
                                                  devices=[dev] * n)
            return serve.make_mutable_server(mut, cfg, device=dev)
        if n > 1:
            return serve.ShardedServer(index, cfg, devices=[dev] * n)
        return serve.make_server(index, cfg, device=dev)

    explicit = make(serve.ServeConfig(kc=kc, k2=k2, **kw))
    default = make(serve.ServeConfig(**kw))
    # the direct call for this layout, at the same widths
    if mutable:
        direct = explicit.mut.search(qe, qt, kc=kc, k2=k2, top_r=args.top_r)
    else:
        direct = hi.search(index, qe, qt, kc=kc, k2=k2, top_r=args.top_r,
                           device=dev)
    e_rows = explicit.query(qe, qt)
    d_rows = default.query(qe, qt)
    for server in (explicit, default):
        if n > 1:
            server.mesh.close()
    return {
        "resolved_widths": [default.kc, default.k2],
        "width_source_default_cfg": default.width_source,
        "explicit_equals_direct": _equal(e_rows, direct),
        "default_equals_explicit": _equal(d_rows, e_rows),
    }


def run_variants(args, built=None) -> dict:
    return {layout: run_variant(layout, args, built) for layout in LAYOUTS}


# --------------------------------------------------------------------------
# stage: runtime (adaptive serving contracts)
# --------------------------------------------------------------------------

def run_runtime(args, tuned, built=None) -> dict:
    from repro_torch.core import hybrid_index as hi
    from repro_torch.core.exec import frontier
    from repro_torch.launch import runtime as rt_mod
    from repro_torch.launch import serve, tune

    dev = dev_mod.resolve(args.device)
    corpus, index = built or _build(args, dev)
    idx = tune.apply_tuned(index, tuned)
    server = serve.Server(idx, serve.ServeConfig(
        adaptive=True, top_r=args.top_r, max_batch=args.max_batch),
        device=dev)
    n = corpus.query_emb.shape[0]
    rt = rt_mod.ServingRuntime(server, rt_mod.RuntimeConfig(
        linger_ms=1.0, queue_depth=max(256, 2 * n), cache_size=2 * n))
    rt.warmup(args.hidden, corpus.query_tokens.shape[1])

    futures = [rt.submit(corpus.query_emb[i], corpus.query_tokens[i])
               for i in range(n)]
    rows = [f.result(timeout=600) for f in futures]
    stats = rt.stats()

    # replay: every repeat must hit the cache (runtime idle in between)
    hits0 = stats["cache"]["hits"]
    replay = [rt.submit(corpus.query_emb[i], corpus.query_tokens[i])
              for i in range(n)]
    replay_rows = [f.result(timeout=600) for f in replay]
    replay_hits = rt.stats()["cache"]["hits"] - hits0
    replay_identical = all(
        np.array_equal(a.doc_ids, b.doc_ids)
        and np.array_equal(a.scores, b.scores)
        and np.array_equal(a.n_candidates, b.n_candidates)
        for a, b in zip(rows, replay_rows))
    rt.close(drain=True)

    # per-rung bit-identity: each row == the direct search at its
    # resolved rung's widths (rows do not depend on the batch size)
    m = frontier.margins(idx.cluster_sel.embeddings, corpus.query_emb)
    rung = frontier.resolve_rung(m, server.margin_cuts)
    identical = True
    for r, (kc, k2) in enumerate(server.rungs):
        ids, sc, _ = _host(hi.search(idx, corpus.query_emb,
                                     corpus.query_tokens, kc=kc, k2=k2,
                                     top_r=args.top_r, device=dev))
        for i in np.nonzero(rung == r)[0]:
            identical &= (np.array_equal(rows[i].doc_ids, ids[i])
                          and np.array_equal(rows[i].scores, sc[i]))
    q0 = np.asarray(corpus.query_emb[0], np.float32)
    t0 = np.asarray(corpus.query_tokens[0], np.int64)
    return {
        "width_source": stats["width_source"],
        "rungs": stats["rungs"],
        "buckets": stats["buckets"],
        "warm_compiles": {str(k): v for k, v in
                          sorted(stats["warm_traces"].items())},
        "post_warmup_compiles": stats["post_warmup_traces"],
        "rung_dispatch": {str(k): v for k, v in
                          sorted(stats["rung_dispatch"].items())},
        "per_rung_bit_identical": bool(identical),
        "replay_hits": int(replay_hits),
        "replay_queries": n,
        "replay_bit_identical": bool(replay_identical),
        "cross_rung_key_distinct": bool(
            rt._key(q0, t0, None, 0) != rt._key(q0, t0, None, 1)),
    }


# --------------------------------------------------------------------------
# checks
# --------------------------------------------------------------------------

def check_tune(report: dict) -> list:
    """Contracts (a) and (b): what the tune found on this data."""
    fails = []
    tuned, default = report["tuned"], report["default"]
    adaptive = report["adaptive"]
    # (a) tuned-static: meets target, strictly cheaper than the default
    if tuned["recall"] < report["recall_target"]:
        fails.append(f"tuned recall {tuned['recall']} misses the target "
                     f"{report['recall_target']}")
    if not tuned["cost"] < default["cost"]:
        fails.append(f"tuned cost {tuned['cost']} not strictly below the "
                     f"default {default['cost']}")
    # (b) adaptive: cheaper-or-equal mean cost at equal-or-better recall
    if adaptive["mean_cost"] > tuned["cost"]:
        fails.append(f"adaptive mean cost {adaptive['mean_cost']} above "
                     f"tuned-static {tuned['cost']}")
    if adaptive["recall"] < tuned["recall"] - 1e-9:
        fails.append(f"adaptive recall {adaptive['recall']} below "
                     f"tuned-static {tuned['recall']}")
    if adaptive["n_rungs"] < 2:
        fails.append("calibration produced no adaptive ladder "
                     "(single rung) — adaptivity is untested")
    return fails


def check_serving(report: dict) -> list:
    """Contracts (c)-(e): what serving guarantees at any tune outcome."""
    fails = []
    # (c) explicit widths, adaptivity off: bit-identical on all layouts
    for layout, rep in report["variants"].items():
        if not rep["explicit_equals_direct"]:
            fails.append(f"{layout}: explicit-width serving != direct "
                         "search")
        if not rep["default_equals_explicit"]:
            fails.append(f"{layout}: default-config serving != explicit "
                         f"{report['default']['kc']}/"
                         f"{report['default']['k2']}")
    # (d) one program per (bucket, rung), none built while serving
    rt = report["runtime"]
    want = len(rt["buckets"]) * len(rt["rungs"])
    if len(rt["warm_compiles"]) != want:
        fails.append(f"warm ledger has {len(rt['warm_compiles'])} "
                     f"programs, want {want} (buckets x rungs)")
    bad = {k: v for k, v in rt["warm_compiles"].items() if v != 1}
    if bad:
        fails.append(f"warmup programs per (bucket, rung) != 1: {bad}")
    if rt["post_warmup_compiles"]:
        fails.append(f"{rt['post_warmup_compiles']} programs built by "
                     "adaptive serving after warmup")
    if rt["width_source"] != "tuned":
        fails.append(f"runtime width source {rt['width_source']!r}, "
                     "want 'tuned'")
    if sorted(int(k) for k, v in rt["rung_dispatch"].items() if v) \
            != list(range(len(rt["rungs"]))):
        fails.append(f"not every rung dispatched: {rt['rung_dispatch']}")
    if not rt["per_rung_bit_identical"]:
        fails.append("adaptive rows != direct search at the resolved "
                     "rung's widths")
    # (e) the cache never replays across rungs
    if not rt["cross_rung_key_distinct"]:
        fails.append("cache key does not separate rungs")
    if rt["replay_hits"] != rt["replay_queries"]:
        fails.append(f"replay hit {rt['replay_hits']}"
                     f"/{rt['replay_queries']}")
    if not rt["replay_bit_identical"]:
        fails.append("replayed rows != first-pass rows")
    return fails


def check(report: dict) -> list:
    """The reference's ``--check`` contracts (a)-(e) on one report."""
    return check_tune(report) + check_serving(report)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small corpus (CI scale)")
    ap.add_argument("--stage", default=None,
                    choices=("variants", "runtime"),
                    help="run ONE serving stage (default: all three "
                         "stages)")
    ap.add_argument("--top-r", type=int, default=100)
    ap.add_argument("--max-batch", type=int, default=None)
    ap.add_argument("--tuned-json", default=None,
                    help="TunedWidths JSON for --stage runtime")
    ap.add_argument("--out", default=None,
                    help="write the report here")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero unless the §14 acceptance "
                         "contracts (a)-(e) hold")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels, one CUDA graph per "
                         "(bucket, rung)) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    _scale(args)
    return args


def run(args) -> dict:
    """The report of ``args.stage`` (all three stages by default)."""
    if args.stage == "variants":
        return run_variants(args)
    if args.stage == "runtime":
        if not args.tuned_json:
            sys.exit("--stage runtime needs --tuned-json")
        from repro_torch.core.exec import frontier
        return run_runtime(args, frontier.from_json(
            json.loads(args.tuned_json)))
    built = _build(args, dev_mod.resolve(args.device))
    tune_rep, tuned = run_tune(args, built)
    return {
        "bench": "autotune",
        "smoke": bool(args.smoke),
        "n_docs": args.docs,
        "n_queries": args.queries,
        "max_batch": args.max_batch,
        "device": str(dev_mod.resolve(args.device)),
        **tune_rep,
        "variants": run_variants(args, built),
        "runtime": run_runtime(args, tuned, built),
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
    if args.check and args.stage is None:
        failures = check(report)
        if failures:
            sys.exit("; ".join(failures))


if __name__ == "__main__":
    main()

"""Supervised HI² distillation benchmark (port of
``benchmarks/sup_distill.py``; paper §4.3, DESIGN.md §15): the
selector-quality evidence chain for HI²_sup, under the reference's
report keys.

    python -m repro_torch.benchmarks.sup_distill --smoke --check \\
        --device cpu                                     # CPU, plain path
    python -m repro_torch.benchmarks.sup_distill --check --out F.json

Two stages, on ``--device`` (default ``cuda``):

  · **train + sweep**: build the HI²_unsup baseline (``opq``), mine its
    top-scoring non-relevant docs as hard negatives (united with the
    topic-matched pool), train the supervised selectors with in-batch
    negatives and the refine-stage KL (the §15 recipe) through
    :func:`repro_torch.launch.train.train_hi2_sup`, assemble HI²_sup at
    the frozen training-time φ, and sweep recall@R against the unsup
    index over ``frontier.WIDTH_GRID`` — matched capacities make
    ``candidate_cost`` identical at every (kc, k2), so a recall delta
    is selector quality alone.  The sup index round-trips through
    ``save_index``/``restore_index``.
  · **variants**: the trained ``SupSelectors`` (restored from the
    stage's ``{"params"}`` checkpoint) drive every serving layout
    (``plain``: ``hi.build`` + search; ``sharded``: ``ShardedServer``;
    ``mutable``: ``MutableHybridIndex``; ``sharded_mutable``:
    ``ShardedMutableServer``; the sharded ones on two mesh positions of
    ``--device``) to the same doc ids, and a supervised mutable index
    survives add → delete → compact with the compaction equal to a
    from-scratch supervised build over the survivors.  The reference
    runs this stage in a subprocess with two emulated devices, which
    only its sharded layouts need; here it runs in the same process.

``--check`` exits non-zero unless (a) sup recall >= unsup at matched
cost on at least one operating point (costs asserted equal), (b) the
windowed loss means fall (a fraction ``MONOTONE_FRAC`` of the windows
improve, and the last loss is below the first), (c) the index round
trip is bit-identical, (d) the four layouts agree and the mutable
lifecycle holds.  Every report field is deterministic on one device
(losses rounded to 4 dp, no wall clock).  The report goes to stdout
and, with ``--out``, to that file only.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch import device as dev_mod

LAYOUTS = ("plain", "sharded", "mutable", "sharded_mutable")
CODEC = "opq"

#: oracle width: recall@top_r of the exact top-10 neighbours — the
#: teacher's own objective (Eq. 10)
ORACLE_WIDTH = 10

#: fraction of consecutive loss windows whose mean must improve on the
#: previous window for the trajectory to count as monotone-ish
MONOTONE_FRAC = 0.7


def _scale(args) -> None:
    if args.smoke:
        args.docs, args.queries = 2500, 192
        args.hidden, args.vocab, args.clusters = 32, 2048, 32
        args.pq_m, args.pq_k, args.kmeans_iters = 4, 64, 6
        args.steps = args.steps or 160
    else:
        args.docs, args.queries = 4000, 256
        args.hidden, args.vocab, args.clusters = 32, 2048, 32
        args.pq_m, args.pq_k, args.kmeans_iters = 8, 64, 8
        args.steps = args.steps or 300


def _common(args) -> dict:
    return dict(k1_terms=8, codec=CODEC, pq_m=args.pq_m, pq_k=args.pq_k,
                cluster_capacity=512, term_capacity=96)


def _corpus(args):
    from repro_torch.data import synthetic
    return synthetic.generate(seed=0, n_docs=args.docs,
                              n_queries=args.queries, hidden=args.hidden,
                              vocab_size=args.vocab, n_topics=args.clusters)


def _cfg(args):
    from repro_torch.launch import train
    return train.SupTrainConfig(
        n_clusters=args.clusters, encoder_layers=1,
        encoder_dim=args.hidden, encoder_heads=2, n_steps=args.steps,
        batch_queries=32, n_negatives=7, n_inbatch=4, refine_weight=0.5,
        lr=2e-3, kmeans_iters=args.kmeans_iters, seed=0)


def _tree_equal(a, b) -> bool:
    from repro_torch.core import hybrid_index as hi
    la, lb = hi.index_leaves(a), hi.index_leaves(b)
    return len(la) == len(lb) and all(
        pa == pb and torch.equal(torch.as_tensor(x).cpu(),
                                 torch.as_tensor(y).cpu())
        for (pa, x), (pb, y) in zip(la, lb))


def _ids(res) -> np.ndarray:
    return res.doc_ids.cpu().numpy()


def trajectory(losses: list) -> dict:
    """Windowed means of the loss over 10 equal slices, and the fraction
    of windows whose mean improves on the previous one (contract (b))."""
    n = len(losses)
    w = max(1, n // 10)
    windows = [round(float(np.mean(losses[i:i + w])), 4)
               for i in range(0, n - w + 1, w)]
    improving = sum(b < a for a, b in zip(windows, windows[1:]))
    return {
        "n_steps": n,
        "loss_first": round(losses[0], 4),
        "loss_last": round(losses[-1], 4),
        "window_means": windows,
        "frac_improving_windows": round(improving / max(
            1, len(windows) - 1), 4),
    }


# --------------------------------------------------------------------------
# stage: train + sweep
# --------------------------------------------------------------------------

def run_train_sweep(args, ckpt_dir: str) -> tuple:
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import distill, hybrid_index as hi, metrics
    from repro_torch.core.exec import frontier
    from repro_torch.data import synthetic
    from repro_torch.launch import train, tune

    dev = dev_mod.resolve(args.device)
    corpus = _corpus(args)
    common = _common(args)
    qe, qt = corpus.query_emb, corpus.query_tokens
    oracle = tune.exact_oracle(corpus.doc_emb, corpus.query_emb,
                               ORACLE_WIDTH)

    unsup = hi.build(0, corpus.doc_emb, corpus.doc_tokens, corpus.vocab_size,
                     n_clusters=args.clusters,
                     kmeans_iters=args.kmeans_iters, device=dev, **common)

    # §15 negative pool: topic-matched ∪ mined-from-the-unsup-index
    topic = synthetic.hard_negatives(corpus, 7, seed=0)
    mined = distill.mine_hard_negatives(unsup, corpus.query_emb,
                                        corpus.query_tokens, corpus.qrels,
                                        7)
    pool = np.concatenate([topic, mined], axis=1)

    cfg = _cfg(args)
    params, enc_cfg, assign, losses = train.train_hi2_sup(
        corpus, cfg, log_every=0, negatives=pool, device=dev)
    ckpt.save(ckpt_dir, cfg.n_steps, {"params": params})

    sup = train.build_sup_index(corpus, params, enc_cfg, assign, device=dev,
                                **common)

    points, wins = [], 0
    for kc, k2 in frontier.WIDTH_GRID:
        ru = hi.search(unsup, qe, qt, kc=kc, k2=k2, top_r=args.top_r,
                       device=dev)
        rs = hi.search(sup, qe, qt, kc=kc, k2=k2, top_r=args.top_r,
                       device=dev)
        cost_u = hi.candidate_cost(unsup, kc, k2, args.top_r)
        cost_s = hi.candidate_cost(sup, kc, k2, args.top_r)
        r_u = round(float(tune.per_query_recall(
            ru.doc_ids, oracle, args.top_r).mean()), 4)
        r_s = round(float(tune.per_query_recall(
            rs.doc_ids, oracle, args.top_r).mean()), 4)
        wins += r_s >= r_u
        points.append({
            "kc": kc, "k2": k2,
            "cost_unsup": int(cost_u), "cost_sup": int(cost_s),
            "recall_unsup": r_u, "recall_sup": r_s,
            "qrels_recall_unsup": round(metrics.recall_at_k(
                ru.doc_ids.cpu(), corpus.qrels, args.top_r), 4),
            "qrels_recall_sup": round(metrics.recall_at_k(
                rs.doc_ids.cpu(), corpus.qrels, args.top_r), 4),
        })

    # (c) assembly bit-round-trips through the index checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        path = ckpt.save_index(tmp, 0, sup)
        restored = ckpt.restore_index(path, sup)
    rt = hi.search(restored, qe, qt, kc=6, k2=8, top_r=args.top_r,
                   device=dev)
    rd = hi.search(sup, qe, qt, kc=6, k2=8, top_r=args.top_r, device=dev)
    roundtrip = {
        "planes_bit_identical": _tree_equal(sup, restored),
        "search_bit_identical": bool(
            torch.equal(rt.doc_ids, rd.doc_ids)
            and torch.equal(rt.scores, rd.scores)),
    }

    return {
        "codec": CODEC,
        "top_r": args.top_r,
        "oracle_width": ORACLE_WIDTH,
        "negative_pool": {"topic": int(topic.shape[1]),
                          "mined": int(mined.shape[1]),
                          "in_batch": cfg.n_inbatch},
        "refine_weight": cfg.refine_weight,
        "operating_points": points,
        "sup_wins": int(wins),
        "n_operating_points": len(points),
        "trajectory": trajectory(losses),
        "roundtrip": roundtrip,
    }, (params, enc_cfg)


# --------------------------------------------------------------------------
# stage: variants
# --------------------------------------------------------------------------

def _variant_setup(args, params_ckpt: str, trained) -> dict:
    """The trained selectors restored from the train stage's checkpoint,
    the corpus, and the plain supervised build every layout is held
    to."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import hybrid_index as hi
    from repro_torch.launch import train

    dev = dev_mod.resolve(args.device)
    like, enc_cfg = trained
    params = ckpt.restore(params_ckpt, {"params": like})["params"]
    sel = train.SupSelectors(params=params, enc_cfg=enc_cfg, device=dev)
    corpus = _corpus(args)
    b = 64
    qe, qt = corpus.query_emb[:b], corpus.query_tokens[:b]
    # every layout shares one base: hi.build under the selector bundle
    # (argmax φ — the corpus-independent recipe compaction needs)
    sel_kwargs = sel.build_inputs(corpus.doc_emb, corpus.doc_tokens,
                                  corpus.vocab_size)
    base = hi.build(0, corpus.doc_emb, corpus.doc_tokens, corpus.vocab_size,
                    n_clusters=args.clusters, device=dev, **sel_kwargs,
                    **_common(args))
    ref = hi.search(base, qe, qt, kc=6, k2=8, top_r=args.top_r, device=dev)
    return dict(dev=dev, sel=sel, corpus=corpus, qe=qe, qt=qt, base=base,
                ref_ids=_ids(ref))


def _build_mut(args, v):
    from repro_torch.core import segments as seg
    corpus = v["corpus"]
    return seg.MutableHybridIndex.create(
        0, corpus.doc_emb, corpus.doc_tokens, corpus.vocab_size,
        delta_capacity=128, selectors=v["sel"], device=v["dev"],
        **_common(args))


def run_variant(layout: str, args, v: dict) -> dict:
    """One layout's doc ids against the plain supervised search."""
    from repro_torch.launch import serve
    if layout == "plain":
        return {"ids_identical": True}            # the reference
    dev, b = v["dev"], v["qe"].shape[0]
    cfg = dict(kc=6, k2=8, top_r=args.top_r, max_batch=b, n_shards=2)
    if layout == "sharded":
        server = serve.ShardedServer(v["base"], serve.ServeConfig(**cfg),
                                     devices=[dev] * 2)
    elif layout == "sharded_mutable":
        server = serve.ShardedMutableServer(
            _build_mut(args, v), serve.ServeConfig(
                mutable=True, delta_capacity=128, **cfg), devices=[dev] * 2)
    else:
        mut = _build_mut(args, v)
        v["mut"] = mut
        return {"ids_identical": bool(np.array_equal(_ids(mut.search(
            v["qe"], v["qt"], kc=6, k2=8, top_r=args.top_r)),
            v["ref_ids"]))}
    ids = _ids(server.query(v["qe"], v["qt"]))
    server.mesh.close()
    return {"ids_identical": bool(np.array_equal(ids, v["ref_ids"]))}


def run_lifecycle(args, v: dict) -> dict:
    """Supervised mutable lifecycle: add → delete → compact, with the
    compaction equal to a from-scratch supervised build over the
    survivors (the §10 contract under learned selectors)."""
    from repro_torch.core import segments as seg
    mut, corpus = v["mut"], v["corpus"]
    ids = mut.add_docs(corpus.query_emb[:16], corpus.query_tokens[:16])
    mut.delete_docs(ids[:4])
    mut.delete_docs(np.arange(8))
    comp = mut.compact()
    emb_s, tok_s = mut.surviving_corpus()
    scratch = seg.MutableHybridIndex.create(
        0, emb_s, tok_s, corpus.vocab_size, delta_capacity=128,
        selectors=v["sel"], device=v["dev"], **_common(args))
    kw = dict(kc=6, k2=8, top_r=args.top_r)
    c_res = comp.search(v["qe"], v["qt"], **kw)
    s_res = scratch.search(v["qe"], v["qt"], **kw)
    return {
        "n_live_after": int(comp.n_docs),
        "expected_live": int(args.docs + 16 - 12),
        "compact_equals_scratch": bool(
            _tree_equal(comp.base, scratch.base)
            and torch.equal(c_res.doc_ids, s_res.doc_ids)
            and torch.equal(c_res.scores, s_res.scores)),
    }


def run_variants(args, params_ckpt: str, trained) -> dict:
    v = _variant_setup(args, params_ckpt, trained)
    report = {layout: run_variant(layout, args, v) for layout in LAYOUTS}
    report["mutable_lifecycle"] = run_lifecycle(args, v)
    return report


# --------------------------------------------------------------------------
# orchestration + checks
# --------------------------------------------------------------------------

def check(report: dict) -> list:
    """The reference's ``--check`` contracts (a)-(d) on one report."""
    fails = []
    # (a) matched cost, and sup must win somewhere
    for p in report["operating_points"]:
        if p["cost_sup"] != p["cost_unsup"]:
            fails.append(f"kc={p['kc']} k2={p['k2']}: costs not matched "
                         f"({p['cost_sup']} vs {p['cost_unsup']})")
    if report["sup_wins"] < 1:
        fails.append("sup recall < unsup at every matched operating "
                     "point — distillation buys nothing")
    # (b) loss trajectory monotone-ish
    t = report["trajectory"]
    if t["loss_last"] >= t["loss_first"]:
        fails.append(f"loss did not decrease ({t['loss_first']} -> "
                     f"{t['loss_last']})")
    if t["frac_improving_windows"] < MONOTONE_FRAC:
        fails.append(f"loss trajectory not monotone-ish: only "
                     f"{t['frac_improving_windows']} of windows improve "
                     f"(need >= {MONOTONE_FRAC})")
    # (c) checkpoint round-trip
    for k, v in report["roundtrip"].items():
        if not v:
            fails.append(f"index round-trip failed: {k}")
    # (d) the four layouts + mutable lifecycle
    for layout in LAYOUTS:
        if not report["variants"][layout]["ids_identical"]:
            fails.append(f"{layout}: doc ids differ from the plain "
                         "supervised search")
    life = report["variants"]["mutable_lifecycle"]
    if life["n_live_after"] != life["expected_live"]:
        fails.append(f"mutable lifecycle lost docs: {life['n_live_after']}"
                     f" live, expected {life['expected_live']}")
    if not life["compact_equals_scratch"]:
        fails.append("supervised compact() != from-scratch supervised "
                     "build over the survivors")
    return fails


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small corpus (CI scale)")
    ap.add_argument("--top-r", type=int, default=100)
    ap.add_argument("--steps", type=int, default=None,
                    help="override the training step count")
    ap.add_argument("--out", default=None, help="write the report here")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero unless the §15 acceptance "
                         "contracts (a)-(d) hold")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)
    _scale(args)
    return args


def run(args) -> dict:
    with tempfile.TemporaryDirectory() as ckpt_dir:
        sweep, trained = run_train_sweep(args, ckpt_dir)
        step_dir = os.path.join(ckpt_dir, sorted(os.listdir(ckpt_dir))[-1])
        variants = run_variants(args, step_dir, trained)
    return {
        "bench": "sup_distill",
        "smoke": bool(args.smoke),
        "n_docs": args.docs,
        "n_queries": args.queries,
        "device": str(dev_mod.resolve(args.device)),
        **sweep,
        "variants": variants,
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
        failures = check(report)
        if failures:
            sys.exit("; ".join(failures))


if __name__ == "__main__":
    main()

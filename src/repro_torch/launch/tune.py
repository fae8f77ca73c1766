"""Offline width autotuner (port of ``repro/launch/tune.py``; DESIGN.md
§14): ``exact_oracle``, ``per_query_recall``, ``tune_index`` (with the
adaptive-ladder calibration over :data:`EASY_FRACTIONS`),
``apply_tuned`` and the ``main`` CLI.

    python -m repro_torch.launch.tune --device cpu --docs 8000 \\
        --recall-target 0.95 --out /tmp/tuned_ckpt

  1. sweep a (kc, k2[, refine-mult]) grid on a held-out query sample,
     scoring recall@R against the exact brute-force oracle and cost by
     the static :func:`repro_torch.core.hybrid_index.candidate_cost`
     proxy (:mod:`repro_torch.core.exec.frontier` holds the grid);
  2. select the CHEAPEST config meeting the recall target;
  3. calibrate an optional adaptive rung ladder: if routing the easiest
     fraction of queries (largest top-1 vs top-2 cluster-score margin)
     to a cheaper frontier config keeps the held-out recall while
     lowering the mean per-query cost, record the (narrow, tuned) ladder
     and its margin cut;
  4. attach the outcome to the index as a :class:`frontier.TunedWidths`
     record (:func:`apply_tuned`), which ``checkpoint.save_index``
     writes to the manifest and :mod:`repro_torch.launch.serve` honours
     as the serving default.

A refine multiplier tunes for free: ``refine[:base[:mult]]`` changes
only the search-time refine width, so each multiplier is a spec rewrite
(``dataclasses.replace(index, codec=...)``) over the same planes, never
a re-encode.  Searches run on the index's ``device`` (default ``cuda``,
the hand-written kernels; ``cpu`` their plain versions).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import device as dev_mod
from repro_torch.core import hybrid_index as hi
from repro_torch.core.codecs import refine as refine_codec
from repro_torch.core.exec import frontier

#: the easy-query fractions tried per candidate narrow rung when
#: calibrating the adaptive ladder (step 3 above)
EASY_FRACTIONS = (0.9, 0.75, 0.5, 0.25, 0.1)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def exact_oracle(doc_emb, query_emb, top_r: int) -> np.ndarray:
    """Brute-force top-R doc ids per query on the host — the tuner's
    ground truth (an unordered id set; recall@R does not depend on rank
    order)."""
    s = _host(query_emb).astype(np.float32) @ _host(doc_emb).astype(
        np.float32).T
    k = min(top_r, s.shape[1])
    return np.argpartition(-s, k - 1, axis=1)[:, :k].astype(np.int64)


def per_query_recall(retrieved, oracle_ids, k: int) -> np.ndarray:
    """(B,) recall@k against the oracle id sets (-1 pads ignored)."""
    r = _host(retrieved)[:, :k]
    o = _host(oracle_ids)
    hit = (r[:, :, None] == o[:, None, :]) & (o[:, None, :] >= 0)
    return (hit.any(axis=1).sum(axis=-1)
            / np.maximum((o >= 0).sum(axis=-1), 1))


def _with_mult(spec: str, mult: int) -> str:
    """The refine spec with its multiplier replaced (base preserved)."""
    parts = spec.split(":")
    base = parts[1] if len(parts) > 1 and parts[1] else \
        refine_codec.DEFAULT_BASE
    return f"refine:{base}:{int(mult)}"


def _spec_for(codec: str, refine_mult: Optional[int]) -> str:
    return codec if refine_mult is None else _with_mult(codec, refine_mult)


def tune_index(index: hi.HybridIndex, query_emb, query_tokens,
               oracle_ids, *, recall_target: float = 0.95,
               top_r: int = 100, grid: Sequence = frontier.WIDTH_GRID,
               refine_mults: Sequence = (),
               device: dev_mod.DeviceLike = "cuda") -> tuple:
    """Run the full tune on one built index (on ``device``) and a
    held-out query sample.

    Returns ``(tuned, points)``: the :class:`frontier.TunedWidths`
    outcome and every evaluated :class:`frontier.SweepPoint`.
    ``refine_mults`` only applies to a ``refine`` codec — each
    multiplier sweeps the grid on a spec-rewritten view of the same
    index (the same plane tensors)."""
    dev = dev_mod.resolve(device)
    qe = dev_mod.as_tensor(query_emb, dev, torch.float32)
    qt = dev_mod.as_tensor(query_tokens, dev, torch.int64)
    is_refine = index.codec.split(":")[0] == "refine"
    mults = tuple(refine_mults) if (refine_mults and is_refine) else \
        (None,)
    per_q: dict = {}     # (spec, kc, k2) -> per-query recall array
    points: list = []
    for mult in mults:
        spec = _spec_for(index.codec, mult)
        idx = (index if spec == index.codec
               else dataclasses.replace(index, codec=spec))

        def run(kc, k2, idx=idx, spec=spec):
            res = hi.search(idx, qe, qt, kc=kc, k2=k2, top_r=top_r,
                            device=dev)
            pq = per_query_recall(res.doc_ids, oracle_ids, top_r)
            per_q[(spec, kc, k2)] = pq
            return pq.mean(), hi.candidate_cost(idx, kc, k2, top_r)

        points += frontier.sweep(run, grid, refine_mult=mult)
    best = frontier.select(points, recall_target)
    best_spec = _spec_for(index.codec, best.refine_mult)
    rungs, cuts = _calibrate_rungs(
        index, [p for p in points if p.refine_mult == best.refine_mult],
        best, per_q, best_spec, query_emb, top_r)
    tuned = frontier.TunedWidths(
        kc=int(best.kc), k2=int(best.k2), refine_mult=best.refine_mult,
        recall_target=float(recall_target), recall=float(best.recall),
        cost=int(best.cost), rungs=rungs, margin_cuts=cuts)
    return tuned, points


def _calibrate_rungs(index, points, best, per_q, spec, query_emb,
                     top_r) -> tuple:
    """Try a 2-rung (narrow, tuned) ladder per cheaper frontier config
    × easy fraction; keep the cheapest that holds the tuned recall on
    the held-out sample, else the single-rung ladder.  The ladder varies
    only (kc, k2); the refine multiplier stays the selected one."""
    degenerate = (((best.kc, best.k2),), ())
    margins = frontier.margins(index.cluster_sel.embeddings, query_emb)
    best_pq = per_q[(spec, best.kc, best.k2)]
    cheaper = [p for p in frontier.pareto_frontier(points)
               if p.cost < best.cost and (p.kc, p.k2) != (best.kc,
                                                          best.k2)]
    choice = None        # (mean_cost, rungs, cuts)
    for p in cheaper:
        narrow_pq = per_q[(spec, p.kc, p.k2)]
        for frac in EASY_FRACTIONS:
            cut = float(np.quantile(margins, 1.0 - frac))
            easy = margins >= cut
            if not easy.any() or easy.all():
                continue
            composed = np.where(easy, narrow_pq, best_pq)
            f = float(easy.mean())
            mean_cost = f * p.cost + (1.0 - f) * best.cost
            if (composed.mean() >= best.recall - 1e-9
                    and mean_cost < best.cost
                    and (choice is None or mean_cost < choice[0])):
                choice = (mean_cost,
                          ((int(p.kc), int(p.k2)),
                           (int(best.kc), int(best.k2))),
                          (round(cut, 6),))
    return (choice[1], choice[2]) if choice is not None else degenerate


def apply_tuned(index: hi.HybridIndex,
                tuned: frontier.TunedWidths) -> hi.HybridIndex:
    """The index with the tune applied: codec spec rewritten to the
    selected refine multiplier (when one was tuned) and the record
    attached (:func:`hi.with_tuned`); the planes are shared."""
    idx = index
    if tuned.refine_mult is not None:
        spec = _with_mult(index.codec, tuned.refine_mult)
        if spec != index.codec:
            idx = dataclasses.replace(idx, codec=spec)
    return hi.with_tuned(idx, tuned)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(
        description="HI² offline width autotuner (DESIGN.md §14)")
    ap.add_argument("--docs", type=int, default=8000)
    ap.add_argument("--queries", type=int, default=256,
                    help="held-out tuning queries")
    ap.add_argument("--codec", default="refine:pq:4")
    ap.add_argument("--top-r", type=int, default=100)
    ap.add_argument("--recall-target", type=float, default=0.95)
    ap.add_argument("--refine-mults", type=int, nargs="*",
                    default=(2, 4, 8),
                    help="refine multipliers to sweep (refine codec "
                         "only)")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="save the tuned index as a checkpoint "
                         "(repro_torch.checkpoint.checkpoint.save_index)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the hand-written kernels) or cpu "
                         "(their plain PyTorch versions)")
    args = ap.parse_args(argv)
    dev = dev_mod.resolve(args.device)

    from repro_torch.data import synthetic
    corpus = synthetic.generate(seed=0, n_docs=args.docs,
                                n_queries=args.queries, hidden=64,
                                vocab_size=4096)
    index = hi.build(0, corpus.doc_emb, corpus.doc_tokens,
                     corpus.vocab_size, n_clusters=128, k1_terms=10,
                     codec=args.codec, pq_m=8, pq_k=256,
                     cluster_capacity=192, term_capacity=96,
                     kmeans_iters=8, device=dev)
    oracle = exact_oracle(corpus.doc_emb, corpus.query_emb, args.top_r)
    tuned, points = tune_index(
        index, corpus.query_emb, corpus.query_tokens, oracle,
        recall_target=args.recall_target, top_r=args.top_r,
        refine_mults=args.refine_mults, device=dev)
    for p in frontier.pareto_frontier(points):
        mark = " <- selected" if (p.kc, p.k2, p.refine_mult) == (
            tuned.kc, tuned.k2, tuned.refine_mult) else ""
        print(f"frontier: kc={p.kc:3d} k2={p.k2:3d} "
              f"mult={p.refine_mult} cost={p.cost:7.0f} "
              f"recall@{args.top_r}={p.recall:.4f}{mark}")
    print(f"tuned: kc={tuned.kc} k2={tuned.k2} "
          f"refine_mult={tuned.refine_mult} cost={tuned.cost} "
          f"recall={tuned.recall:.4f} (target {tuned.recall_target}) "
          f"rungs={tuned.rungs} cuts={tuned.margin_cuts}")
    if args.out:
        from repro_torch.checkpoint import checkpoint as ckpt
        path = ckpt.save_index(args.out, 0, apply_tuned(index, tuned))
        print(f"saved tuned index checkpoint: {path}")


if __name__ == "__main__":
    main()

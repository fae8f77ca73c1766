"""Recall/cost frontier tooling for width autotuning (port of
``repro/core/exec/frontier.py``; DESIGN.md §14): the sweep grids
:data:`WIDTH_GRID` and :data:`IVF_KC_GRID`, the records
:class:`SweepPoint` and :class:`TunedWidths` (with :func:`to_json` /
:func:`from_json`, the checkpoint manifest's ``extra['tuned']``), and
:func:`sweep`, :func:`pareto_frontier`, :func:`select`, :func:`margins`
and :func:`resolve_rung`.

The dispatch widths (kc, k2) — and, for a refining codec, the refine
multiplier — trade recall against the §2 latency proxy
(:func:`repro_torch.core.exec.cost.candidate_cost`).  The offline tuner
(:mod:`repro_torch.launch.tune`) and adaptive serving share this
module, so they cannot disagree on the grid or the rung rule.

Rung convention: ``TunedWidths.rungs`` is ordered narrow → wide; a
query with a LARGE top-1 vs top-2 cluster-score margin (an easy query)
takes a low rung, and ``margin_cuts`` (one fewer than the rungs,
descending) are the thresholds: rung = #{cut : margin < cut}.  One rung
and no cuts is the non-adaptive ladder.

:func:`margins` runs on the host in float64 on the L2-normalised query,
as the reference does, so a query's rung is the reference's rung and a
pure function of the serving runtime's scale-invariant cache-key
embedding.
"""
from __future__ import annotations

from typing import Callable, Iterable, NamedTuple, Optional, Sequence

import numpy as np
import torch

#: the one (kc, k2) sweep grid shared by the tuner and the fig3 sweep
WIDTH_GRID = ((1, 2), (2, 4), (4, 6), (6, 8), (8, 12), (12, 16))

#: cluster-only sweep for the IVF baselines (k2 pinned to 1)
IVF_KC_GRID = (1, 2, 4, 8, 12, 16)


class SweepPoint(NamedTuple):
    """One evaluated grid config: recall vs the candidate-cost proxy."""
    kc: int
    k2: int
    recall: float
    cost: float
    refine_mult: Optional[int] = None


class TunedWidths(NamedTuple):
    """The persisted outcome of one offline tune (DESIGN.md §14).

    Hashable and immutable: it rides ``HybridIndex.tuned`` as metadata
    like the codec spec.  ``rungs`` / ``margin_cuts`` describe the
    adaptive ladder (narrow → wide; the LAST rung is the tuned static
    config (kc, k2)); a single-rung ladder means adaptivity was
    calibrated away on the held-out sample.
    """
    kc: int
    k2: int
    refine_mult: Optional[int]   # None unless the codec is refine[:...]
    recall_target: float
    recall: float                # measured on the held-out sample
    cost: int                    # candidate_cost at (kc, k2, refine_mult)
    rungs: tuple = ()            # ((kc, k2), ...) narrow → wide
    margin_cuts: tuple = ()      # len(rungs) - 1 thresholds, descending


def to_json(tuned: TunedWidths) -> dict:
    """JSON-serializable form (checkpoint manifest ``extra['tuned']``)."""
    return {
        "kc": tuned.kc, "k2": tuned.k2, "refine_mult": tuned.refine_mult,
        "recall_target": tuned.recall_target, "recall": tuned.recall,
        "cost": tuned.cost, "rungs": [list(r) for r in tuned.rungs],
        "margin_cuts": list(tuned.margin_cuts),
    }


def from_json(d: dict) -> TunedWidths:
    mult = d.get("refine_mult")
    return TunedWidths(
        kc=int(d["kc"]), k2=int(d["k2"]),
        refine_mult=None if mult is None else int(mult),
        recall_target=float(d["recall_target"]), recall=float(d["recall"]),
        cost=int(d["cost"]),
        rungs=tuple((int(kc), int(k2)) for kc, k2 in d.get("rungs", [])),
        margin_cuts=tuple(float(c) for c in d.get("margin_cuts", [])))


# --------------------------------------------------------------------------
# sweep / frontier / selection
# --------------------------------------------------------------------------

def sweep(run_fn: Callable[[int, int], tuple],
          grid: Sequence = WIDTH_GRID,
          refine_mult: Optional[int] = None) -> list:
    """Evaluate ``run_fn(kc, k2) -> (recall, cost)`` over a grid."""
    return [SweepPoint(kc, k2, *map(float, run_fn(kc, k2)),
                       refine_mult=refine_mult)
            for kc, k2 in grid]


def pareto_frontier(points: Iterable[SweepPoint]) -> list:
    """The non-dominated subset, sorted by cost: each kept point has
    strictly higher recall than every cheaper one."""
    front, best = [], -np.inf
    for p in sorted(points, key=lambda p: (p.cost, -p.recall)):
        if p.recall > best:
            front.append(p)
            best = p.recall
    return front


def select(points: Iterable[SweepPoint],
           recall_target: float) -> SweepPoint:
    """The CHEAPEST config meeting the recall target; if none meets it,
    the highest-recall config (cheapest among ties)."""
    pts = list(points)
    if not pts:
        raise ValueError("select() needs at least one sweep point")
    meeting = [p for p in pts if p.recall >= recall_target]
    if meeting:
        return min(meeting, key=lambda p: (p.cost, -p.recall))
    return max(pts, key=lambda p: (p.recall, -p.cost))


# --------------------------------------------------------------------------
# per-query difficulty signal + rung routing
# --------------------------------------------------------------------------

def host64(x) -> np.ndarray:
    """A tensor (on any device) or array as a host float64 array; an
    array that already is one is returned as it is, not copied."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def margins(cluster_embeddings, query_embeddings) -> np.ndarray:
    """Top-1 vs top-2 cluster-score margin per query, (B,) float64, on
    the host and on the L2-NORMALIZED query (the runtime cache key's
    canonical form), so the margin, and the resolved rung, do not move
    under positive rescaling of the query.  Zero vectors get margin 0
    (maximally hard).  The serving runtime passes a float64 copy of the
    cluster embeddings it holds, which is used without a copy."""
    emb = host64(cluster_embeddings)
    q = np.atleast_2d(host64(query_embeddings))
    norms = np.linalg.norm(q, axis=1, keepdims=True)
    q = np.where(norms > 0.0, q / np.maximum(norms, 1e-30), q)
    s = q @ emb.T
    if s.shape[1] < 2:
        return np.zeros(s.shape[0], np.float64)
    top2 = np.partition(s, s.shape[1] - 2, axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def resolve_rung(margin, cuts: Sequence[float]) -> np.ndarray:
    """Margin(s) → rung index: rung = #{cut : margin < cut}.  An empty
    ``cuts`` maps everything to rung 0."""
    m = np.atleast_1d(np.asarray(margin, np.float64))
    if not cuts:
        return np.zeros(m.shape[0], np.int64)
    return (m[:, None] < np.asarray(cuts, np.float64)[None, :]).sum(axis=1)

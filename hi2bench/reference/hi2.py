"""Plain reference of one HI² search over the benchmark's planes.

It imports torch alone: nothing of the program, no kernel, no helper of
its tests.  Given the planes the harness drew (selectors, padded
inverted lists, codec parameters and document planes) and a block of
queries, it recomputes every stage the served rows depend on:

    dispatch   the K^C clusters of x·embᵀ in (score desc, index asc)
               order, and the ≤ K₂ᵀ unique query terms ranked by their
               average score (first occurrence first on ties)
    gather     the dispatched cluster and term lists' entries
    dedup      the set of distinct live documents (``n_cand``)
    score      the stage-1 codec's score, by the codec's own file
               ``codecs/<codec>.py`` (``stage1``)
    top-R′     the total order (score desc, id asc)
    refine     for ``refine:<codec>:<mult>``: the exact dot with the fp16
               rows of the top-R′ = mult·R, then the total-order top-R

``dtype`` is the precision of every product and sum (:mod:`.ops`).

A configuration names its reference module (``"reference"``, this one
by default), which models the ``ServeConfig`` settings in its
:data:`SERVE` and no others; a setting that changes what is served
(fusion, adaptive widths, filters) comes with a module of its own that
builds on this one.

Dispatch near a tie: the program scores clusters in float32, so where
the K-th and (K+1)-th float64 scores lie within ``tau`` of each other
either choice is a correct float32 dispatch.  :func:`search` then also
returns the second choice (the K-th cluster swapped for the (K+1)-th),
and the comparison accepts a served row that matches either.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch

from .ops import PAD, SENTINEL, TF32, acc, blocked, op, order_desc

__all__ = ["PAD", "SENTINEL", "SERVE", "TF32", "Planes", "Ranked",
           "candidates", "dispatch", "final_scores", "search", "select"]

#: the ``ServeConfig`` settings beyond the widths that this module models
SERVE: frozenset = frozenset()


@dataclasses.dataclass
class Planes:
    """The index as the harness drew it (every tensor on one device)."""
    codec: str                       # "opq", "sq8", "refine:sq8:4", ...
    cluster_emb: torch.Tensor        # (L, h) f32
    avg_scores: torch.Tensor         # (V,) f32
    cluster_entries: torch.Tensor    # (L, cap) i32, PAD padded
    term_entries: torch.Tensor       # (V, cap) i32, PAD padded
    codes: torch.Tensor              # (N, ·) u8 stage-1 codes
    params: dict                     # the stage-1 codec's parameter planes
    refine_emb: Optional[torch.Tensor] = None   # (N, h) f16, refine

    @property
    def base(self) -> str:
        """The stage-1 codec: ``sq8`` of ``refine:sq8:4``."""
        parts = self.codec.split(":")
        return parts[1] if parts[0] == "refine" else parts[0]

    @property
    def refine_mult(self) -> int:
        parts = self.codec.split(":")
        return int(parts[2]) if parts[0] == "refine" else 1


@dataclasses.dataclass
class Ranked:
    """One dispatch choice's result for a block of b queries."""
    n_cand: torch.Tensor      # (b,) i64 distinct live candidates
    cand: torch.Tensor        # (b, C) i64 ascending ids, SENTINEL padded
    top_ids: torch.Tensor     # (b, R) i64, PAD where fewer candidates
    top_scores: torch.Tensor  # (b, R) ``dtype``, -inf where PAD


def codec(name: str):
    """The reference's file of a stage-1 codec, ``codecs/<name>.py``."""
    return importlib.import_module(f"{__package__}.codecs.{name}")


def dispatch(p: Planes, qe: torch.Tensor, qt: torch.Tensor, kc: int,
             k2: int, dtype, tau: float):
    """(cluster ids (b, kc), near-tie mask (b,), second-choice ids
    (b, kc), term ids (b, k2) PAD padded)."""
    s = op(qe, dtype) @ op(p.cluster_emb, dtype).T
    order = order_desc(s)
    cl = order[:, :kc]
    ranked = torch.gather(s, 1, order[:, :kc + 1]).double()
    tie = (ranked[:, kc - 1] - ranked[:, kc]) < tau
    alt = torch.cat([order[:, :kc - 1], order[:, kc:kc + 1]], 1)
    # terms: unique query tokens, first occurrence kept
    qt = qt.long()
    srt, pos = torch.sort(qt, dim=-1, stable=True)
    first_sorted = torch.ones_like(srt, dtype=torch.bool)
    first_sorted[:, 1:] = srt[:, 1:] != srt[:, :-1]
    first = torch.empty_like(first_sorted).scatter_(1, pos, first_sorted)
    first &= qt != PAD
    sbar = p.avg_scores.to(acc(dtype))[qt.clamp(min=0)]
    sbar = torch.where(first, sbar, torch.full_like(sbar, -torch.inf))
    top = order_desc(sbar)[:, :k2]
    tm = torch.where(torch.isfinite(torch.gather(sbar, 1, top)),
                     torch.gather(qt, 1, top), PAD)
    if tm.shape[1] < k2:
        tm = torch.nn.functional.pad(tm, (0, k2 - tm.shape[1]), value=PAD)
    return cl, tie, alt, tm


def candidates(p: Planes, cl: torch.Tensor, tm: torch.Tensor):
    """The distinct live documents of each query: (cand (b, C) ascending
    with SENTINEL padding, n_cand (b,))."""
    rows = [p.cluster_entries[cl.long()].reshape(cl.shape[0], -1)]
    t = p.term_entries[tm.clamp(min=0).long()]
    rows.append(torch.where((tm >= 0)[:, :, None], t,
                            torch.full_like(t, PAD)).reshape(tm.shape[0], -1))
    ids = torch.cat(rows, 1).long()
    ids = torch.where(ids == PAD, SENTINEL, ids)
    ids = torch.sort(ids, dim=-1)[0]
    dup = torch.zeros_like(ids, dtype=torch.bool)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    ids = torch.where(dup, SENTINEL, ids)
    ids = torch.sort(ids, dim=-1)[0]
    return ids, (ids != SENTINEL).sum(-1)


def _exact(p: Planes, qe: torch.Tensor, ids: torch.Tensor, dtype,
           budget: int) -> torch.Tensor:
    def rows(q, i):
        r = p.refine_emb[i].to(acc(dtype))                  # (b, r, h)
        return torch.bmm(r, op(q, dtype)[:, :, None])[:, :, 0]
    return blocked(rows, qe, ids, p.refine_emb.shape[1], budget)


def stage1(p: Planes, qe: torch.Tensor, ids: torch.Tensor, dtype,
           budget: int) -> torch.Tensor:
    """The stage-1 codec's score of every (b, C) id, in blocks of about
    ``budget`` gathered elements; -inf at SENTINEL slots."""
    live = ids != SENTINEL
    s = codec(p.base).stage1(p, qe, torch.where(live, ids, 0), dtype,
                             budget)
    return torch.where(live, s, torch.full_like(s, -torch.inf))


def select(scores: torch.Tensor, ids: torch.Tensor, r: int):
    """Total-order (score desc, id asc) top-r of rows whose ids ascend;
    PAD / -inf beyond the live ones."""
    order = order_desc(scores)[:, :r]
    s = torch.gather(scores, 1, order)
    i = torch.gather(ids, 1, order)
    i = torch.where(torch.isfinite(s), i, PAD)
    if s.shape[1] < r:
        s = torch.nn.functional.pad(s, (0, r - s.shape[1]), value=-torch.inf)
        i = torch.nn.functional.pad(i, (0, r - i.shape[1]), value=PAD)
    return s, i


def _rank(p: Planes, qe, cand, n_cand, top_r: int, dtype,
          budget: int) -> Ranked:
    s1 = stage1(p, qe, cand, dtype, budget)
    s, i = select(s1, cand, top_r * p.refine_mult)
    if p.refine_emb is not None:
        ex = _exact(p, qe, i.clamp(min=0), dtype, budget)
        ex = torch.where(torch.isfinite(s), ex, torch.full_like(ex, -torch.inf))
        by_id = torch.sort(torch.where(i == PAD, SENTINEL, i), dim=-1)[1]
        s, i = select(torch.gather(ex, 1, by_id), torch.gather(i, 1, by_id),
                      top_r)
    return Ranked(n_cand=n_cand, cand=cand, top_ids=i, top_scores=s)


def search(p: Planes, qe: torch.Tensor, qt: torch.Tensor, cfg: dict, *,
           dtype=torch.float64, tau: float = 0.0, budget: int = 1 << 27):
    """Rank a block of queries at the configuration's widths (``kc``,
    ``k2``, ``top_r``): (primary :class:`Ranked`, near-tie mask (b,),
    second :class:`Ranked` of the near-tie queries or None).  ``budget``
    bounds the elements gathered at once (about 8 bytes each)."""
    kc, k2, top_r = cfg["kc"], cfg["k2"], cfg["top_r"]
    cl, tie, alt, tm = dispatch(p, qe, qt, kc, k2, dtype, tau)
    cand, n = candidates(p, cl, tm)
    first = _rank(p, qe, cand, n, top_r, dtype, budget)
    if not bool(tie.any()):
        return first, tie, None
    cand2, n2 = candidates(p, alt[tie], tm[tie])
    return first, tie, _rank(p, qe[tie], cand2, n2, top_r, dtype, budget)


def final_scores(p: Planes, qe: torch.Tensor, ranked: Ranked,
                 ids: torch.Tensor, budget: int = 1 << 27
                 ) -> torch.Tensor:
    """The last stage's float64 score of arbitrary (b, R) ids: the
    stage-1 score, or the exact dot under refine; -inf for an id that is
    not among the query's candidates, PAD included."""
    ids = ids.long()
    pos = torch.searchsorted(ranked.cand, ids.clamp(min=0))
    pos = pos.clamp(max=ranked.cand.shape[1] - 1)
    member = (torch.gather(ranked.cand, 1, pos) == ids) & (ids >= 0)
    safe = torch.where(member, ids, 0)
    if p.refine_emb is not None:
        s = _exact(p, qe, safe, torch.float64, budget)
    else:
        s = stage1(p, qe, safe, torch.float64, budget)
    return torch.where(member, s, torch.full_like(s, -torch.inf))

"""Reciprocal-rank fusion of the dense and sparse result lists (port of
``repro/core/exec/fusion.py``: ``FusionSpec``, ``sum_by_doc`` and
``rrf_contributions``; DESIGN.md §13).

A document at 0-based rank r of list ℓ with list weight w_ℓ contributes
``w_ℓ / (rrf_k + 1 + r)``; its fused score is the sum over the lists
that ranked it.  Dense gets ``weight``, sparse ``1 − weight``.

Both helpers match the reference bit for bit on the same inputs, which
takes two choices that plain torch idiom would get wrong:

  · ``w / t`` of a Python float by a tensor is a reciprocal multiply in
    torch, which differs from XLA's true division in the last bit for
    many ranks; :func:`rrf_contributions` divides a tensor by a tensor;
  · ``jax.ops.segment_sum`` adds each run of equal ids in slot order.
    ``index_add_``/``scatter_add_`` on the card add with atomics, in an
    order that changes from run to run, so :func:`sum_by_doc` adds the
    slots of each run in order with one masked add per run offset, as
    many as a bound on the longest run that the caller knows from the
    plane's structure (no read back to the host, so a CUDA graph can
    hold it).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.inverted_lists import PAD_DOC


@dataclasses.dataclass(frozen=True)
class FusionSpec:
    """How to weigh dense against sparse: ``weight`` ∈ [0, 1] (1.0 =
    pure dense, doc ids bit-identical to ``fusion=None``; 0.0 = pure
    sparse BM25) and the RRF rank damping ``rrf_k`` (60 in the
    literature).  Frozen and hashable, as the reference's."""
    weight: float = 0.5
    rrf_k: int = 60

    def __post_init__(self):
        if not 0.0 <= self.weight <= 1.0:
            raise ValueError(
                f"fusion weight must be in [0, 1], got {self.weight}")
        if self.rrf_k < 0:
            raise ValueError(f"rrf_k must be >= 0, got {self.rrf_k}")


def sum_by_doc(ids: torch.Tensor, vals: torch.Tensor,
               longest: Optional[int] = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row, per-unique-id sums: ``ids``/``vals`` (B, C), dead slots
    ``PAD_DOC`` with value 0, live values ≥ 0 → ``(sorted_ids, totals,
    first)``, all (B, C): ids stably sorted ascending per row, each
    slot's total over its id's run, and the first-occurrence mask.

    Each run is summed in slot order, ``((0 + v₀) + v₁) + …``, as the
    reference's ``segment_sum``: one masked add per run offset, for
    ``longest`` offsets, a bound on the longest run of a real id that
    the caller knows (the search path always passes one).  A pass beyond
    the true longest run adds a masked +0.0 to a non-negative sum, so
    any bound at or above it gives the same bits.  Without one the count
    is read from the data (one device→host sync).  A document sits in
    few probed lists, so that is a few passes over the plane, not one
    per slot.  The PAD run (PAD_DOC = −1 sorts first) may be longer; its
    values are 0, so its partial sum is its sum."""
    b, c = ids.shape
    sid, order = torch.sort(ids, dim=-1, stable=True)
    sval = torch.gather(vals, -1, order)
    first = torch.ones_like(sid, dtype=torch.bool)
    first[:, 1:] = sid[:, 1:] != sid[:, :-1]
    pos = torch.arange(c, device=ids.device).expand(b, c)
    start = torch.where(first, pos, 0).cummax(-1).values
    if longest is None:
        longest = int(torch.where(sid != PAD_DOC, pos - start + 1, 0).max())
    # run_sum[p] = ((0 + sval[p]) + sval[p+1]) + … over the slots of p's
    # run: exact at every run start, which is where totals are read
    run_sum = torch.zeros_like(sval)
    for t in range(min(longest, c)):
        same = sid[:, t:] == sid[:, :c - t]
        run_sum[:, :c - t] += torch.where(same, sval[:, t:], 0.0)
    return sid, torch.gather(run_sum, -1, start), first


def rrf_contributions(scores: torch.Tensor, weight: float, rrf_k: int
                      ) -> torch.Tensor:
    """Per-slot RRF mass of one ranked (B, R) list: ``weight / (rrf_k +
    1 + rank)`` where the slot holds a result (finite score), exactly
    0.0 at padding."""
    denom = torch.arange(scores.shape[-1], dtype=torch.float32,
                         device=scores.device) + (rrf_k + 1.0)
    mass = torch.full_like(denom, weight) / denom
    return torch.where(torch.isfinite(scores), mass.expand_as(scores),
                       torch.zeros_like(scores))

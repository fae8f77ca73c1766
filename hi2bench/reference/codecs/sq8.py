"""SQ8's dequantized dot ⟨x, lo + scale·code⟩, taken as ⟨x, lo⟩ +
⟨x·scale, code⟩.

Parameter planes: ``lo`` (h,) f32, ``scale`` (h,) f32; document codes
(N, h) u8."""
from __future__ import annotations

import torch

from ..ops import acc, blocked, op


def _scores(p, qe: torch.Tensor, ids: torch.Tensor, dtype) -> torch.Tensor:
    q = op(qe, dtype)
    bias = q @ op(p.params["lo"], dtype)
    qs = op(q * p.params["scale"].to(acc(dtype)), dtype)
    rows = p.codes[ids].to(acc(dtype))                      # (b, C, h)
    return torch.bmm(rows, qs[:, :, None])[:, :, 0] + bias[:, None]


def stage1(p, qe: torch.Tensor, ids: torch.Tensor, dtype, budget: int
           ) -> torch.Tensor:
    """Scores of (b, C) in-range ids."""
    return blocked(lambda q, i: _scores(p, q, i, dtype), qe, ids,
                   p.codes.shape[1], budget)

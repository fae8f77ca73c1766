"""Numerics that every stage of the plain reference shares: the
precision of products and sums, the total order, and blocking.

``dtype`` is the precision of every product and sum: float64 for the
reference; :data:`TF32` for the control that stands in the program's
place, the float32 search with every matrix product's operands rounded
to TF32's 10-bit mantissa (the step below the float32 that the
configurations state, with TF32 off), sums and the rest in float32.
"""
from __future__ import annotations

import torch

PAD = -1
#: the control's precision: float32, matrix products on TF32 operands
TF32 = "tf32"
#: sorts after every document id in a candidate row
SENTINEL = torch.iinfo(torch.int64).max


def acc(dtype) -> torch.dtype:
    """The dtype sums and elementwise work run in."""
    return torch.float32 if dtype == TF32 else dtype


def op(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` as an operand of a matrix product at ``dtype``: for
    :data:`TF32` a float32 rounded to the nearest 10-bit mantissa."""
    if dtype != TF32:
        return x.to(dtype)
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def order_desc(scores: torch.Tensor) -> torch.Tensor:
    """Positions in (score desc, position asc) order."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1]


def blocked(fn, rows: torch.Tensor, ids: torch.Tensor, width: int,
            budget: int) -> torch.Tensor:
    """``fn(rows[i:j], ids[i:j])`` over blocks of queries that gather at
    most about ``budget`` elements of ``width`` each a block."""
    per = max(1, budget // max(1, ids.shape[1] * width))
    return torch.cat([fn(rows[i:i + per], ids[i:i + per])
                      for i in range(0, ids.shape[0], per)])

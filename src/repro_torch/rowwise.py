"""Query-side products whose rows do not depend on the batch size (no
reference counterpart: XLA keeps one reduction order per row for every
batch of two or more, DESIGN.md §10; cuBLAS and the CPU's BLAS do not).

cuBLAS picks its GEMM algorithm, and with it the order of each dot
product's adds, from the problem's shape: on an H100 the OPQ rotation
``q @ R`` of 1..128 queries gives other bits than the same rows of a
256-query product, and so do SQ8's ``q @ lo``, refine's and flat's
batched dots.  The serving runtime's bitwise contract (a query's rows
from a bucket of b equal its rows from ``Server.query``'s ``max_batch``
pad) needs every such product at one shape, so :func:`fixed_rows` runs
it over blocks of exactly ``rows`` rows, the last one zero-padded: a
row's result is then a function of that row alone.  At 256 queries × h
768 the padded OPQ rotation is 0.3 GFLOP.
"""
from __future__ import annotations

from typing import Callable

import torch

#: rows of every query-side product: ``serve_msmarco``'s max_batch, so a
#: 256-query batch runs each product once, unpadded
ROWS = 256


def fixed_rows(fn: Callable[..., torch.Tensor], *xs: torch.Tensor,
               rows: int = ROWS) -> torch.Tensor:
    """``fn(*xs)`` for a row-wise ``fn`` (row i of its output depends on
    row i of each input only), computed over blocks of exactly ``rows``
    leading rows, the last block zero-padded: each row's bits do not
    depend on how many rows ``xs`` hold."""
    b = xs[0].shape[0]
    pad = -b % rows
    if pad:
        xs = tuple(torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1)
                                           + (0, pad)) for x in xs)
    outs = [fn(*(x[i:i + rows] for x in xs)) for i in range(0, b + pad, rows)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out[:b]

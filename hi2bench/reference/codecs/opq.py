"""OPQ's asymmetric distance ⟨xR, ĉ⟩: the query rotated by R, a table of
its dot with every codeword of each of the m sub-spaces, and a
document's score the sum of its m codes' entries.

Parameter planes: ``rotation`` (h, h) f32, ``codewords`` (m, k, h/m)
f32; document codes (N, m) u8."""
from __future__ import annotations

import torch

from ..ops import blocked, op


def _lut(p, qe: torch.Tensor, dtype) -> torch.Tensor:
    cw = p.params["codewords"]
    m, k, d = cw.shape
    xr = op(qe, dtype) @ op(p.params["rotation"], dtype)
    return torch.einsum("bmd,mkd->bmk", op(xr, dtype).reshape(-1, m, d),
                        op(cw, dtype))


def _sums(lut: torch.Tensor, codes: torch.Tensor, ids: torch.Tensor
          ) -> torch.Tensor:
    """Σ_j lut[b, j, codes[ids[b, c], j]] for (b, C) ids in range."""
    b, m, k = lut.shape
    c = codes[ids].long()                                   # (b, C, m)
    c += torch.arange(m, device=c.device) * k
    return torch.gather(lut.reshape(b, 1, m * k).expand(-1, c.shape[1], -1),
                        2, c).sum(-1)


def stage1(p, qe: torch.Tensor, ids: torch.Tensor, dtype, budget: int
           ) -> torch.Tensor:
    """Scores of (b, C) in-range ids."""
    lut = _lut(p, qe, dtype)
    rows = torch.arange(qe.shape[0], device=qe.device)
    return blocked(lambda r, i: _sums(lut[r], p.codes, i), rows, ids,
                   p.codes.shape[1], budget)

"""SQ8 planes, the recipe of the port's ``synth_msmarco.py``: per-dimension
ranges (lo, scale) trained on the fp16 rows, and each row's codes
encoded with them (``ROWS`` True: the rows are drawn first)."""
from __future__ import annotations

import torch

ROWS = True
#: rows a block when fp16 rows are read or encoded
ROW_BLOCK = 1 << 18


def encode(params: dict, rows: torch.Tensor) -> torch.Tensor:
    lo, scale = params["lo"], params["scale"]
    return torch.cat([
        torch.clamp(torch.round((b.float() - lo) / scale), 0, 255).to(
            torch.uint8) for b in rows.split(ROW_BLOCK)])


def draw(cfg: dict, g: torch.Generator, dev: torch.device, n: int,
         rows: torch.Tensor) -> tuple:
    """(codes (n, h) u8, parameter planes) of ``rows``; a constant
    dimension gets scale 1."""
    lo = hi = None
    for blk in rows.split(ROW_BLOCK):
        b = blk.float()
        lo = b.amin(0) if lo is None else torch.minimum(lo, b.amin(0))
        hi = b.amax(0) if hi is None else torch.maximum(hi, b.amax(0))
    span = hi - lo
    params = {"lo": lo, "scale": torch.where(
        span > 0, span / torch.full_like(span, 255.0), 1.0)}
    return encode(params, rows), params


def index_params(params: dict):
    """The program's codec parameters of the planes."""
    return {"lo": params["lo"], "scale": params["scale"]}

"""OPQ planes, the recipe of the port's ``synth_msmarco.py``: an
orthogonal rotation (QR of a Gaussian), N(0, 1) codewords and uniform
codes, of the configuration's ``pq_m`` sub-spaces and ``pq_k`` codewords
each.  The codes are drawn, not encoded from rows (``ROWS`` False)."""
from __future__ import annotations

import torch

ROWS = False


def draw(cfg: dict, g: torch.Generator, dev: torch.device, n: int,
         rows=None) -> tuple:
    """(codes (n, m) u8, parameter planes)."""
    h, m, k = cfg["hidden"], cfg["pq_m"], cfg["pq_k"]
    rot = torch.linalg.qr(torch.randn((h, h), generator=g, device=dev))[0]
    params = {"rotation": rot.contiguous(),
              "codewords": torch.randn((m, k, h // m), generator=g,
                                       device=dev)}
    codes = torch.randint(0, k, (n, m), generator=g, device=dev,
                          dtype=torch.uint8)
    return codes, params


def index_params(params: dict):
    """The program's codec parameters of the planes."""
    from repro_torch.core.codecs.pq import OPQCodebook, PQCodebook
    return OPQCodebook(rotation=params["rotation"],
                       codebook=PQCodebook(params["codewords"]))

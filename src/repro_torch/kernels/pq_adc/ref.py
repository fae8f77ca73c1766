"""Plain PyTorch versions of the two ADC kernels (port of
``repro/kernels/pq_adc/ref.py``).  The wrappers take them for CPU
tensors; on the card only the checks and the kernel benchmark call
them, as the kernels' yardsticks."""
from __future__ import annotations

import torch


def pq_adc(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut (B, m, k); codes (B, C, m) int → (B, C) f32, as one flat
    gather over the (m·k) LUT row of each query."""
    b, m, k = lut.shape
    c = codes.shape[1]
    idx = (torch.arange(m, device=lut.device) * k + codes.long())
    gathered = torch.gather(lut.reshape(b, m * k), 1, idx.reshape(b, c * m))
    return gathered.reshape(b, c, m).sum(dim=-1)


def pq_adc_fused(lut: torch.Tensor, codes_plane: torch.Tensor,
                 ids: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """Gather rows, score, mask: lut (B, m, k); codes_plane (N, m);
    ids (B, C) int; live (B, C) bool → (B, C) f32, ``-inf`` where not
    live.  Builds the (B, C, m) codes the kernel never materializes."""
    ids = ids.long().clamp(0, codes_plane.shape[0] - 1)
    scores = pq_adc(lut, codes_plane[ids])
    return torch.where(live.bool(), scores,
                       torch.full_like(scores, -torch.inf))

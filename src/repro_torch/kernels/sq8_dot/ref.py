"""Plain PyTorch version of the fused SQ8 gather + dot kernel (port of
``repro/kernels/sq8_dot/ref.py``).  The wrapper takes it for CPU
tensors; on the card only the smoke check calls it, as the kernel's
yardstick."""
from __future__ import annotations

import torch


def sq8_dot_fused(q_scaled: torch.Tensor, codes_plane: torch.Tensor,
                  ids: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """q_scaled (B, h); codes_plane (N, h) uint8; ids, live (B, C) →
    (B, C) f32 bias-free scores, ``-inf`` where not live.  Builds the
    (B, C, h) rows the kernel never materializes."""
    ids = ids.long().clamp(0, codes_plane.shape[0] - 1)
    rows = codes_plane[ids].float()                         # (B, C, h)
    scores = torch.einsum("bh,bch->bc", q_scaled.float(), rows)
    return torch.where(live.bool(), scores,
                       torch.full_like(scores, -torch.inf))

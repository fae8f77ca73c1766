"""Plain PyTorch attention (port of
``repro/kernels/flash_attention/ref.py``: ``attention`` and
``attention_chunked``), with causal and sliding-window masks and GQA.
The wrapper takes :func:`flash_attention` for CPU tensors, and its
backward differentiates :func:`attention` on every device (the
reference's recompute); on the card the smoke check also calls it.

The reference's conventions hold: masked scores are ``NEG_INF = -1e30``
(finite, not ``-inf``); masks go by absolute position; query head h
reads kv head ``h // group``; a query row with no visible key (possible
under a non-causal window with Sq ≠ Sk) outputs zeros and its ``lse``
is ``NEG_INF``.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    mask = torch.ones((q_pos.shape[0], k_pos.shape[1]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
        if not causal:
            mask &= (k_pos - q_pos) < window
    return mask


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    q_chunk: Optional[int] = None, q_offset: int = 0,
                    k_offset: int = 0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The function of the flash kernel: q (B, Hq, Sq, d), k/v
    (B, Hkv, Sk, d) → (out (B, Hq, Sq, d) in q's dtype, lse (B, Hq, Sq)
    f32), computed in f32 ``q_chunk`` query rows at a time (None: all at
    once), so the live score plane is (B, Hq, q_chunk, Sk).  Query row i
    sits at absolute position ``q_offset + i`` and key j at ``k_offset +
    j`` (slices of longer sequences)."""
    b, hq, sq, d = q.shape
    group = hq // k.shape[1]
    sk = k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    # group 1 reads k and v as they are: no copy, and no index
    # backward (atomic adds on CUDA) when the attention is differentiated
    kg = (k if group == 1 else k.repeat_interleave(group, dim=1)).float()
    vg = (v if group == 1 else v.repeat_interleave(group, dim=1)).float()
    k_pos = k_offset + torch.arange(sk, device=q.device)[None, :]
    step = sq if q_chunk is None else q_chunk
    outs, lses = [], []
    for q0 in range(0, sq, max(step, 1)):
        qi = q[:, :, q0:q0 + step]
        s = torch.einsum("bhqd,bhkd->bhqk", qi.float() * scale, kg)
        q_pos = (q_offset + q0
                 + torch.arange(qi.shape[2], device=q.device)[:, None])
        mask = _mask(q_pos, k_pos, causal, window)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        live = mask.any(dim=-1)[:, None]                 # (q, 1)
        p = torch.where(live, p, torch.zeros_like(p))
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p, vg).to(q.dtype))
        lses.append(torch.where(live[:, 0], torch.logsumexp(s, dim=-1),
                                torch.full_like(s[..., 0], NEG_INF)))
    return torch.cat(outs, dim=2), torch.cat(lses, dim=2)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              scale: Optional[float] = None) -> torch.Tensor:
    """Dense attention: the whole (B, Hq, Sq, Sk) score plane at once."""
    return flash_attention(q, k, v, causal, window, scale)[0]


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      scale: Optional[float] = None,
                      q_chunk: int = 512) -> torch.Tensor:
    """The same function with the live score plane bounded to
    (B, Hq, q_chunk, Sk).  The reference falls back to dense attention
    when ``q_chunk`` does not divide Sq; each query row's arithmetic is
    the same either way, so here the last chunk is simply shorter."""
    return flash_attention(q, k, v, causal, window, scale, q_chunk)[0]

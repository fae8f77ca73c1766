"""Common neural layers as plain functions over parameter dicts (port of
``repro/models/layers.py``: ``dense``, ``embedding_lookup``,
``rmsnorm``, ``rope_freqs`` and ``apply_rope``; ``layernorm`` and
``softmax_xent`` come with training).

Parameters are nested dicts of tensors in the reference's layout
(``{"w": (d_in, d_out)}``, ``{"table": (V, d)}``, ``{"scale": (d,)}``),
so a reference checkpoint maps onto them leaf for leaf
(:mod:`repro_torch.checkpoint.checkpoint`).
"""
from __future__ import annotations

import torch


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x @ w in x's dtype.  The weight is cast to the activation's dtype
    (master weights may be f32 under bf16 activations); the product
    accumulates in f32 and is cast back to x's dtype."""
    w = params["w"]
    if x.is_floating_point() and w.dtype != x.dtype:
        w = w.to(x.dtype)
    return torch.matmul(x, w).to(x.dtype)


def embedding_lookup(params: dict, ids: torch.Tensor) -> torch.Tensor:
    """Rows of the table; ``PAD_ID = -1`` (any negative id) reads row 0."""
    return params["table"][ids.clamp(min=0).long()]


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMS normalisation in f32, scaled, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def rope_freqs(d_head: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """(d_head/2,) inverse frequencies θ^(-2i/d)."""
    exponent = torch.arange(0, d_head, 2, dtype=torch.float32,
                            device=device) / d_head
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x (..., S, d_head); positions broadcastable to (..., S).

    The half-split convention of the reference (``jnp.split(x, 2)``): the
    first half of the features rotates against the second half, not
    interleaved pairs."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)
    angles = positions[..., None].float() * freqs       # (..., S, d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)

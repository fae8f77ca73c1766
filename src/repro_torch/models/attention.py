"""GQA attention, full-sequence forward (port of
``repro/models/attention.py``: ``init``, ``_project_qkv`` and
``forward``; the
KV-cache decode path, ``KVCache`` and ``decode_step``, comes with the
LM modes).

Attention itself is :func:`repro_torch.kernels.flash_attention.ops.
flash_attention` for every device: on a CUDA tensor the hand-written
kernel, on a CPU tensor its plain version.  The reference's two routes
(``use_flash`` → the Pallas kernel, else the chunked XLA path) compute
the same function (attention.py:67-74); the port has no routing switch,
so ``use_flash`` is accepted for parity with the reference's signature
and routes nothing.  Under autograd the kernel's backward is the
reference's: a recompute through the plain version
(:mod:`repro_torch.kernels.flash_attention.ops`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers


def init(generator: torch.Generator, d_model: int, n_heads: int,
         n_kv_heads: int, d_head: int, dtype=torch.float32) -> dict:
    """wq, wk, wv, wo at ``layers.dense_init``'s scale, drawn in that
    order from ``generator``."""
    return {
        "wq": layers.dense_init(generator, d_model, n_heads * d_head, dtype),
        "wk": layers.dense_init(generator, d_model, n_kv_heads * d_head,
                                dtype),
        "wv": layers.dense_init(generator, d_model, n_kv_heads * d_head,
                                dtype),
        "wo": layers.dense_init(generator, n_heads * d_head, d_model, dtype),
    }


def _project_qkv(params: dict, x: torch.Tensor, n_heads: int,
                 n_kv_heads: int, d_head: int, positions: torch.Tensor,
                 rope_theta: float):
    """(B, S, D) → q (B, Hq, S, dh), k and v (B, Hkv, S, dh).  q and k
    are rotated when ``rope_theta > 0``; v stays a (B, H, S, dh) view of
    the (B, S, H, dh) projection."""
    b, s, _ = x.shape
    q = layers.dense(params["wq"], x).reshape(b, s, n_heads, d_head)
    k = layers.dense(params["wk"], x).reshape(b, s, n_kv_heads, d_head)
    v = layers.dense(params["wv"], x).reshape(b, s, n_kv_heads, d_head)
    q, k = q.transpose(1, 2), k.transpose(1, 2)
    if rope_theta > 0:
        q = layers.apply_rope(q, positions[:, None], rope_theta)
        k = layers.apply_rope(k, positions[:, None], rope_theta)
    return q, k, v.transpose(1, 2)


def forward(params: dict, x: torch.Tensor, *, n_heads: int,
            n_kv_heads: int, d_head: int, causal: bool = True,
            window: int = 0, rope_theta: float = 10000.0,
            use_flash: bool = False,
            positions: Optional[torch.Tensor] = None,
            return_kv: bool = False):
    """Full-sequence attention, x (B, S, D) → (B, S, D)[, (k, v)].
    ``use_flash`` does not route (see the module docstring)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, d_head,
                           positions, rope_theta)
    out, _ = fa_ops.flash_attention(q, k, v, causal, window, None)
    out = out.transpose(1, 2).reshape(b, s, n_heads * d_head)
    out = layers.dense(params["wo"], out)
    if return_kv:
        return out, (k, v)
    return out

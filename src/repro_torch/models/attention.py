"""GQA attention: full-sequence forward (train / prefill) and KV-cache
decode with sliding-window support through a rolling cache (port of
``repro/models/attention.py``: ``init``, ``_project_qkv``, ``forward``,
``KVCache``, ``init_cache``, ``cache_capacity`` and ``decode_step``).

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

from typing import NamedTuple, Optional

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


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor          # (B, n_kv_heads, C, d_head)
    v: torch.Tensor          # (B, n_kv_heads, C, d_head)
    cache_pos: torch.Tensor  # (C,) int32: the position in each slot, -1 empty


def init_cache(batch: int, n_kv_heads: int, capacity: int, d_head: int,
               dtype=torch.bfloat16, device=None) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, n_kv_heads, capacity, d_head), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, n_kv_heads, capacity, d_head), dtype=dtype,
                      device=device),
        cache_pos=torch.full((capacity,), -1, dtype=torch.int32,
                             device=device))


def cache_capacity(seq_len: int, window: int) -> int:
    """A windowed model only ever needs the last ``window`` positions."""
    return min(seq_len, window) if window > 0 else seq_len


def decode_step(params: dict, cache: KVCache, x_new: torch.Tensor, pos, *,
                n_heads: int, n_kv_heads: int, d_head: int, window: int = 0,
                rope_theta: float = 10000.0
                ) -> tuple[torch.Tensor, KVCache]:
    """One decode step, x_new (B, 1, D) at absolute position ``pos`` (a
    0-dim tensor on x_new's device, or an int) → (out (B, 1, D), cache).

    The cache is consumed: the new k, v and position go into slot
    ``pos % C`` in place (the reference's decode cell donates its
    caches), and the returned cache holds the same tensors.  Nothing is
    read back to the host.  A slot is attended when it is filled, holds
    a position <= ``pos`` and, under a window, one > ``pos - window``.
    The scores and the softmax are f32 (bf16 q and cache multiplied with
    an f32 result); the probabilities are rounded to the cache's dtype
    before the PV product, which accumulates in f32."""
    b = x_new.shape[0]
    group = n_heads // n_kv_heads
    capacity = cache.k.shape[2]
    pos = torch.as_tensor(pos, device=x_new.device)
    q, k_new, v_new = _project_qkv(params, x_new, n_heads, n_kv_heads,
                                   d_head, pos.reshape(1, 1).expand(b, 1),
                                   rope_theta)
    slot = torch.remainder(pos, capacity).reshape(1).long()
    cache.k.index_copy_(2, slot, k_new.to(cache.k.dtype))
    cache.v.index_copy_(2, slot, v_new.to(cache.v.dtype))
    cache.cache_pos.index_copy_(0, slot, pos.reshape(1).to(torch.int32))

    # grouped-query scoring without repeating the cache: query head
    # kv * group + g reads kv head kv
    qg = q.reshape(b, n_kv_heads, group, d_head).to(cache.k.dtype)
    s = layers.matmul_f32(qg, cache.k.transpose(-1, -2)) * (d_head ** -0.5)
    valid = (cache.cache_pos >= 0) & (cache.cache_pos <= pos)
    if window > 0:
        valid &= cache.cache_pos > pos - window
    s = s.masked_fill(~valid, -1e30)
    p = torch.softmax(s, dim=-1)
    out = layers.matmul_f32(p.to(cache.v.dtype), cache.v)
    out = out.reshape(b, 1, n_heads * d_head).to(x_new.dtype)
    return layers.dense(params["wo"], out), cache

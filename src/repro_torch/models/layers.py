"""Common neural layers as plain functions over parameter dicts (port of
``repro/models/layers.py``: ``dense_init``, ``dense``,
``embedding_init``, ``embedding_lookup``, ``rmsnorm_init``,
``rmsnorm``, ``layernorm_init``, ``layernorm``, ``rope_freqs``,
``apply_rope`` and ``softmax_xent``), and :func:`matmul_f32`, the
reference's ``jnp.matmul(..., preferred_element_type=jnp.float32)``
kept in float32.

Parameters are nested dicts of tensors in the reference's layout
(``{"w": (d_in, d_out)}``, ``{"table": (V, d)}``, ``{"scale": (d,)}``),
so a reference checkpoint maps onto them leaf for leaf
(:mod:`repro_torch.checkpoint.checkpoint`).  The ``*_init`` functions
draw from an explicit ``torch.Generator`` on the device where the
parameters are made; they cannot draw ``jax.random``'s numbers, only
its distributions.

Row lookups (:func:`take_rows`) sum their gradient rows in row order on
every device, so a training step on the card is repeatable bit for bit
(CUDA's own indexing backward adds duplicate rows with atomics).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.kmeans import segment_sum


def _normal(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: Optional[float] = None) -> dict:
    """{"w": (d_in, d_out)} drawn from N(0, scale²), scale d_in^-½ by
    default."""
    if scale is None:
        scale = d_in ** -0.5
    return {"w": (_normal(generator, (d_in, d_out)) * scale).to(dtype)}


def embedding_init(generator: torch.Generator, n_rows: int, dim: int,
                   dtype=torch.float32, scale: float = 0.02) -> dict:
    return {"table": (_normal(generator, (n_rows, dim)) * scale).to(dtype)}


def rmsnorm_init(dim: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


class _TakeRows(torch.autograd.Function):
    """``table[ids]`` whose backward sums the gradient rows of each table
    row in row order (:func:`repro_torch.core.kmeans.segment_sum`)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        return table[ids]

    @staticmethod
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        rows = grad.reshape((-1,) + tuple(grad.shape[ids.dim():]))
        sums, _ = segment_sum(rows, ids.reshape(-1), ctx.n_rows)
        return sums, None


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` (any shape, in [0, n_rows)) of ``table``, with a
    gradient that is the same bits on every run."""
    return _TakeRows.apply(table, ids.long())


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x @ w in x's dtype.  The weight is cast to the activation's dtype
    (master weights may be f32 under bf16 activations); the product
    accumulates in f32 and is cast back to x's dtype."""
    w = params["w"]
    if x.is_floating_point() and w.dtype != x.dtype:
        w = w.to(x.dtype)
    return torch.matmul(x, w).to(x.dtype)


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, K) @ b (K, N) or (..., K, N) of one low-precision dtype,
    accumulated and returned in float32 with no rounding in between: on
    the card cuBLAS's bf16 GEMM with an f32 output (``out_dtype``), on
    the CPU the product of the operands widened to f32 (exact)."""
    if a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    m, k = a.shape[-2:]
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, k), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    out = torch.bmm(a.reshape(-1, m, k), b.reshape(-1, k, b.shape[-1]),
                    out_dtype=torch.float32)
    return out.reshape(*a.shape[:-1], b.shape[-1])


class _MatmulF32(torch.autograd.Function):
    """:func:`_product_f32` whose backward takes the f32 cotangent to the
    operands' dtype and multiplies there (f32 accumulation, one rounding
    of each gradient to that dtype, which the reference rounds to as
    well).  The reference's CPU transpose multiplies the f32 cotangent
    unrounded; a TPU at default precision rounds it to bf16, as here."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _product_f32(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        grad = grad.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(grad, b.transpose(-1, -2))
        if ctx.needs_input_grad[1]:
            if b.dim() == 2:
                gb = torch.matmul(a.reshape(-1, a.shape[-1]).t(),
                                  grad.reshape(-1, grad.shape[-1]))
            else:
                gb = torch.matmul(a.transpose(-1, -2), grad)
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float32 from operands of a's dtype (b (K, N), or
    batched like a): the reference's ``jnp.matmul(a, b,
    preferred_element_type=jnp.float32)``.  From bf16 operands the
    product is accumulated in f32 and never rounded to bf16 — a bf16
    ``torch.matmul`` followed by ``.float()`` would round it once.
    Differentiable in both operands."""
    if b.dtype != a.dtype:
        raise ValueError(f"operands of {a.dtype} and {b.dtype}")
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    return _MatmulF32.apply(a, b)


def embedding_lookup(params: dict, ids: torch.Tensor) -> torch.Tensor:
    """Rows of the table; ``PAD_ID = -1`` (any negative id) reads row 0."""
    return take_rows(params["table"], ids.clamp(min=0))


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMS normalisation in f32, scaled, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_init(dim: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-6
              ) -> torch.Tensor:
    """Layer normalisation in f32 (``eps`` under the root, as the
    reference), scaled and shifted, cast back to x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float()
            + params["bias"].float()).to(x.dtype)


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


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 ignore_id: int = -1) -> torch.Tensor:
    """Mean cross entropy of ``logits`` (..., C) at ``labels`` (...);
    positions labelled ``ignore_id`` are skipped.  The sum divides by a
    tensor, the count: CUDA would turn a Python-scalar divisor into a
    multiply by its reciprocal, other bits than the CPU's."""
    mask = labels != ignore_id
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long().clamp(min=0)[..., None])[..., 0]
    return -(ll * mask).sum() / mask.sum().clamp(min=1)

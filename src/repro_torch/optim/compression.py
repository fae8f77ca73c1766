"""int8 gradient compression with error feedback (port of
``repro/optim/compression.py``: ``CompressedLeaf``, ``compress_leaf``,
``decompress_leaf``, ``ef_init``, ``compress_with_ef`` and
``decompress``).

Cross-pod gradient traffic is the scaling bottleneck of the pod axis
(DESIGN.md §5).  Per-tensor symmetric int8 quantization cuts it 4×
against f32; the quantization error is fed back into the next step's
gradient (error feedback), which keeps SGD/Adam convergence unbiased in
the long run (Karimireddy et al., 2019).

Elementwise ops and one max, in the reference's order: scale
``max(amax / 127, 1e-12)``, ``torch.round`` (half to even, as
``jnp.round``), clip to ±127, cast to int8; on the CPU the bits equal
the reference's, and on the card the CPU's.  Trees are the port's (:mod:`repro_torch.tree`); a
compressed tree holds a :class:`CompressedLeaf` where the gradient tree
holds a tensor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import tree as tree_mod


class CompressedLeaf(NamedTuple):
    q: torch.Tensor        # int8 payload
    scale: torch.Tensor    # () f32


def compress_leaf(g: torch.Tensor) -> CompressedLeaf:
    g = g.float()
    # a tensor divisor: CUDA multiplies by the reciprocal of a Python
    # scalar divisor, which rounds otherwise than the division
    scale = torch.clamp(g.abs().max() / torch.full((), 127.0,
                                                   device=g.device),
                        min=1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return CompressedLeaf(q=q, scale=scale)


def decompress_leaf(c: CompressedLeaf) -> torch.Tensor:
    return c.q.float() * c.scale


def ef_init(params):
    """Zero error-feedback state, f32, shaped and placed like
    ``params``."""
    return tree_mod.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)


def compress_with_ef(grads, ef) -> tuple:
    """Returns (compressed grads tree, new error-feedback state)."""
    comp, new_ef = [], []
    for g, e in zip(tree_mod.leaves(grads), tree_mod.leaves(ef)):
        corrected = g.float() + e
        c = compress_leaf(corrected)
        comp.append(c)
        new_ef.append(corrected - decompress_leaf(c))
    return (tree_mod.unflatten(grads, comp),
            tree_mod.unflatten(ef, new_ef))


def decompress(comp):
    """The f32 tree of a compressed tree."""
    if isinstance(comp, CompressedLeaf):
        return decompress_leaf(comp)
    if isinstance(comp, tuple) and hasattr(comp, "_fields"):
        return type(comp)(*(decompress(x) for x in comp))
    if isinstance(comp, dict):
        return {k: decompress(v) for k, v in comp.items()}
    return comp

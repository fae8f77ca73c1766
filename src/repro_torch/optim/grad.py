"""Gradient tooling (port of ``repro/optim/grad.py``: global-norm
clipping and microbatch accumulation), and :func:`value_and_grad`, the
counterpart of ``jax.value_and_grad`` over a tree of parameters.

Sums over the leaves run in the reference's leaf order
(:func:`repro_torch.tree.leaves`).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree as tree_mod


def value_and_grad(fn: Callable, params, *args, has_aux: bool = False):
    """``fn(params, *args)`` and its gradient with respect to every leaf
    of ``params`` → (value, grads), or ((value, aux), grads) with
    ``has_aux``: the value (and aux) detached, the gradients a tree of
    ``params``' structure.  A leaf the value does not depend on gets a
    zero gradient, as under JAX (torch reports ``None`` for it)."""
    live = [p.detach().requires_grad_(True) for p in tree_mod.leaves(params)]
    with torch.enable_grad():
        out = fn(tree_mod.unflatten(params, live), *args)
        value = out[0] if has_aux else out
        grads = torch.autograd.grad(value, live, allow_unused=True)
    grads = tree_mod.unflatten(params, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(live, grads)])
    if has_aux:
        aux = {k: v.detach() for k, v in out[1].items()}
        return (value.detach(), aux), grads
    return value.detach(), grads


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_mod.leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_mod.map(lambda g: (g * scale).to(g.dtype), tree), norm


@torch.no_grad()
def clip_by_global_norm_(tree, max_norm: float):
    """:func:`clip_by_global_norm` in place (the same bits): every leaf
    of ``tree`` is scaled where it lies → (tree, norm)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    for g in tree_mod.leaves(tree):
        g.mul_(scale)
    return tree, norm


def accumulate_grads(loss_fn: Callable, params, microbatches, *args):
    """Sequential gradient accumulation over a microbatch tree whose
    leaves have a leading microbatch axis → (mean loss, mean grads)."""
    n = tree_mod.leaves(microbatches)[0].shape[0]
    acc = tree_mod.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
    total = 0.0
    for i in range(n):
        mb = tree_mod.map(lambda x: x[i], microbatches)
        loss, g = value_and_grad(loss_fn, params, mb, *args)
        acc = tree_mod.map(torch.add, acc, g)
        total = total + loss
    inv = 1.0 / n
    return total * inv, tree_mod.map(lambda g: g * inv, acc)

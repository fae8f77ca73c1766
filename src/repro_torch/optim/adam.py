"""AdamW over trees of tensors (port of ``repro/optim/adam.py``).

Used by HI²_sup distillation (cluster embeddings + term-scorer encoder,
paper §4.3).  The moments are float32 trees of the parameters'
structure, and ``step`` is a 0-dim int32 tensor, so ``{"params",
"opt"}`` checkpoints hold the reference's leaves, in its order, with
its dtypes.  The bias corrections ``1 - b**step`` are float32, as in the
reference.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Union

import torch

from repro_torch import tree as tree_mod


class AdamConfig(NamedTuple):
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0


class AdamState(NamedTuple):
    step: torch.Tensor   # () i32
    mu: Any              # first moment
    nu: Any              # second moment


def adam_init(params) -> AdamState:
    zeros = tree_mod.map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
    device = tree_mod.leaves(params)[0].device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     mu=zeros, nu=tree_mod.map(torch.clone, zeros))


def _leaf_rules(state: AdamState, config: AdamConfig,
                lr_scale: Union[torch.Tensor, float]):
    """The step count and the per-leaf expressions of one AdamW step:
    (step, moment1(m, g), moment2(v, g), update(p, m, v))."""
    step = state.step + 1
    b1, b2 = config.b1, config.b2
    stepf = step.float()
    bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32,
                             device=step.device) ** stepf
    bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32,
                             device=step.device) ** stepf
    lr = config.lr * lr_scale

    # each expression as the reference writes it, evaluated in place on
    # its own temporaries (the same roundings), so a 6.66 GB leaf (DLRM's
    # tables) holds two temporaries at a time, not five
    def moment1(m, g):
        return torch.mul(m, b1).add_(g.float() * (1 - b1))

    def moment2(v, g):
        g = g.float()
        return torch.mul(v, b2).add_((g * (1 - b2)).mul_(g))

    def upd(p, m, v):
        denom = torch.div(v, bc2).sqrt_().add_(config.eps)
        delta = torch.div(m, bc1).div_(denom)
        del denom
        if config.weight_decay:
            delta.add_(config.weight_decay * p.float())
        return (p.float() - delta.mul_(lr)).to(p.dtype)

    return step, moment1, moment2, upd


@torch.no_grad()
def adam_update(grads, state: AdamState, params, config: AdamConfig,
                lr_scale: Union[torch.Tensor, float] = 1.0
                ) -> tuple[Any, AdamState]:
    """One AdamW step.  ``lr_scale`` multiplies the base lr (schedules)."""
    step, moment1, moment2, upd = _leaf_rules(state, config, lr_scale)
    mu = tree_mod.map(moment1, state.mu, grads)
    nu = tree_mod.map(moment2, state.nu, grads)
    new_params = tree_mod.map(upd, params, mu, nu)
    return new_params, AdamState(step=step, mu=mu, nu=nu)


@torch.no_grad()
def adam_update_(grads, state: AdamState, params, config: AdamConfig,
                 lr_scale: Union[torch.Tensor, float] = 1.0
                 ) -> tuple[Any, AdamState]:
    """:func:`adam_update` in place, the same bits: each leaf's moments
    and parameter are computed as there and written into ``state``'s and
    ``params``' own tensors, leaf by leaf, so a step holds a few
    temporaries of one leaf beyond the trees, not a second copy of them.
    ``params`` and ``state`` are consumed (the reference's training cell
    donates both); the returned trees hold the same tensors."""
    step, moment1, moment2, upd = _leaf_rules(state, config, lr_scale)
    for p, g, m, v in zip(*(tree_mod.leaves(t) for t in
                            (params, grads, state.mu, state.nu))):
        m.copy_(moment1(m, g))
        v.copy_(moment2(v, g))
        p.copy_(upd(p, m, v))
    return params, AdamState(step=step, mu=state.mu, nu=state.nu)

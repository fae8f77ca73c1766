"""Learning-rate schedules as pure ``step -> scale`` functions (port of
``repro/optim/schedule.py``).  ``step`` is a Python int or an integer
tensor; the scale is a 0-dim float32 tensor, computed in float32 as the
reference computes it."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant():
    return lambda step: _f32(1.0)


def linear_warmup(warmup_steps: int):
    def fn(step):
        return torch.clamp(_f32((step + 1) / max(warmup_steps, 1)), max=1.0)
    return fn


def cosine_decay(total_steps: int, final_scale: float = 0.1):
    def fn(step):
        t = torch.clamp(_f32(step / max(total_steps, 1)), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return final_scale + (1.0 - final_scale) * cos
    return fn


def warmup_cosine(warmup_steps: int, total_steps: int,
                  final_scale: float = 0.1):
    wu = linear_warmup(warmup_steps)
    cd = cosine_decay(max(total_steps - warmup_steps, 1), final_scale)

    def fn(step):
        return torch.where(torch.as_tensor(step < warmup_steps), wu(step),
                           cd(step - warmup_steps))
    return fn

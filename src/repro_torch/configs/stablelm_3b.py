"""stablelm-3b — 32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.
[hf:stabilityai/stablelm-2-1_6b; unverified]
(Port of ``repro/configs/stablelm_3b.py``.)"""
from __future__ import annotations

import torch

from repro_torch.configs import registry, shapes
from repro_torch.models.transformer import TransformerConfig


def make_config(shape=None) -> TransformerConfig:
    return TransformerConfig(
        n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=6912, vocab_size=50304,
        rope_theta=10000.0,
        param_dtype=torch.float32, compute_dtype=torch.bfloat16)


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512,
        param_dtype=torch.float32, compute_dtype=torch.float32, remat=False)


ARCH = registry.register(registry.ArchDef(
    arch_id="stablelm-3b", family="lm",
    source="hf:stabilityai/stablelm-2-1_6b",
    make_config=make_config, make_reduced=make_reduced,
    shapes=dict(shapes.LM_SHAPES),
    skip_shapes={"long_500k": "pure full attention (no sub-quadratic "
                              "path) — skipped per brief, DESIGN.md §4"}))

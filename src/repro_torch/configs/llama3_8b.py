"""llama3-8b — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
[arXiv:2407.21783; unverified]
(Port of ``repro/configs/llama3_8b.py``.)"""
from __future__ import annotations

import torch

from repro_torch.configs import registry, shapes
from repro_torch.models.transformer import TransformerConfig


def make_config(shape=None) -> TransformerConfig:
    return TransformerConfig(
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=128256,
        rope_theta=500_000.0,
        param_dtype=torch.float32, compute_dtype=torch.bfloat16)


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512,
        param_dtype=torch.float32, compute_dtype=torch.float32, remat=False)


ARCH = registry.register(registry.ArchDef(
    arch_id="llama3-8b", family="lm", source="arXiv:2407.21783",
    make_config=make_config, make_reduced=make_reduced,
    shapes=dict(shapes.LM_SHAPES),
    skip_shapes={"long_500k": "pure full attention (no sub-quadratic "
                              "path) — skipped per brief, DESIGN.md §4"}))

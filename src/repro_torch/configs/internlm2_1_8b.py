"""internlm2-1.8b — 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
[arXiv:2403.17297; hf]
(Port of ``repro/configs/internlm2_1_8b.py``.)"""
from __future__ import annotations

import torch

from repro_torch.configs import registry, shapes
from repro_torch.models.transformer import TransformerConfig


def make_config(shape=None) -> TransformerConfig:
    return TransformerConfig(
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
        d_ff=8192, vocab_size=92544,
        rope_theta=1_000_000.0,
        param_dtype=torch.float32, compute_dtype=torch.bfloat16)


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512,
        param_dtype=torch.float32, compute_dtype=torch.float32, remat=False)


ARCH = registry.register(registry.ArchDef(
    arch_id="internlm2-1.8b", family="lm", source="arXiv:2403.17297",
    make_config=make_config, make_reduced=make_reduced,
    shapes=dict(shapes.LM_SHAPES),
    skip_shapes={"long_500k": "pure full attention (no sub-quadratic "
                              "path) — skipped per brief, DESIGN.md §4"}))

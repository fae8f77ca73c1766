"""olmoe-1b-7b — 16L d_model=2048 16H (GQA kv=16) d_ff=1024 (expert ffn)
vocab=50304, MoE 64 experts top-8.  [arXiv:2409.02060; hf]
(Port of ``repro/configs/olmoe_1b_7b.py``.)"""
from __future__ import annotations

import torch

from repro_torch.configs import registry, shapes
from repro_torch.models.transformer import TransformerConfig


def make_config(shape=None) -> TransformerConfig:
    return TransformerConfig(
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1024, vocab_size=50304,
        n_experts=64, moe_top_k=8,
        rope_theta=10000.0,
        param_dtype=torch.float32, compute_dtype=torch.bfloat16)


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
        vocab_size=512, n_experts=8, moe_top_k=2,
        param_dtype=torch.float32, compute_dtype=torch.float32, remat=False)


ARCH = registry.register(registry.ArchDef(
    arch_id="olmoe-1b-7b", family="lm", source="arXiv:2409.02060",
    make_config=make_config, make_reduced=make_reduced,
    shapes=dict(shapes.LM_SHAPES),
    skip_shapes={"long_500k": "pure full attention (no sub-quadratic "
                              "path) — skipped per brief, DESIGN.md §4"}))

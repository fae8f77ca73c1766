"""mixtral-8x22b — 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8 experts top-2, SWA.  [arXiv:2401.04088; hf]
(Port of ``repro/configs/mixtral_8x22b.py``.)

SWA window = 4096 (the Mistral-lineage window) — this is the one LM arch
whose ``long_500k`` cell runs: sliding-window attention is O(S·W) and the
decode cache rolls at ``window`` capacity (models/attention.py).
"""
from __future__ import annotations

import torch

from repro_torch.configs import registry, shapes
from repro_torch.models.transformer import TransformerConfig


def make_config(shape=None) -> TransformerConfig:
    return TransformerConfig(
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=32768,
        n_experts=8, moe_top_k=2, window=4096,
        rope_theta=1_000_000.0,
        param_dtype=torch.float32, compute_dtype=torch.bfloat16)


def make_reduced() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab_size=512, n_experts=4, moe_top_k=2, window=8,
        param_dtype=torch.float32, compute_dtype=torch.float32, remat=False)


ARCH = registry.register(registry.ArchDef(
    arch_id="mixtral-8x22b", family="lm", source="arXiv:2401.04088",
    make_config=make_config, make_reduced=make_reduced,
    shapes=dict(shapes.LM_SHAPES)))

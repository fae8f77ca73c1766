"""sasrec — embed_dim=50 n_blocks=2 n_heads=1 seq_len=50
interaction=self-attn-seq.  [arXiv:1808.09781; paper]
(Port of ``repro/configs/sasrec.py``.)"""
from __future__ import annotations

from repro_torch.configs import registry, shapes
from repro_torch.models.recsys import SASRecConfig


def make_config(shape=None) -> SASRecConfig:
    return SASRecConfig(n_items=1_000_000, embed_dim=50, n_blocks=2,
                        n_heads=1, seq_len=50)


def make_reduced() -> SASRecConfig:
    return SASRecConfig(n_items=1_000, embed_dim=16, n_blocks=2, n_heads=1,
                        seq_len=12)


ARCH = registry.register(registry.ArchDef(
    arch_id="sasrec", family="recsys", source="arXiv:1808.09781",
    make_config=make_config, make_reduced=make_reduced,
    shapes=dict(shapes.REC_SHAPES)))

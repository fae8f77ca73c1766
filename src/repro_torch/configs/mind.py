"""mind — embed_dim=64 n_interests=4 capsule_iters=3
interaction=multi-interest.  [arXiv:1904.08030; unverified]
(Port of ``repro/configs/mind.py``.)"""
from __future__ import annotations

from repro_torch.configs import registry, shapes
from repro_torch.models.recsys import MINDConfig


def make_config(shape=None) -> MINDConfig:
    return MINDConfig(n_items=1_000_000, embed_dim=64, n_interests=4,
                      capsule_iters=3, seq_len=50)


def make_reduced() -> MINDConfig:
    return MINDConfig(n_items=1_000, embed_dim=16, n_interests=2,
                      capsule_iters=2, seq_len=12)


ARCH = registry.register(registry.ArchDef(
    arch_id="mind", family="recsys", source="arXiv:1904.08030",
    make_config=make_config, make_reduced=make_reduced,
    shapes=dict(shapes.REC_SHAPES)))

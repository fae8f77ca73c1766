"""dien — embed_dim=18 seq_len=100 gru_dim=108 mlp=200-80
interaction=augru.  [arXiv:1809.03672; unverified]
(Port of ``repro/configs/dien.py``.)"""
from __future__ import annotations

from repro_torch.configs import registry, shapes
from repro_torch.models.recsys import DIENConfig


def make_config(shape=None) -> DIENConfig:
    return DIENConfig(n_items=1_000_000, embed_dim=18, seq_len=100,
                      gru_dim=108, mlp_hidden=(200, 80))


def make_reduced() -> DIENConfig:
    return DIENConfig(n_items=1_000, embed_dim=8, seq_len=12, gru_dim=24,
                      mlp_hidden=(32, 16))


ARCH = registry.register(registry.ArchDef(
    arch_id="dien", family="recsys", source="arXiv:1809.03672",
    make_config=make_config, make_reduced=make_reduced,
    shapes=dict(shapes.REC_SHAPES)))

"""dlrm-rm2 — n_dense=13 n_sparse=26 embed_dim=64 bot_mlp=13-512-256-64
top_mlp=512-512-256-1 interaction=dot.  [arXiv:1906.00091; paper]
(Port of ``repro/configs/dlrm_rm2.py``.)"""
from __future__ import annotations

from repro_torch.configs import registry, shapes
from repro_torch.models.recsys import DLRMConfig


def make_config(shape=None) -> DLRMConfig:
    return DLRMConfig(n_dense=13, n_sparse=26, embed_dim=64,
                      n_rows=1_000_000,
                      bot_mlp=(13, 512, 256, 64),
                      top_mlp_hidden=(512, 512, 256, 1))


def make_reduced() -> DLRMConfig:
    return DLRMConfig(n_dense=13, n_sparse=4, embed_dim=16, n_rows=1_000,
                      bot_mlp=(13, 32, 16), top_mlp_hidden=(32, 16, 1))


ARCH = registry.register(registry.ArchDef(
    arch_id="dlrm-rm2", family="recsys", source="arXiv:1906.00091",
    make_config=make_config, make_reduced=make_reduced,
    shapes=dict(shapes.REC_SHAPES)))

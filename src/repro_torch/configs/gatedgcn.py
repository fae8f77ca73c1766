"""gatedgcn — n_layers=16 d_hidden=70 aggregator=gated.
[arXiv:2003.00982; paper]  (Port of ``repro/configs/gatedgcn.py``.)

d_feat / readout vary per shape cell (Cora-like 1433, Reddit-like 602,
ogbn-products 100, molecule 16 with graph-level readout).
"""
from __future__ import annotations

from repro_torch.configs import registry, shapes
from repro_torch.models.gnn import GatedGCNConfig


def make_config(shape: shapes.GNNShape | None = None) -> GatedGCNConfig:
    if shape is None:
        shape = shapes.GNN_SHAPES["full_graph_sm"]
    return GatedGCNConfig(
        n_layers=16, d_hidden=70, d_feat=shape.d_feat,
        n_classes=47 if shape.name == "ogb_products" else
        (41 if shape.name == "minibatch_lg" else
         (10 if shape.name == "molecule" else 7)),
        graph_level=(shape.kind == "molecule"))


def make_reduced() -> GatedGCNConfig:
    return GatedGCNConfig(n_layers=3, d_hidden=16, d_feat=24, n_classes=4,
                          remat=False)


ARCH = registry.register(registry.ArchDef(
    arch_id="gatedgcn", family="gnn", source="arXiv:2003.00982",
    make_config=make_config, make_reduced=make_reduced,
    shapes=dict(shapes.GNN_SHAPES)))

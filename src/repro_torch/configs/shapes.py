"""Assigned input-shape sets, one set per architecture family (port of
``repro/configs/shapes.py``, whole: the LM and GNN sets are plain data).

Every (arch × shape) pair is a dry-run *cell*: the launch layer lowers
``train_step`` for training shapes and ``serve_step``/retrieval for
inference shapes (decode/long lower serve, never train — per the brief).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    kind: str              # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


LM_SHAPES = {
    "train_4k": LMShape("train_4k", "train", 4_096, 256),
    "prefill_32k": LMShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": LMShape("decode_32k", "decode", 32_768, 128),
    "long_500k": LMShape("long_500k", "decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class GNNShape:
    name: str
    kind: str              # "full" | "minibatch" | "molecule"
    n_nodes: int
    n_edges: int
    d_feat: int
    batch_nodes: int = 0   # minibatch seeds
    fanout: tuple = ()
    batch_graphs: int = 0  # molecule graphs per batch


GNN_SHAPES = {
    "full_graph_sm": GNNShape("full_graph_sm", "full", 2_708, 10_556, 1_433),
    "minibatch_lg": GNNShape("minibatch_lg", "minibatch", 232_965,
                             114_615_892, 602, batch_nodes=1_024,
                             fanout=(15, 10)),
    "ogb_products": GNNShape("ogb_products", "full", 2_449_029,
                             61_859_140, 100),
    "molecule": GNNShape("molecule", "molecule", 30, 64, 16,
                         batch_graphs=128),
}


@dataclasses.dataclass(frozen=True)
class RecShape:
    name: str
    kind: str              # "train" | "serve" | "retrieval"
    batch: int
    n_candidates: int = 0


REC_SHAPES = {
    "train_batch": RecShape("train_batch", "train", 65_536),
    "serve_p99": RecShape("serve_p99", "serve", 512),
    "serve_bulk": RecShape("serve_bulk", "serve", 262_144),
    "retrieval_cand": RecShape("retrieval_cand", "retrieval", 1,
                               n_candidates=1_000_000),
}


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m

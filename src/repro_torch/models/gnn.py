"""GatedGCN (Bresson & Laurent 2017; benchmarked in arXiv:2003.00982)
(port of ``repro/models/gnn.py``: ``GatedGCNConfig``, ``GraphBatch``,
``init``, ``_layer``, ``forward``, ``loss_fn``, ``forward_partitioned``
and ``loss_fn_partitioned``).

Message passing is the edge-index → segment-sum scatter pattern of the
reference:

    e'_ij  = e_ij + ReLU(Norm(E1·h_i + E2·h_j + E3·e_ij))
    σ_ij   = sigmoid(e'_ij)
    agg_i  = Σ_j σ_ij ⊙ (B2·h_j)  /  (Σ_j σ_ij + ε)       (gated mean)
    h'_i   = h_i + ReLU(Norm(B1·h_i + agg_i))

with LayerNorm for BatchNorm, as the reference adapts it.  The reference's
``jax.ops.segment_sum`` is :func:`repro_torch.core.kmeans.segment_sum`,
which adds each node's rows in edge order, and the gathers ``h[src]``,
``h[dst]`` are :func:`repro_torch.models.layers.take_rows`, whose
backward is the same row-order sum: a step is the same bits on every run
(CUDA's ``index_add_`` would add with atomics).  ``cfg.remat`` wraps each
layer in ``torch.utils.checkpoint`` (non-reentrant), as ``jax.checkpoint``
does; the layers loop over the stacked leaves (:func:`repro_torch.tree.
index`), as the reference's ``lax.scan`` does.

:func:`forward_partitioned` is the owner-computes layout on the
positions of a :class:`repro_torch.distributed.collectives.Mesh` (the
reference's ``shard_map``): each position owns a contiguous node range
and the edges whose dst lies in it (:func:`repro_torch.data.graph.
partition_by_dst`), so aggregation is local, and each layer does one
tiled all-gather of the node states.  The positions run their blocks in
:meth:`Mesh.run <repro_torch.distributed.collectives.Mesh.run>` with
autograd on; the collectives between them (the parameters' replication
and the all-gather, :func:`repro_torch.distributed.collectives.
replicate` and :func:`~repro_torch.distributed.collectives.
all_gather_tiled`) are autograd nodes of the caller's graph whose
backward adds the positions' blocks in rank order (the reference's
transposes: a psum and a tiled psum_scatter).  So no backward node ever
waits for another position: on a card, autograd runs every backward node
of a device on one thread, and a node that waited at a barrier for the
other positions' nodes would wait for itself.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree, work
from repro_torch.core.kmeans import segment_sum
from repro_torch.distributed import collectives
from repro_torch.models import layers

#: the mesh axes whose positions split the nodes (the reference's
#: ``("data", "model")`` present in the mesh)
PARTITION_AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    n_layers: int = 16
    d_hidden: int = 70
    d_feat: int = 1433
    d_edge_feat: int = 0       # 0 → learned constant edge init
    n_classes: int = 16
    graph_level: bool = False  # molecule cells: per-graph readout
    remat: bool = True
    impl: str = "gspmd"        # "gspmd" | "partitioned"
    bf16_gather: bool = False  # partitioned: gather node states in bf16


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """Fixed-shape padded (batch of) graph(s).

    Batched small graphs are flattened into one disjoint union;
    ``graph_id`` maps nodes to their graph (for graph-level readout).
    PAD edges use src=dst=n_nodes-1 with edge_mask=0; PAD nodes have
    node_mask=0.  ``n_graphs`` is metadata, not a leaf (it sizes the
    readout)."""
    node_feat: torch.Tensor     # (N, d_feat) f32
    edge_src: torch.Tensor      # (E,) i32
    edge_dst: torch.Tensor      # (E,) i32
    edge_mask: torch.Tensor     # (E,) f32
    node_mask: torch.Tensor     # (N,) f32
    labels: torch.Tensor        # (N,) or (G,) i32
    graph_id: torch.Tensor      # (N,) i32 (zeros for single-graph)
    n_graphs: int = 1


def init(generator: torch.Generator, cfg: GatedGCNConfig) -> dict:
    """The input embedding, the edge init, ``n_layers`` layers stacked on
    a leading axis (the reference's ``vmap`` of its layer init) and the
    head, on ``generator``'s device."""
    d, dev = cfg.d_hidden, generator.device

    def layer_init():
        return dict({k: layers.dense_init(generator, d, d)
                     for k in ("E1", "E2", "E3", "B1", "B2")},
                    norm_h=layers.layernorm_init(d, device=dev),
                    norm_e=layers.layernorm_init(d, device=dev))

    stacked = tree.stack([layer_init() for _ in range(cfg.n_layers)])
    return {
        "embed_h": layers.dense_init(generator, cfg.d_feat, d),
        "embed_e": (layers.dense_init(generator, cfg.d_edge_feat, d)
                    if cfg.d_edge_feat > 0
                    else {"const": torch.zeros((d,), device=dev)}),
        "layers": stacked,
        "head": layers.dense_init(generator, d, cfg.n_classes),
    }


def _layer(lp: dict, h: torch.Tensor, e: torch.Tensor, src: torch.Tensor,
           dst: torch.Tensor, edge_mask: torch.Tensor, n_nodes: int,
           h_full: Optional[torch.Tensor] = None, offset: int = 0
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """One GatedGCN layer over the nodes ``h`` and edges ``e``.  Edges
    read their endpoints from ``h_full`` (default ``h``) at ``src`` /
    ``dst`` and aggregate into the ``n_nodes`` rows of ``h`` at
    ``dst - offset`` (a partition's own range)."""
    h_full = h if h_full is None else h_full
    h_src = layers.take_rows(h_full, src)
    h_dst = layers.take_rows(h_full, dst)
    e_new = (layers.dense(lp["E1"], h_dst) + layers.dense(lp["E2"], h_src)
             + layers.dense(lp["E3"], e))
    e = e + torch.relu(layers.layernorm(lp["norm_e"], e_new))
    gate = torch.sigmoid(e) * edge_mask[:, None]
    msg = gate * layers.dense(lp["B2"], h_src)
    seg = dst.long() - offset if offset else dst
    num, _ = segment_sum(msg, seg, n_nodes)
    den, _ = segment_sum(gate, seg, n_nodes)
    agg = num / (den + 1e-6)
    h_new = layers.dense(lp["B1"], h) + agg
    return h + torch.relu(layers.layernorm(lp["norm_h"], h_new)), e


def _run_layer(cfg: GatedGCNConfig, *args, **kw):
    if cfg.remat:
        return checkpoint(_layer, *args, use_reentrant=False, **kw)
    return _layer(*args, **kw)


def _edge_init(params: dict, cfg: GatedGCNConfig, n_edges: int
               ) -> torch.Tensor:
    if cfg.d_edge_feat > 0:
        raise NotImplementedError(
            "edge-featured inputs not used by the assigned cells")
    return params["embed_e"]["const"].expand(n_edges, cfg.d_hidden)


def forward(params: dict, cfg: GatedGCNConfig, batch: GraphBatch
            ) -> torch.Tensor:
    """Logits: (N, n_classes) node-level or (G, n_classes) graph-level."""
    n_nodes = batch.node_feat.shape[0]
    h = layers.dense(params["embed_h"], batch.node_feat)
    e = _edge_init(params, cfg, batch.edge_src.shape[0])
    for i in range(cfg.n_layers):
        h, e = _run_layer(cfg, tree.index(params["layers"], i), h, e,
                          batch.edge_src, batch.edge_dst, batch.edge_mask,
                          n_nodes)
    if cfg.graph_level:
        pooled, _ = segment_sum(h * batch.node_mask[:, None],
                                batch.graph_id, batch.n_graphs)
        counts, _ = segment_sum(batch.node_mask, batch.graph_id,
                                batch.n_graphs)
        pooled = pooled / torch.clamp(counts, min=1.0)[:, None]
        return layers.dense(params["head"], pooled)
    return layers.dense(params["head"], h)


def _node_loss(logits: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over the nodes of ``mask`` (a tensor divisor,
    as :func:`repro_torch.models.layers.softmax_xent`)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long().clamp(min=0)[:, None])[:, 0]
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params: dict, cfg: GatedGCNConfig, batch: GraphBatch
            ) -> tuple[torch.Tensor, dict]:
    logits = forward(params, cfg, batch)
    if cfg.graph_level:
        loss = layers.softmax_xent(logits, batch.labels)
    else:
        loss = _node_loss(logits, batch.labels, batch.node_mask)
    return loss, {"loss": loss}


# --------------------------------------------------------------------------
# partitioned implementation (owner-computes over mesh positions)
# --------------------------------------------------------------------------

def _mesh_ranks(mesh: collectives.Mesh) -> tuple[tuple, list]:
    """The partition axes of ``mesh`` and its positions in rank order;
    every position must lie on those axes."""
    axes = tuple(a for a in PARTITION_AXES if a in mesh.shape)
    if not axes or mesh.axis_size(axes) != mesh.size:
        raise ValueError(f"forward_partitioned splits nodes over the mesh "
                         f"axes {PARTITION_AXES}; mesh {mesh.shape} has "
                         "positions off them")
    return axes, sorted(mesh.positions(), key=lambda c: mesh.rank(axes, c))


def forward_partitioned(params: dict, cfg: GatedGCNConfig,
                        batch: GraphBatch,
                        mesh: Optional[collectives.Mesh] = None
                        ) -> torch.Tensor:
    """Owner-computes GatedGCN on ``mesh``'s positions → the (N, n_classes)
    node logits on the first position's device.  Contract: ``batch`` is
    :func:`repro_torch.data.graph.partition_by_dst`'s layout over
    ``mesh.size`` shards (edge i of shard s ⇒ dst[i] ∈ [s·n_local,
    (s+1)·n_local)).  Without a mesh, :func:`forward` (as the reference
    off-mesh)."""
    if mesh is None:
        return forward(params, cfg, batch)
    axes, order = _mesh_ranks(mesh)
    n_shards = len(order)
    devices = [mesh.devices[c] for c in order]
    rank = {c: r for r, c in enumerate(order)}
    n_local = batch.node_feat.shape[0] // n_shards
    e_local = batch.edge_src.shape[0] // n_shards

    def block(x, n, r):
        return x[r * n:(r + 1) * n].to(devices[r])

    feat = [block(batch.node_feat, n_local, r) for r in range(n_shards)]
    src, dst, emask = ([block(x, e_local, r) for r in range(n_shards)]
                       for x in (batch.edge_src, batch.edge_dst,
                                 batch.edge_mask))
    leaves = tree.leaves(params)
    copies = [collectives.replicate(x, devices) for x in leaves]
    local = [tree.unflatten(params, [c[r] for c in copies])
             for r in range(n_shards)]

    def run(fn):
        out = mesh.run(lambda coord: fn(rank[coord]), grad=True)
        return [out[c] for c in order]

    h = run(lambda r: layers.dense(local[r]["embed_h"], feat[r]))
    e = [_edge_init(local[r], cfg, e_local) for r in range(n_shards)]
    for i in range(cfg.n_layers):
        gathered = h
        if cfg.bf16_gather:
            gathered = [x.to(torch.bfloat16) for x in h]
        full = collectives.all_gather_tiled(gathered, devices)
        full = [x.to(h[0].dtype) for x in full]

        def one(r, i=i, full=full, h=h, e=e):
            x = full[r]
            # made on the caller's stream, read on this one
            if x.is_cuda and not work.is_fake(x):
                x.record_stream(torch.cuda.current_stream(x.device))
            return _run_layer(cfg, tree.index(local[r]["layers"], i), h[r],
                              e[r], src[r], dst[r], emask[r], n_local,
                              h_full=x, offset=r * n_local)

        h, e = map(list, zip(*run(one)))
    logits = run(lambda r: layers.dense(local[r]["head"], h[r]))
    return torch.cat([x.to(devices[0]) for x in logits])


def loss_fn_partitioned(params: dict, cfg: GatedGCNConfig,
                        batch: GraphBatch,
                        mesh: Optional[collectives.Mesh] = None
                        ) -> tuple[torch.Tensor, dict]:
    logits = forward_partitioned(params, cfg, batch, mesh)
    loss = _node_loss(logits, batch.labels.to(logits.device),
                      batch.node_mask.to(logits.device))
    return loss, {"loss": loss}

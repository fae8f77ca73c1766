"""Graph data: synthetic generators and the fanout neighbor sampler (port
of ``repro/data/graph.py``: ``random_graph``, ``NeighborSampler``,
``molecule_batch`` and ``partition_by_dst``).

The same numpy draws from the same ``seed`` in the same order, so every
array equals the reference's bit for bit; the tensors go on ``device``
(the card by default).  All outputs are fixed-shape padded
:class:`~repro_torch.models.gnn.GraphBatch`\\ es (PAD edges point at a
sink node with edge_mask=0).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch import device as dev_mod
from repro_torch.models.gnn import GraphBatch


def _batch(dev, node_feat, edge_src, edge_dst, edge_mask, node_mask,
           labels, graph_id, n_graphs: int) -> GraphBatch:
    t = [dev_mod.as_tensor(a, dev) for a in (
        node_feat, edge_src, edge_dst, edge_mask, node_mask, labels,
        graph_id)]
    return GraphBatch(*t, n_graphs=n_graphs)


def random_graph(seed: int, n_nodes: int, n_edges: int, d_feat: int,
                 n_classes: int, n_communities: int = 16,
                 device: dev_mod.DeviceLike = "cuda") -> GraphBatch:
    """Community-structured random graph (labels correlate with
    features): 70% of edges rewired to a node of the source's community
    (one draw an edge, the reference's loop), 30% random."""
    dev = dev_mod.resolve(device)
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, n_communities, n_nodes)
    n_intra = int(n_edges * 0.7)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = np.empty(n_edges, np.int32)
    order = np.argsort(comm, kind="stable")
    starts = np.searchsorted(comm[order], np.arange(n_communities + 1))
    for i in range(n_intra):
        c = comm[src[i]]
        lo, hi = starts[c], starts[c + 1]
        dst[i] = order[rng.integers(lo, hi)] if hi > lo else src[i]
    dst[n_intra:] = rng.integers(0, n_nodes, n_edges - n_intra)

    centers = rng.normal(size=(n_communities, d_feat)).astype(np.float32)
    feat = centers[comm] + rng.normal(size=(n_nodes, d_feat)).astype(
        np.float32)
    labels = (comm % n_classes).astype(np.int32)
    return _batch(dev, feat, src, dst, np.ones((n_edges,), np.float32),
                  np.ones((n_nodes,), np.float32), labels,
                  np.zeros((n_nodes,), np.int32), 1)


class NeighborSampler:
    """GraphSAGE-style fanout sampling over a CSR adjacency (host-side
    numpy; the batch it returns goes on ``device``)."""

    def __init__(self, n_nodes: int, edge_src: np.ndarray,
                 edge_dst: np.ndarray):
        self.n_nodes = n_nodes
        edge_src, edge_dst = _host(edge_src), _host(edge_dst)
        order = np.argsort(edge_dst, kind="stable")
        self.sorted_src = edge_src[order]
        self.indptr = np.searchsorted(edge_dst[order],
                                      np.arange(n_nodes + 1))

    def sample(self, seed: int, seeds: np.ndarray, fanouts: tuple,
               node_feat: np.ndarray, labels: np.ndarray,
               device: dev_mod.DeviceLike = "cuda") -> GraphBatch:
        """The padded union subgraph of ``seeds`` and their sampled hops.

        Fixed shapes: n_sub = Σ_l seeds·Π fanouts[:l]; edges point
        child→parent (messages flow to the seeds); loss only on the
        seeds."""
        dev = dev_mod.resolve(device)
        node_feat, labels = _host(node_feat), _host(labels)
        rng = np.random.default_rng(seed)
        frontier = np.asarray(seeds, np.int64)
        all_nodes = [frontier]
        src_list, dst_list, mask_list = [], [], []
        offset = 0
        for f in fanouts:
            deg = self.indptr[frontier + 1] - self.indptr[frontier]
            picks = rng.integers(0, np.maximum(deg, 1)[:, None],
                                 size=(len(frontier), f))
            nbr = self.sorted_src[self.indptr[frontier][:, None] + picks]
            valid = (deg > 0)[:, None] & np.ones_like(picks, bool)
            parent_pos = offset + np.arange(len(frontier))
            child_pos = offset + len(frontier) + np.arange(nbr.size)
            src_list.append(child_pos.astype(np.int32))
            dst_list.append(np.repeat(parent_pos, f).astype(np.int32))
            mask_list.append(valid.reshape(-1).astype(np.float32))
            offset += len(frontier)
            frontier = nbr.reshape(-1)
            all_nodes.append(frontier)

        nodes = np.concatenate(all_nodes)
        labels_out = np.full(len(nodes), -1, np.int32)
        labels_out[:len(seeds)] = np.asarray(labels)[seeds]
        node_mask = np.zeros(len(nodes), np.float32)
        node_mask[:len(seeds)] = 1.0
        return _batch(dev, node_feat[nodes].astype(np.float32),
                      np.concatenate(src_list), np.concatenate(dst_list),
                      np.concatenate(mask_list), node_mask, labels_out,
                      np.zeros(len(nodes), np.int32), 1)


def molecule_batch(seed: int, batch: int, n_nodes: int, n_edges: int,
                   d_feat: int, n_classes: int,
                   device: dev_mod.DeviceLike = "cuda") -> GraphBatch:
    """Disjoint union of ``batch`` small graphs (the ``molecule`` cell),
    one label a graph."""
    dev = dev_mod.resolve(device)
    rng = np.random.default_rng(seed)
    total_n = batch * n_nodes
    total_e = batch * n_edges
    offs = np.repeat(np.arange(batch) * n_nodes, n_edges)
    src = rng.integers(0, n_nodes, total_e) + offs
    dst = rng.integers(0, n_nodes, total_e) + offs
    feat = rng.normal(size=(total_n, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, batch).astype(np.int32)
    return _batch(dev, feat, src.astype(np.int32), dst.astype(np.int32),
                  np.ones((total_e,), np.float32),
                  np.ones((total_n,), np.float32), labels,
                  np.repeat(np.arange(batch), n_nodes).astype(np.int32),
                  batch)


def partition_by_dst(batch: GraphBatch, n_shards: int,
                     device: Optional[dev_mod.DeviceLike] = None
                     ) -> GraphBatch:
    """Owner-computes range partitioning (the input contract of
    :func:`repro_torch.models.gnn.forward_partitioned`): nodes padded to
    a multiple of ``n_shards``; edges reordered so shard s holds exactly
    E/n_shards edges whose dst lies in s's node range (PAD edges fill the
    slack and point into the shard's own range; real edges never drop).
    On the host; the result goes on ``device`` (default: the batch's)."""
    dev = batch.node_feat.device if device is None else dev_mod.resolve(
        device)
    src, dst, mask, feat, nmask, labels = (_host(x) for x in (
        batch.edge_src, batch.edge_dst, batch.edge_mask, batch.node_feat,
        batch.node_mask, batch.labels))
    n_nodes = feat.shape[0]
    n_pad_nodes = -n_nodes % n_shards
    if n_pad_nodes:
        feat = np.pad(feat, ((0, n_pad_nodes), (0, 0)))
        nmask = np.pad(nmask, (0, n_pad_nodes))
        labels = np.pad(labels, (0, n_pad_nodes), constant_values=-1)
    n_total = n_nodes + n_pad_nodes
    n_local = n_total // n_shards

    owner = dst // n_local
    counts = np.bincount(owner[mask > 0], minlength=n_shards)
    e_local = int(counts.max(initial=1))
    src_out = np.zeros((n_shards, e_local), np.int32)
    dst_out = np.tile((np.arange(n_shards) * n_local)[:, None],
                      (1, e_local)).astype(np.int32)   # PAD → own range
    mask_out = np.zeros((n_shards, e_local), np.float32)
    for s in range(n_shards):
        sel = (owner == s) & (mask > 0)
        k = sel.sum()
        src_out[s, :k] = src[sel]
        dst_out[s, :k] = dst[sel]
        mask_out[s, :k] = 1.0
    return _batch(dev, feat, src_out.reshape(-1), dst_out.reshape(-1),
                  mask_out.reshape(-1), nmask, labels,
                  np.zeros(n_total, np.int32), batch.n_graphs)


def _host(x) -> np.ndarray:
    """A numpy view or copy of a tensor or array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)

"""Dry-run cells (port of ``repro/launch/cells.py``: ``Cell`` and
``build_cell``): for every (architecture × input shape) pair, the
port's own step function and its arguments at the cell's full published
shape, and :func:`execute`, which runs one step under the dry run's
counters (:mod:`repro_torch.launch.roofline`).

Cell kinds
    lm/train      ``train.cell_step`` over ``tfm.cell_loss`` (value and
                  grad, clip, AdamW; in place, as the reference donates)
    lm/prefill    ``tfm.prefill_step`` (full forward emitting KV caches)
    lm/decode     ``tfm.serve_step`` (1 token against a seq_len cache)
    gnn/*         ``train.cell_step`` over a padded GraphBatch
    recsys/train  ``train.cell_step`` over click batches
    recsys/serve  forward scoring
    recsys/retrieval  1 query × 10⁶ candidates, top-R
    hi2/serve, hi2/serve_filtered  ``hybrid_index.search`` (the bucket
                  cell is ``hi2/serve`` at its small batch)
    hi2/serve_sharded  ``sharded_index.search``, one mesh position

A cell is built with fake tensors by default
(``torch._subclasses.fake_tensor.FakeTensorMode``): its arguments come
from the port's own ``init`` functions, ``adam_init`` and
:meth:`repro_torch.core.codecs.base.Codec.abstract` under the cell's
mode, so a 1.7 TB Mixtral training state allocates nothing and the
step runs as shapes.  On fake CUDA tensors each hand-written kernel
takes its fake path (its outputs, its formula's count, no launch); on
fake CPU tensors the plain versions run, with their own work.  With
``fake=False`` the same leaves are drawn on the device from ``seed``
(ids in their ranges), for a real run to hold the fake one against.
Integer leaves keep the reference's dtypes (int32 ids and lengths,
uint8 codes, the uint32 filter words): the port's path widens them
where it indexes.

The reference shards each cell over its TPU mesh by sharding rules; the
port has none and runs the whole step on one device, except the sharded
HI² cell, which is one position of ``mesh``: its shard's planes
(⌈n_docs / model⌉ documents), the replicated state and its data slice of
the queries, searched on a one-position mesh of the device, whose
collectives meet only itself.  On a (1, 1) mesh that is the reference's
whole argument tree.  GNN node and edge counts are padded to multiples
of 512, as the reference pads them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import device as dev_mod
from repro_torch import tree as tree_mod
from repro_torch.configs import registry, shapes as sh
from repro_torch.core import cluster_selector as cs_mod
from repro_torch.core import codecs
from repro_torch.core import hybrid_index as hi
from repro_torch.core import inverted_lists as il
from repro_torch.core import sharded_index as shi
from repro_torch.core import term_selector as ts_mod
from repro_torch.core.exec import filters
from repro_torch.distributed import collectives
from repro_torch.launch import roofline
from repro_torch.launch import train
from repro_torch.models import gnn, recsys
from repro_torch.models import transformer as tfm
from repro_torch.models.gnn import GraphBatch
from repro_torch.models.recsys import (DIENBatch, DLRMBatch, MINDBatch,
                                       SASRecBatch)
from repro_torch.optim import adam_init


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str
    fn: Callable
    args: tuple
    donate_argnums: tuple       # args the step updates in place
    device: torch.device
    fake_mode: Optional[FakeTensorMode] = None

    @property
    def name(self) -> str:
        return f"{self.arch_id}/{self.shape_name}"

    def arg_leaves(self) -> list:
        """The argument tensors in the reference's leaf order."""
        return [leaf for a in self.args for leaf in tree_mod.leaves(a)]


class _Draw:
    """Where a cell's leaves come from: uninitialized tensors under the
    cell's fake mode, or values drawn on the device from ``seed``."""

    def __init__(self, dev: torch.device, seed: int, fake: bool):
        self.dev, self.fake = dev, fake
        self.gen = torch.Generator(device="cpu" if fake else dev)
        self.gen.manual_seed(seed)

    def init(self, fn: Callable, cfg):
        """A family's ``init(generator, cfg)`` on the device (under a
        fake mode drawn on a CPU generator, then moved: nothing moves)."""
        params = fn(self.gen, cfg)
        if self.fake and self.dev.type != "cpu":
            params = tree_mod.map(lambda t: t.to(self.dev), params)
        return params

    def floats(self, shape, dtype=torch.float32) -> torch.Tensor:
        if self.fake:
            return torch.empty(shape, dtype=dtype, device=self.dev)
        return torch.randn(shape, generator=self.gen,
                           device=self.dev).to(dtype)

    def ints(self, shape, high: int, dtype=torch.int32) -> torch.Tensor:
        """Ids in [0, high)."""
        if self.fake:
            return torch.empty(shape, dtype=dtype, device=self.dev)
        return torch.randint(0, max(high, 1), shape, generator=self.gen,
                             device=self.dev).to(dtype)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, dtype=torch.float32, device=self.dev)

    def fill(self, tree, high: int = 256):
        """Draw over every leaf of ``tree`` (``Codec.abstract``'s params or
        planes, empties): floats from N(0, 1), integers in [0, ``high``)."""
        if self.fake or tree is None:
            return tree

        def one(t):
            if t.is_floating_point():
                return self.floats(t.shape, t.dtype)
            return self.ints(t.shape, high, t.dtype)
        return tree_mod.map(one, tree)


# --------------------------------------------------------------------------
# LM family
# --------------------------------------------------------------------------

def _lm_cell(arch, shape: sh.LMShape, cfg, draw: _Draw,
             mesh: Optional[collectives.Mesh]) -> tuple:
    params = draw.init(tfm.init, cfg)
    b, s, v = shape.global_batch, shape.seq_len, cfg.vocab_size
    if shape.kind == "train":
        batch = {"tokens": draw.ints((b, s), v),
                 "labels": draw.ints((b, s), v)}
        loss = tfm.cell_loss
        if cfg.is_moe and cfg.moe_impl == "shard_map":
            def loss(p, cfg, batch):
                return tfm.loss_fn(p, cfg, batch["tokens"], batch["labels"],
                                   mesh=mesh)

        def train_step(params, state, batch):
            return train.cell_step(loss, cfg, params, state, batch)
        return "lm/train", train_step, (params, adam_init(params), batch), \
            (0, 1)
    if shape.kind == "prefill":
        def prefill(params, tokens):
            return tfm.prefill_step(params, cfg, tokens)
        return "lm/prefill", prefill, (params, draw.ints((b, s), v)), ()
    caches = tfm.init_decode_caches(cfg, b, s, device=draw.dev)

    def decode(params, caches, tokens_new, pos):
        return tfm.serve_step(params, cfg, caches, tokens_new, pos)
    pos = torch.full((), s - 1, dtype=torch.int32, device=draw.dev)
    return "lm/decode", decode, (params, caches, draw.ints((b, 1), v),
                                 pos), (1,)


# --------------------------------------------------------------------------
# GNN family
# --------------------------------------------------------------------------

def _gnn_sizes(shape: sh.GNNShape) -> tuple[int, int, int]:
    """(nodes, edges, graphs) of a cell's padded batch."""
    if shape.kind == "minibatch":
        n_nodes = frontier = shape.batch_nodes
        n_edges = 0
        for f in shape.fanout:
            n_edges += frontier * f
            frontier *= f
            n_nodes += frontier
    elif shape.kind == "molecule":
        n_nodes = shape.batch_graphs * shape.n_nodes
        n_edges = shape.batch_graphs * shape.n_edges
    else:
        n_nodes, n_edges = shape.n_nodes, shape.n_edges
    n_graphs = shape.batch_graphs if shape.kind == "molecule" else 1
    return (sh.pad_to_multiple(n_nodes, 512),
            sh.pad_to_multiple(n_edges, 512), n_graphs)


def _gnn_cell(arch, shape: sh.GNNShape, cfg, draw: _Draw,
              mesh: Optional[collectives.Mesh]) -> tuple:
    n, e, g = _gnn_sizes(shape)
    graph_level = shape.kind == "molecule"
    partitioned = cfg.impl == "partitioned" and not cfg.graph_level
    edge_dst = draw.ints((e,), n)
    if partitioned:
        # partition_by_dst's layout: shard s's edges end in its node range
        shards = mesh.size
        edge_dst = draw.ints((e,), n // shards) + (torch.arange(
            shards, dtype=torch.int32, device=draw.dev).repeat_interleave(
                e // shards) * (n // shards))
    batch = GraphBatch(
        node_feat=draw.floats((n, shape.d_feat)),
        edge_src=draw.ints((e,), n), edge_dst=edge_dst,
        edge_mask=draw.ones((e,)), node_mask=draw.ones((n,)),
        labels=draw.ints((g,) if graph_level else (n,), cfg.n_classes),
        graph_id=draw.ints((n,), g), n_graphs=g)
    params = draw.init(gnn.init, cfg)
    if partitioned:
        def loss(p, cfg, batch):
            return gnn.loss_fn_partitioned(p, cfg, batch, mesh)
    else:
        loss = gnn.loss_fn

    def train_step(params, state, batch):
        return train.cell_step(loss, cfg, params, state, batch)
    return f"gnn/{shape.kind}", train_step, (params, adam_init(params),
                                             batch), (0, 1)


# --------------------------------------------------------------------------
# RecSys family
# --------------------------------------------------------------------------

def _rec_batch(arch_id: str, cfg, b: int, draw: _Draw):
    if arch_id == "dlrm-rm2":
        return DLRMBatch(dense=draw.floats((b, cfg.n_dense)),
                         sparse=draw.ints((b, cfg.n_sparse), cfg.n_rows),
                         labels=draw.ints((b,), 2, torch.float32))
    items = cfg.n_items
    if arch_id == "sasrec":
        s = (b, cfg.seq_len)
        return SASRecBatch(items=draw.ints(s, items),
                           targets=draw.ints(s, items),
                           negatives=draw.ints(s, items))
    if arch_id == "dien":
        return DIENBatch(history=draw.ints((b, cfg.seq_len), items),
                         target=draw.ints((b,), items),
                         labels=draw.ints((b,), 2, torch.float32))
    if arch_id == "mind":
        return MINDBatch(history=draw.ints((b, cfg.seq_len), items),
                         target=draw.ints((b,), items),
                         negatives=draw.ints((b, 10), items))
    raise KeyError(arch_id)


def _rec_cell(arch, shape: sh.RecShape, cfg, draw: _Draw) -> tuple:
    aid = arch.arch_id
    params = draw.init(recsys.INITS[aid], cfg)
    if shape.kind == "train":
        def train_step(params, state, batch):
            return train.cell_step(recsys.LOSSES[aid], cfg, params, state,
                                   batch)
        return "recsys/train", train_step, (
            params, adam_init(params), _rec_batch(aid, cfg, shape.batch,
                                                  draw)), (0, 1)
    if shape.kind == "serve":
        fwd = {
            "dlrm-rm2": lambda p, b: recsys.dlrm_forward(p, cfg, b),
            "sasrec": lambda p, b: recsys.sasrec_user_embedding(p, cfg,
                                                                b.items),
            "dien": lambda p, b: recsys.dien_forward(p, cfg, b),
            "mind": lambda p, b: recsys.mind_interests(p, cfg, b.history),
        }[aid]
        return "recsys/serve", torch.no_grad()(fwd), (
            params, _rec_batch(aid, cfg, shape.batch, draw)), ()
    n_cand = shape.n_candidates
    if aid == "sasrec":
        fn = lambda p, items: recsys.sasrec_retrieval(  # noqa: E731
            p, cfg, items)
        args = (params, draw.ints((1, cfg.seq_len), cfg.n_items))
    elif aid == "mind":
        fn = lambda p, hist: recsys.mind_retrieval(p, cfg, hist)  # noqa
        args = (params, draw.ints((1, cfg.seq_len), cfg.n_items))
    elif aid == "dien":
        fn = lambda p, hist, cand: recsys.dien_retrieval(  # noqa: E731
            p, cfg, hist, cand)
        args = (params, draw.ints((1, cfg.seq_len), cfg.n_items),
                draw.ints((n_cand,), cfg.n_items))
    else:
        fn = lambda p, dense, ctx, cand: recsys.dlrm_retrieval(  # noqa
            p, cfg, dense, ctx, cand)
        args = (params, draw.floats((1, cfg.n_dense)),
                draw.ints((1, cfg.n_sparse - 1), cfg.n_rows),
                draw.ints((n_cand,), cfg.n_rows))
    return "recsys/retrieval", torch.no_grad()(fn), args, ()


# --------------------------------------------------------------------------
# hi2-synth: the paper's own serving step at MS MARCO scale (extra cell)
# --------------------------------------------------------------------------

def _lists(draw: _Draw, n_lists: int, capacity: int, n_docs: int):
    return il.PaddedLists(entries=draw.ints((n_lists, capacity), n_docs),
                          lengths=draw.ints((n_lists,), capacity + 1))


def _hi2_index(shape, draw: _Draw, filtered: bool) -> hi.HybridIndex:
    h, n = shape.hidden, shape.n_docs
    params, planes = (draw.fill(t, shape.pq_k) for t in codecs.get(
        shape.codec).abstract(n, h, pq_m=shape.pq_m, pq_k=shape.pq_k,
                              device=draw.dev))
    return hi.HybridIndex(
        cluster_sel=cs_mod.ClusterSelector(
            embeddings=draw.floats((shape.n_clusters, h))),
        term_sel=ts_mod.TermSelector(avg_scores=draw.floats((shape.vocab,))),
        cluster_lists=_lists(draw, shape.n_clusters, shape.cluster_capacity,
                             n),
        term_lists=_lists(draw, shape.vocab, shape.term_capacity, n),
        codec_params=params, doc_planes=planes,
        doc_assign=draw.ints((n,), shape.n_clusters),
        doc_ns=(draw.ints((n,), shape.n_namespaces) if filtered else None),
        codec=shape.codec, max_postings=0)


def _hi2_cell(shape, draw: _Draw) -> tuple:
    dev = draw.dev
    filtered = shape.kind == "hi2_serve_filtered"
    index = _hi2_index(shape, draw, filtered)
    qe = draw.floats((shape.query_batch, shape.hidden))
    qt = draw.ints((shape.query_batch, shape.query_len), shape.vocab)
    kw = dict(kc=shape.kc, k2=shape.k2, top_r=shape.top_r, device=dev)
    if not filtered:
        def serve(index, q_emb, q_tokens):
            return hi.search(index, q_emb, q_tokens, **kw)
        return "hi2/serve", serve, (index, qe, qt), ()
    words = filters.n_words(shape.n_namespaces)
    ns = draw.ints((shape.query_batch, words), 2 ** 31).to(torch.uint32)

    def serve_filtered(index, q_emb, q_tokens, ns_filter):
        return hi.search(index, q_emb, q_tokens, filter=ns_filter, **kw)
    return "hi2/serve_filtered", serve_filtered, (index, qe, qt, ns), ()


def _hi2_sharded_cell(shape, draw: _Draw,
                      mesh: Optional[collectives.Mesh]) -> tuple:
    """One position of ``mesh`` (a (1, 1) mesh without one): shard 0's
    planes, the replicated state and data slice 0's queries, on a
    one-position ("data", "model") mesh of the device."""
    shape_of = (mesh.shape if mesh is not None
                else {"data": 1, "model": 1})
    n_shards, n_data = shape_of["model"], shape_of.get("data", 1)
    per = -(-shape.n_docs // n_shards)
    rows = shape.query_batch // n_data
    h, L, V = shape.hidden, shape.n_clusters, shape.vocab
    c_params, c_planes = (draw.fill(t, shape.pq_k) for t in codecs.get(
        shape.codec).abstract(per, h, pq_m=shape.pq_m, pq_k=shape.pq_k,
                              device=draw.dev))
    cl = _lists(draw, L, shape.cluster_capacity, per)
    tl = _lists(draw, V, shape.term_capacity, per)
    planes = {"cluster_entries": cl.entries[None],
              "cluster_lengths": cl.lengths[None],
              "term_entries": tl.entries[None],
              "term_lengths": tl.lengths[None],
              "codec": tree_mod.map(lambda t: t[None], c_planes)}
    rep = {"cluster_emb": draw.floats((L, h)),
           "term_avg": draw.floats((V,)), "codec": c_params}
    qe = draw.floats((rows, h))
    qt = draw.ints((rows, shape.query_len), V)
    position = collectives.Mesh([[draw.dev]], ("data", "model"))

    def serve_sharded(planes, rep, q_emb, q_tokens):
        sindex = shi.ShardedHybridIndex(
            cluster_sel=cs_mod.ClusterSelector(rep["cluster_emb"]),
            term_sel=ts_mod.TermSelector(rep["term_avg"]),
            cluster_entries=planes["cluster_entries"],
            cluster_lengths=planes["cluster_lengths"],
            term_entries=planes["term_entries"],
            term_lengths=planes["term_lengths"],
            codec_params=rep["codec"], doc_planes=planes["codec"],
            doc_assign=torch.zeros((1, per), dtype=torch.int32,
                                   device=q_emb.device),
            codec=shape.codec, n_docs=per, max_postings=0)
        return shi.search(sindex, q_emb, q_tokens, kc=shape.kc, k2=shape.k2,
                          top_r=shape.top_r, mesh=position,
                          axis_name="model", data_axis="data")
    return "hi2/serve_sharded", serve_sharded, (planes, rep, qe, qt), ()


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------

def build_cell(arch_id: str, shape_name: str,
               mesh: Optional[collectives.Mesh] = None, *,
               device: dev_mod.DeviceLike = "cuda", fake: bool = True,
               seed: int = 0, config=None, shape=None) -> Cell:
    """The cell on ``device`` (default the card; raises without one):
    fake tensors under a fresh ``FakeTensorMode`` (``fake``), else real
    ones drawn from ``seed``.  ``config`` replaces the arch's
    ``make_config(shape)`` and ``shape`` the registry's shape (a cut
    cell, the same for a fake and a real run); ``mesh`` sizes the
    sharded HI² cell and carries the positions of the GNN's
    ``impl="partitioned"`` loss and of an MoE LM's
    ``moe_impl="shard_map"`` training step."""
    dev = dev_mod.resolve(device)
    arch = registry.get(arch_id)
    shape = shape or arch.shapes[shape_name]
    mode = FakeTensorMode() if fake else None
    draw = _Draw(dev, seed, fake)
    with mode if fake else contextlib.nullcontext():
        if arch.family == "hi2":
            if shape.kind == "hi2_serve_sharded":
                kind, fn, args, donate = _hi2_sharded_cell(shape, draw, mesh)
            else:
                kind, fn, args, donate = _hi2_cell(shape, draw)
        else:
            cfg = config if config is not None else arch.make_config(shape)
            if arch.family == "lm":
                kind, fn, args, donate = _lm_cell(arch, shape, cfg, draw,
                                                  mesh)
            elif arch.family == "gnn":
                kind, fn, args, donate = _gnn_cell(arch, shape, cfg, draw,
                                                   mesh)
            else:
                kind, fn, args, donate = _rec_cell(arch, shape, cfg, draw)
    return Cell(arch_id, shape_name, kind, fn, args, donate, dev, mode)


# --------------------------------------------------------------------------
# one step under the counters
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Executed:
    out: Any
    count: roofline.Count
    memory: dict            # bytes: argument, output, temp, alias, peak
    seconds: float


def execute(cell: Cell) -> Executed:
    """One step of ``cell`` under :func:`repro_torch.launch.roofline.
    counting` (inside its fake mode, if it has one).  The arguments are
    live from the start; ``memory`` splits the peak of live bytes as the
    reference's ``memory_analysis`` does: ``peak = argument + output +
    temp - alias``, ``alias`` the outputs' storages that are arguments'
    (the training cells step in place)."""
    t0 = time.perf_counter()
    with (cell.fake_mode if cell.fake_mode is not None
          else contextlib.nullcontext()):
        with roofline.counting() as count:
            arg_bytes = count.hold(cell.args)
            out = cell.fn(*cell.args)
        if cell.device.type == "cuda" and cell.fake_mode is None:
            torch.cuda.synchronize(cell.device)
    seconds = time.perf_counter() - t0
    arg_keys = count.storages(cell.args)
    out_bytes = alias = 0
    seen = set()
    for t in roofline.tensors(out):
        st = t.untyped_storage()
        if id(st) in seen or t.device.type == "meta":
            continue
        seen.add(id(st))
        out_bytes += st.nbytes()
        if id(st) in arg_keys:
            alias += st.nbytes()
    peak = count.peak_bytes
    memory = {"argument": arg_bytes, "output": out_bytes, "alias": alias,
              "temp": peak - arg_bytes - out_bytes + alias, "peak": peak}
    return Executed(out, count, memory, seconds)

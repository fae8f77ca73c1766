"""Document-sharded HI², the index-parallel serving path (port of
``repro/core/sharded_index.py``: ``ShardedHybridIndex``, ``partition``,
``make_shard_mesh``, ``device_put``, ``search``, ``take_shards``,
``shard_offsets_for``, ``candidate_budget``; DESIGN.md §6).

A single-device :class:`~repro_torch.core.hybrid_index.HybridIndex` caps
the corpus at one device's memory.  This module splits the *documents*
(and with them the codec doc planes, the namespace plane, the inverted
list entries and the BM25 impact plane) over the shard axis of a
:class:`repro_torch.distributed.collectives.Mesh` and runs the same
staged engine (:func:`repro_torch.core.exec.execute`) on every mesh
position, each in its own worker thread:

    shard s owns the contiguous doc range [s·P, (s+1)·P)

    replicated per device : cluster/term selectors, codec params, queries
    per shard              : every codec doc plane, ``doc_ns``, the list
                             entry planes filtered to the shard's docs,
                             the impact plane split the same way

    per shard : dispatch → gather → dedup → filter → score → local top-R′
    merge     : all-gather of the (B, R′) planes over the shard axis and
                one more total-order top-R′ (inside ``exec.topk``)
    refine    : each shard exact-scores the merged frontier's docs it
                owns, and a psum assembles them

The partition runs after global list construction (capacity truncation
included), on the host, once: the union of the per-shard lists is the
single-device lists, each document lives in one shard, and selection
goes through the total order of :func:`~repro_torch.core.exec.
topk_by_score`, so the merged result equals single-device ``search()``
bit for bit for every registered codec, with and without a namespace
filter and fusion.  Per-shard planes keep the global list capacity: the
per-shard candidate budget is the single-device one, and each device
holds 1/S of the doc planes.

A partitioned index holds (S, ...) tensors on the host.
:func:`device_put` copies shard s's planes to the devices of the mesh
positions on the shard axis's index s (once per device), and the
replicated state to every device; the placed index keeps them in its
:class:`Placement` and its (S, ...) fields become shape-only ``meta``
tensors.  :func:`to_host` stacks the blocks back, for a checkpoint.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import device as dev_mod
from repro_torch.core import cluster_selector as cs_mod
from repro_torch.core import codecs
from repro_torch.core import exec as qexec
from repro_torch.core import hybrid_index as hi
from repro_torch.core import term_selector as ts_mod
from repro_torch.core.exec import filters
from repro_torch.core.inverted_lists import PAD_DOC, PaddedLists
from repro_torch.distributed import collectives

SHARD_AXIS = "shards"

#: the fields with a leading shard axis, and the replicated ones
SHARDED = ("cluster_entries", "cluster_lengths", "term_entries",
           "term_lengths", "doc_planes", "doc_assign", "doc_ns",
           "sparse_weights")
REPLICATED = ("cluster_sel", "term_sel", "codec_params")


def _tmap(fn, x):
    """``fn`` over the tensors of a tree of NamedTuples and dicts."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_tmap(fn, v) for v in x))
    if isinstance(x, dict):
        return {k: _tmap(fn, v) for k, v in x.items()}
    return x


def _stack(trees: list):
    """Trees of one structure → one tree of their tensors stacked on the
    host."""
    x = trees[0]
    if isinstance(x, torch.Tensor):
        return torch.stack([t.cpu() for t in trees])
    if isinstance(x, dict):
        return {k: _stack([t[k] for t in trees]) for k in x}
    return x


def _meta(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device="meta")


class Placement:
    """Where a placed index's tensors live (not an index leaf):
    ``blocks[s][device]`` holds shard s's planes on that device (a dict of
    the :data:`SHARDED` fields), ``rep[device]`` the replicated state."""

    def __init__(self, blocks: dict, rep: dict):
        self.blocks = blocks
        self.rep = rep


@dataclasses.dataclass(frozen=True)
class ShardedHybridIndex:
    """HI² with every document-indexed plane carrying a leading shard
    axis (S, ...); selector and codec-param state replicated.  Fields in
    the reference's leaf order (its ``data_fields``), so a checkpoint of
    either package restores in the other."""
    cluster_sel: cs_mod.ClusterSelector       # replicated
    term_sel: ts_mod.TermSelector             # replicated
    cluster_entries: torch.Tensor             # (S, L, Cc) i32, global ids
    cluster_lengths: torch.Tensor             # (S, L) i32
    term_entries: torch.Tensor                # (S, V, Ct) i32
    term_lengths: torch.Tensor                # (S, V) i32
    codec_params: Any                         # replicated codec state
    doc_planes: dict                          # leaves (S, P, ...)
    doc_assign: torch.Tensor                  # (S, P) i32
    doc_ns: Optional[torch.Tensor] = None     # (S, P) i32 namespace ids
    sparse_weights: Optional[torch.Tensor] = None  # (S, V, Ct) f32 impacts
    codec: str = codecs.DEFAULT
    n_docs: int = 0                           # true corpus size
    # the most term-list postings of a document (bounds the sparse path's
    # runs, as HybridIndex.max_postings); never in a checkpoint
    max_postings: Optional[int] = None
    placement: Optional[Placement] = dataclasses.field(
        default=None, compare=False, repr=False)

    def __post_init__(self):
        if (self.max_postings is None
                and not self.term_entries.is_meta):
            e = self.term_entries
            object.__setattr__(self, "max_postings", hi.count_max_postings(
                PaddedLists(e.reshape(-1, e.shape[-1]),
                            self.term_lengths.reshape(-1))))

    @property
    def n_shards(self) -> int:
        return self.cluster_entries.shape[0]

    @property
    def docs_per_shard(self) -> int:
        return self.doc_assign.shape[1]


# --------------------------------------------------------------------------
# partition (host-side, build-time)
# --------------------------------------------------------------------------

def _split_lists(entries: np.ndarray, n_shards: int, per: int,
                 base: int = 0, weights: Optional[np.ndarray] = None):
    """Filter a global (L, C) entries plane into per-shard (S, L, C)
    planes that keep the global capacity C, each row left-packed in its
    original order (impact order survives, so per-shard BM25 sums are the
    single-device sums).  Shard s owns ids in [base + s·per, base +
    (s+1)·per).  With ``weights`` (an aligned (L, C) impact plane) the
    same permutation splits it too (0.0 beyond each shard's count) and a
    third plane is returned."""
    e = np.asarray(entries)
    n_lists, cap = e.shape
    out = np.full((n_shards, n_lists, cap), PAD_DOC, np.int32)
    lengths = np.zeros((n_shards, n_lists), np.int32)
    w_out = (None if weights is None else
             np.zeros((n_shards, n_lists, cap), np.float32))
    for s in range(n_shards):
        mine = (e >= base + s * per) & (e < base + (s + 1) * per)
        col = np.cumsum(mine, axis=1) - 1       # packed slot of each kept
        rows, cols = np.nonzero(mine)           # row-major: list order kept
        out[s, rows, col[rows, cols]] = e[rows, cols]
        lengths[s] = mine.sum(axis=1)
        if weights is not None:
            w_out[s, rows, col[rows, cols]] = weights[rows, cols]
    if weights is None:
        return out, lengths
    return out, lengths, w_out


def _split_docs(plane: np.ndarray, n_shards: int, per: int) -> np.ndarray:
    """(n_docs, ...) → (S, P, ...) with zero tail rows (no list entry
    points at them, so they are unreachable)."""
    out = np.zeros((n_shards * per,) + plane.shape[1:], plane.dtype)
    out[:plane.shape[0]] = plane
    return out.reshape((n_shards, per) + plane.shape[1:])


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def partition(index: hi.HybridIndex, n_shards: int) -> ShardedHybridIndex:
    """Split a built single-device index into ``n_shards`` contiguous
    document ranges, on the host (numpy), once at build time; the result
    holds CPU tensors."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    codec_impl = codecs.get(index.codec)
    n_docs = index.n_docs
    per = -(-n_docs // n_shards)    # ceil
    cpu = lambda t: t.cpu()         # noqa: E731
    c_entries, c_lengths = _split_lists(
        _host(index.cluster_lists.entries), n_shards, per)
    t_entries, t_lengths, *s_weights = _split_lists(
        _host(index.term_lists.entries), n_shards, per,
        weights=(None if index.sparse_weights is None
                 else _host(index.sparse_weights)))
    split = lambda x: torch.from_numpy(                  # noqa: E731
        _split_docs(_host(x), n_shards, per))
    return ShardedHybridIndex(
        cluster_sel=_tmap(cpu, index.cluster_sel),
        term_sel=_tmap(cpu, index.term_sel),
        cluster_entries=torch.from_numpy(c_entries),
        cluster_lengths=torch.from_numpy(c_lengths),
        term_entries=torch.from_numpy(t_entries),
        term_lengths=torch.from_numpy(t_lengths),
        codec_params=codec_impl.replicate(_tmap(cpu, index.codec_params)),
        doc_planes=codec_impl.partition(index.doc_planes, split),
        doc_assign=split(index.doc_assign),
        doc_ns=None if index.doc_ns is None else split(index.doc_ns),
        sparse_weights=(torch.from_numpy(s_weights[0]) if s_weights
                        else None),
        codec=index.codec, n_docs=n_docs, max_postings=index.max_postings)


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------

def make_shard_mesh(n_shards: int, axis_name: str = SHARD_AXIS,
                    devices=None) -> collectives.Mesh:
    """1-D serving mesh: ``n_shards`` positions on the first
    ``n_shards`` cards, or on ``devices`` (which may repeat a device:
    ``["cuda:0"] * 4`` puts four positions on one card, ``["cpu"] * 4``
    on the CPU).  Raises when there are fewer cards and no ``devices``."""
    return collectives.Mesh(
        collectives.mesh_devices(n_shards, devices, f"{n_shards} shards"),
        (axis_name,))


def shard_block(sindex: ShardedHybridIndex, s: int) -> dict:
    """Shard ``s``'s planes (the :data:`SHARDED` fields, (P, ...) / (L,
    C)): a placed copy when there is one, else views of the stacked
    fields."""
    if sindex.placement is not None:
        return next(iter(sindex.placement.blocks[s].values()))
    if sindex.cluster_entries.is_meta:
        raise ValueError("a shape-only index (a restore template) holds no "
                         "planes; restore a checkpoint into it first")
    return {f: _tmap(lambda x: x[s], getattr(sindex, f)) for f in SHARDED}


def _replicated(sindex: ShardedHybridIndex) -> dict:
    if sindex.placement is not None:
        return next(iter(sindex.placement.rep.values()))
    return {f: getattr(sindex, f) for f in REPLICATED}


def is_placed(sindex: ShardedHybridIndex, mesh: collectives.Mesh,
              axis_name: str = SHARD_AXIS) -> bool:
    """Whether every position of ``mesh`` finds its shard's planes and
    the replicated state on its own device."""
    p = sindex.placement
    if p is None or mesh.shape.get(axis_name) != sindex.n_shards:
        return False
    ax = mesh.axis_index(axis_name)
    return all(mesh.devices[c] in p.blocks.get(c[ax], {})
               and mesh.devices[c] in p.rep for c in mesh.positions())


def device_put(sindex: ShardedHybridIndex, mesh: collectives.Mesh,
               axis_name: str = SHARD_AXIS) -> ShardedHybridIndex:
    """Place each shard's planes on the devices of its mesh positions (1/S
    of the doc-plane bytes per device when each position has a card of
    its own), and the selectors and codec params on every device.  A
    device that already holds a block keeps it (no copy)."""
    if mesh.shape.get(axis_name) != sindex.n_shards:
        raise ValueError(f"mesh axis {axis_name!r} has size "
                         f"{mesh.shape.get(axis_name)} but the index has "
                         f"{sindex.n_shards} shards")
    ax = mesh.axis_index(axis_name)
    old = sindex.placement or Placement({}, {})
    blocks: dict = {}
    rep: dict = {}
    for coord in mesh.positions():
        dev, s = mesh.devices[coord], coord[ax]
        mine = blocks.setdefault(s, {})
        if dev not in mine:
            have = old.blocks.get(s, {})
            mine[dev] = (have[dev] if dev in have else _tmap(
                lambda x: x.to(dev), shard_block(sindex, s)))
        if dev not in rep:
            rep[dev] = (old.rep[dev] if dev in old.rep else _tmap(
                lambda x: x.to(dev), _replicated(sindex)))
    for dev in rep:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return dataclasses.replace(to_meta(sindex),
                               placement=Placement(blocks, rep))


def to_host(sindex: ShardedHybridIndex) -> ShardedHybridIndex:
    """The index as (S, ...) CPU tensors (a placed index's blocks stacked
    back), what a checkpoint writes."""
    if sindex.placement is None:
        return dataclasses.replace(sindex, **{
            f: _tmap(lambda x: x.cpu(), getattr(sindex, f))
            for f in SHARDED + REPLICATED})
    blocks = [shard_block(sindex, s) for s in range(sindex.n_shards)]
    rep = _replicated(sindex)
    return dataclasses.replace(
        sindex, placement=None,
        **{f: _stack([b[f] for b in blocks]) for f in SHARDED},
        **{f: _tmap(lambda x: x.cpu(), rep[f]) for f in REPLICATED})


def to_meta(sindex: ShardedHybridIndex) -> ShardedHybridIndex:
    """A shape-and-dtype template of the index (no plane bytes), what a
    checkpoint restores into."""
    return dataclasses.replace(sindex, placement=None, **{
        f: _tmap(_meta, getattr(sindex, f)) for f in SHARDED + REPLICATED})


def plane_bytes(sindex: ShardedHybridIndex, s: int = 0) -> int:
    """Bytes of shard ``s``'s planes on one device: doc planes, doc
    assignments, namespace and impact planes, list entries and
    lengths."""
    return sum(x.nbytes for x in _leaves(shard_block(sindex, s)))


def _leaves(tree) -> list:
    out = []
    _tmap(out.append, tree)
    return out


# --------------------------------------------------------------------------
# search
# --------------------------------------------------------------------------

def take_shards(sindex: ShardedHybridIndex,
                shard_ids) -> ShardedHybridIndex:
    """The survivor view: a smaller sharded index of the given shards'
    planes (DESIGN.md §12), sharing their tensors (no copy).

    Global doc ids are preserved, but the surviving shards no longer sit
    at their original mesh positions, so searches over the view must
    pass :func:`search` the matching ``shard_offsets``
    (:func:`shard_offsets_for`)."""
    sel = sorted(int(s) for s in shard_ids)
    if not sel:
        raise ValueError("take_shards needs at least one surviving shard")
    if sel[0] < 0 or sel[-1] >= sindex.n_shards:
        raise ValueError(f"shard ids {sel} out of range "
                         f"[0, {sindex.n_shards})")
    if sindex.placement is not None:
        p = sindex.placement
        shape = lambda x: torch.empty(                    # noqa: E731
            (len(sel),) + x.shape[1:], dtype=x.dtype, device="meta")
        return dataclasses.replace(
            sindex, placement=Placement(
                {i: p.blocks[s] for i, s in enumerate(sel)}, p.rep),
            **{f: _tmap(shape, getattr(sindex, f)) for f in SHARDED})
    idx = torch.as_tensor(sel)
    return dataclasses.replace(sindex, **{
        f: _tmap(lambda x: x[idx], getattr(sindex, f)) for f in SHARDED})


def shard_offsets_for(shard_ids, per: int) -> np.ndarray:
    """The explicit offsets matching :func:`take_shards`."""
    return (np.asarray(sorted(int(s) for s in shard_ids), np.int32)
            * np.int32(per))


def search(sindex: ShardedHybridIndex, query_embeddings, query_tokens, *,
           kc: int, k2: int, top_r: int,
           mesh: Optional[collectives.Mesh] = None,
           axis_name: str = SHARD_AXIS, filter=None,
           data_axis: Optional[str] = None, shard_offsets=None,
           fusion: Optional[qexec.FusionSpec] = None) -> hi.SearchResult:
    """Sharded Eq. 5: the contract of :func:`repro_torch.core.
    hybrid_index.search`, bit for bit, under a namespace ``filter`` and
    under ``fusion`` too (DESIGN.md §6, §9, §13).

    ``mesh`` defaults to a fresh 1-D mesh over the first ``n_shards``
    cards; pass one from :func:`make_shard_mesh` (after
    :func:`device_put`) to reuse its threads and placement across calls.
    ``data_axis`` names a second mesh axis to split the query batch over
    (the 2-D (data, model) layout of DESIGN.md §12): each slice searches
    its rows, and the batch must divide by its size.  ``shard_offsets``
    ((S,) ints) overrides the contiguous s·per doc-id layout for survivor
    views (:func:`take_shards`).  Queries go to the first position's
    device, and the result comes back there."""
    if mesh is None:
        mesh = make_shard_mesh(sindex.n_shards, axis_name)
    if mesh.shape.get(axis_name) != sindex.n_shards:
        raise ValueError(
            f"mesh axis {axis_name!r} has size {mesh.shape.get(axis_name)} "
            f"but the index has {sindex.n_shards} shards")
    if filter is not None and sindex.doc_ns is None:
        raise ValueError("search(filter=...) needs an index partitioned "
                         "from one built with doc_namespaces=")
    per = sindex.docs_per_shard
    if shard_offsets is None:
        offsets = [s * per for s in range(sindex.n_shards)]
    else:
        offsets = np.asarray(shard_offsets, np.int64).reshape(-1)
        if np.shape(shard_offsets) != (sindex.n_shards,):
            raise ValueError(f"shard_offsets shape {np.shape(shard_offsets)}"
                             f" != ({sindex.n_shards},)")
        offsets = [int(o) for o in offsets]
    if not is_placed(sindex, mesh, axis_name):
        sindex = device_put(sindex, mesh, axis_name)
    p = sindex.placement

    def sources(s, dev):
        blk = p.blocks[s][dev]
        return [qexec.Source(
            cluster_lists=PaddedLists(blk["cluster_entries"],
                                      blk["cluster_lengths"]),
            term_lists=PaddedLists(blk["term_entries"], blk["term_lengths"]),
            doc_planes=blk["doc_planes"], size=per, offset=offsets[s],
            doc_ns=blk["doc_ns"], sparse_weights=blk["sparse_weights"],
            max_postings=sindex.max_postings)]

    return run_search(mesh, axis_name, data_axis, p.rep, sindex.codec,
                      sources, query_embeddings, query_tokens, kc=kc, k2=k2,
                      top_r=top_r, filter=filter, fusion=fusion)


def batch_slices(mesh: collectives.Mesh, data_axis: Optional[str],
                 b: int) -> int:
    """The number of data-axis slices a batch of ``b`` queries splits
    over (1 without ``data_axis``); raises when the mesh has no such
    axis or ``b`` does not divide over it."""
    if data_axis is None:
        return 1
    if data_axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {data_axis!r} "
                         f"(axes: {mesh.axis_names})")
    d = mesh.shape[data_axis]
    if b % d:
        raise ValueError(
            f"batch {b} does not divide over {d} data-axis slices; "
            f"pad to a multiple of {d}")
    return d


def run_search(mesh: collectives.Mesh, axis_name: str,
               data_axis: Optional[str], rep: dict, codec: str, sources,
               query_embeddings, query_tokens, *, kc: int, k2: int,
               top_r: int, filter=None,
               fusion: Optional[qexec.FusionSpec] = None) -> hi.SearchResult:
    """The staged engine on every position of ``mesh`` under a
    :class:`~repro_torch.core.exec.ShardEnv` along ``axis_name``: a
    position at shard s on device ``dev`` searches ``sources(s, dev)``
    (its shard's :class:`~repro_torch.core.exec.Source` list) with the
    replicated state ``rep[dev]``, over its data slice's rows of the
    batch.  Queries go to the first position's device, and the merged
    result comes back there."""
    b = query_embeddings.shape[0]
    rows = b // batch_slices(mesh, data_axis, b)
    dev0 = mesh.devices.flat[0]
    qe = dev_mod.as_tensor(query_embeddings, dev0, torch.float32)
    qt = dev_mod.as_tensor(query_tokens, dev0, torch.int64)
    ns = None if filter is None else filters.as_words(filter, dev0)
    codec_impl = codecs.get(codec)
    ax = mesh.axis_index(axis_name)
    dax = None if data_axis is None else mesh.axis_index(data_axis)

    def body(coord):
        dev, s = mesh.devices[coord], coord[ax]
        lo = 0 if dax is None else coord[dax] * rows
        r = rep[dev]
        return qexec.execute(
            codec_impl, r["codec_params"], r["cluster_sel"], r["term_sel"],
            sources(s, dev), qe[lo:lo + rows].to(dev),
            qt[lo:lo + rows].to(dev), kc=kc, k2=k2, top_r=top_r,
            ns_filter=None if ns is None else ns[lo:lo + rows].to(dev),
            shard=qexec.ShardEnv(axis_name, s, mesh.group(axis_name, coord)),
            fusion=fusion)

    out = mesh.run(body)
    # every position of a data slice holds the merged result: read the
    # first along every other axis
    parts = [out[c] for c in mesh.positions()
             if all(i == 0 for a, i in enumerate(c) if a != dax)]
    cat = lambda xs: torch.cat([x.to(dev0) for x in xs])  # noqa: E731
    return hi.SearchResult(doc_ids=cat([r.doc_ids for r in parts]),
                           scores=cat([r.scores for r in parts]),
                           n_candidates=cat([r.n_candidates for r in parts]))


def candidate_budget(sindex: ShardedHybridIndex, kc: int, k2: int) -> int:
    """Per-shard candidate slots per query (the latency proxy; the
    single-device budget, since shards keep the global capacity)."""
    return qexec.candidate_budget(
        kc, k2, [(sindex.cluster_entries.shape[2],
                  sindex.term_entries.shape[2])])

"""Serving (port of ``repro/launch/serve.py``: ``ServeConfig``,
``resolve_widths``, ``Server``, ``ShardedServer``, ``MeshServer``,
``MutableServer``, ``make_server``, ``make_mutable_server`` and the
``main`` demo loop).

The dispatch widths resolve once per server (DESIGN.md §14): an
explicit ``ServeConfig`` value, else the index's tuned record
(:mod:`repro_torch.launch.tune`), else :data:`DEFAULT_KC` /
:data:`DEFAULT_K2`.  With ``ServeConfig(adaptive=True)`` over a
multi-rung tuned record the server exposes the record's width ladder
(``rungs``, ``margin_cuts``), which the runtime serves per query.

Serving layouts:

  · :class:`Server` holds one index on one device and pads every
    request batch to ``max_batch``, so each search runs at one shape.
  · :class:`ShardedServer`, the document-sharded layout of DESIGN.md
    §6: the index partitioned over a 1-D mesh of ``n_shards`` positions
    (:mod:`repro_torch.core.sharded_index`), the per-shard top-R merged
    by one all-gather; results equal :class:`Server`'s bit for bit.
  · :class:`MeshServer`, the 2-D (data, model) mesh of DESIGN.md §12:
    shards along the model axis, replicated along ``data_parallel``
    slices that split the query batch.  It survives the loss of a
    model-axis shard by serving the survivors' document ranges
    (``partial=True``) until :meth:`MeshServer.rejoin` restores from a
    checkpoint.
  · :class:`MutableServer` serves a :class:`repro_torch.core.segments.
    MutableHybridIndex` with live ``add``/``delete``/``compact``
    (DESIGN.md §8).  :class:`ShardedMutableServer` serves it over the
    document-sharded layout (a 1-D mesh, or the 2-D (data, model) mesh
    with ``data_parallel``): adds go to the shard that owns their ids,
    and results equal :class:`MutableServer`'s bit for bit.

A mesh's positions take the first cards, one each, unless ``devices=``
places them (``["cuda:0"] * 4`` puts four on one card); ``device="cpu"``
puts them all on the CPU.  Every layout serves hybrid dense∥sparse
fusion (DESIGN.md §13) when ``fusion_weight`` is set
(:meth:`Server.set_fusion` re-weights live).  Every layout serves
behind the micro-batching runtime of :mod:`repro_torch.launch.runtime`
(one CUDA graph per bucket on the card, one per bucket per mesh when
every mesh position shares the card).

    python -m repro_torch.launch.serve --device cpu --codec refine:sq8
    python -m repro_torch.launch.serve --device cpu --fusion-weight 0.5
    python -m repro_torch.launch.serve --device cpu --shards 4
    python -m repro_torch.launch.serve --device cpu --shards 2 \\
        --data-parallel 2
    python -m repro_torch.launch.serve --device cpu --mutable --docs 3000
    python -m repro_torch.launch.serve --device cpu --mutable --shards 2 \\
        --data-parallel 2 --docs 3000
    python -m repro_torch.launch.serve --device cpu --runtime --cache 64
    python -m repro_torch.launch.serve --device cpu --runtime --shards 4
    python -m repro_torch.launch.serve --device cpu --runtime --adaptive

builds an index over the synthetic corpus and serves its queries, as
``python -m repro.launch.serve`` does; ``--fusion-weight W`` builds the
BM25 impact plane and fuses by RRF with dense weight W; ``--shards S``
and ``--data-parallel D`` serve it on a (D, S) mesh (on the card: the
first S·D cards; on the CPU every position is the CPU); ``--mutable``
streams the corpus's last eighth in, deletes a quarter of it and
compacts (with ``--shards``, on the mesh); ``--runtime`` serves any of
these through the runtime and prints its bucket stats.  ``--device``
defaults to ``cuda``, and the device chooses the kernels (no
``--use-kernel``).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import device as dev_mod
from repro_torch.core import codecs
from repro_torch.core import exec as qexec
from repro_torch.core import hybrid_index as hi
from repro_torch.core import segments as seg
from repro_torch.core import sharded_index as shi
from repro_torch.core.exec import filters as ns_filters
from repro_torch.distributed import fault
from repro_torch.launch import mesh as mesh_mod

#: the hand-picked width defaults serving falls back to when neither an
#: explicit ServeConfig override nor a tuned index record is present
DEFAULT_KC, DEFAULT_K2 = 6, 8


@dataclasses.dataclass
class ServeConfig:
    # dispatch widths (DESIGN.md §14): None = resolve at server
    # construction — the index's TunedWidths record when present, else
    # DEFAULT_KC/DEFAULT_K2; an explicit value always wins
    kc: Optional[int] = None
    k2: Optional[int] = None
    top_r: int = 100
    max_batch: int = 64
    n_namespaces: int = 0        # >0 → filtered search over N namespaces
    n_shards: int = 1            # >1 → document-sharded layout (§6)
    data_parallel: int = 1       # >1 → 2-D (data, model) serving mesh (§12)
    mutable: bool = False        # serve a MutableHybridIndex (§8)
    delta_capacity: int = 1024   # delta slots between compactions
    # hybrid dense∥sparse fusion (§13): None = dense-only; else the RRF
    # dense weight in [0, 1] (sparse gets 1-w).  Needs an index built
    # with sparse=True, otherwise the dense-only result is served.
    fusion_weight: Optional[float] = None
    # per-query adaptive widths (§14): route each query to a rung of
    # the tuned ladder by its dispatch-margin difficulty signal.  Only
    # takes effect when the index carries a multi-rung TunedWidths
    # record and no explicit kc/k2 override is set.
    adaptive: bool = False
    # auto-compaction watermarks (§8): compact when the delta fill or
    # the tombstone ratio crosses its threshold; 0 disables (the default)
    compact_fill_watermark: float = 0.0
    compact_tombstone_watermark: float = 0.0


def resolve_widths(cfg: ServeConfig, index) -> tuple:
    """``(kc, k2, source)``, per field: an explicit ``ServeConfig``
    value wins, else the index's :class:`repro_torch.core.exec.
    TunedWidths` record, else :data:`DEFAULT_KC`/:data:`DEFAULT_K2`.
    ``source`` is ``"explicit"`` (any field overridden), ``"tuned"`` or
    ``"default"``; adaptive serving engages only on ``"tuned"``."""
    tuned = getattr(index, "tuned", None)
    fb_kc = tuned.kc if tuned is not None else DEFAULT_KC
    fb_k2 = tuned.k2 if tuned is not None else DEFAULT_K2
    if cfg.kc is not None or cfg.k2 is not None:
        return (int(cfg.kc if cfg.kc is not None else fb_kc),
                int(cfg.k2 if cfg.k2 is not None else fb_k2), "explicit")
    if tuned is not None:
        return int(tuned.kc), int(tuned.k2), "tuned"
    return DEFAULT_KC, DEFAULT_K2, "default"


class Server:
    """Pads request batches to ``max_batch`` and searches them on
    ``device``, where the index is moved once at construction."""

    def __init__(self, index: hi.HybridIndex,
                 cfg: Optional[ServeConfig] = None, *,
                 device: dev_mod.DeviceLike = "cuda"):
        cfg = ServeConfig() if cfg is None else cfg
        self.device = dev_mod.resolve(device)
        self.index = index.to(self.device)
        self.cfg = cfg
        self._resolve_widths(index)
        self.set_fusion(cfg.fusion_weight)
        self.n_served = 0

    def _resolve_widths(self, index) -> None:
        """Resolve (kc, k2) once at construction (DESIGN.md §14): stable
        across mutations and compactions, like the codec spec."""
        self.tuned = getattr(index, "tuned", None)
        self.kc, self.k2, self.width_source = resolve_widths(self.cfg,
                                                             index)

    @classmethod
    def from_checkpoint(cls, path: str, like: Optional[hi.HybridIndex] = None,
                        cfg: Optional[ServeConfig] = None, *,
                        device: dev_mod.DeviceLike = "cuda") -> "Server":
        """A server over a ``save_index`` checkpoint (tuned widths
        included): restored into ``like``'s structure by leaf index when
        it is given (as the reference does), else read by leaf path onto
        ``device``."""
        from repro_torch.checkpoint import checkpoint as ckpt
        index = (ckpt.load_index(path, device=device) if like is None
                 else ckpt.restore_index(path, like))
        return cls(index, cfg, device=device)

    @property
    def epoch(self) -> int:
        """Index mutation counter (DESIGN.md §10): always 0, an immutable
        index never invalidates cached results."""
        return 0

    @property
    def n_replicas(self) -> int:
        """Data-axis replica slices (DESIGN.md §12): 1 on every layout
        but the 2-D mesh."""
        return max(1, int(self.cfg.data_parallel))

    @property
    def partial(self) -> bool:
        """Whether results miss a lost shard's documents (DESIGN.md §12):
        only a degraded :class:`MeshServer` serves partial results."""
        return False

    @property
    def _adaptive_ladder(self) -> bool:
        t = self.tuned
        return (self.cfg.adaptive and t is not None and len(t.rungs) > 1
                and self.width_source != "explicit")

    @property
    def rungs(self) -> tuple:
        """The static width ladder adaptive serving runs, narrow → wide
        (DESIGN.md §14).  A single rung — the resolved (kc, k2) — unless
        adaptivity is on, the index carries a multi-rung tuned record,
        and no explicit override pinned the widths."""
        if self._adaptive_ladder:
            return tuple((int(kc), int(k2)) for kc, k2 in self.tuned.rungs)
        return ((self.kc, self.k2),)

    @property
    def margin_cuts(self) -> tuple:
        """Descending margin thresholds between the rungs (one fewer
        than :attr:`rungs`); empty in the single-rung case."""
        if self._adaptive_ladder:
            return tuple(float(c) for c in self.tuned.margin_cuts)
        return ()

    def sync_device(self) -> None:
        """Bring the index's device planes up to date before a captured
        search replays (:mod:`repro_torch.launch.runtime`); an immutable
        index has nothing to copy."""

    @property
    def fusion(self) -> Optional[qexec.FusionSpec]:
        """The active hybrid-fusion spec, read from ``cfg.fusion_weight``
        at call time; None = dense-only."""
        w = self.cfg.fusion_weight
        return None if w is None else qexec.FusionSpec(weight=float(w))

    def set_fusion(self, weight: Optional[float]) -> None:
        """Re-weight (or disable, with None) hybrid fusion; takes effect
        on the next query."""
        if weight is not None:
            qexec.FusionSpec(weight=float(weight))  # validate eagerly
        self.cfg.fusion_weight = weight

    def _search(self, qe, qt, filter=None, widths=None) -> hi.SearchResult:
        kc, k2 = widths if widths is not None else (self.kc, self.k2)
        return hi.search(self.index, qe, qt, kc=kc, k2=k2,
                         top_r=self.cfg.top_r, filter=filter,
                         fusion=self.fusion, device=self.device)

    def warmup(self, hidden: int, query_len: int) -> None:
        """One full-batch search of PAD queries (builds the kernels)."""
        qe = torch.zeros((self.cfg.max_batch, hidden), device=self.device)
        qt = torch.full((self.cfg.max_batch, query_len), -1,
                        dtype=torch.int64, device=self.device)
        self._search(qe, qt)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _pad(self, query_emb, query_tokens):
        qe = dev_mod.as_tensor(query_emb, self.device, torch.float32)
        qt = dev_mod.as_tensor(query_tokens, self.device, torch.int64)
        n = qe.shape[0]
        pad = self.cfg.max_batch - n
        if pad < 0:
            raise ValueError(f"batch {n} exceeds max_batch "
                             f"{self.cfg.max_batch}")
        qe = torch.nn.functional.pad(qe, (0, 0, 0, pad))
        qt = torch.nn.functional.pad(qt, (0, 0, 0, pad), value=-1)
        return n, qe, qt

    def _filter(self, namespaces, n: int):
        """Per-query ``namespaces`` (one id or iterable per query) → the
        padded (max_batch, W) bitmap; padded rows match nothing."""
        if namespaces is None:
            return None
        if not self.cfg.n_namespaces:
            raise ValueError("this server was built without namespaces; "
                             "construct with ServeConfig(n_namespaces=N)")
        if len(namespaces) != n:
            raise ValueError(f"{len(namespaces)} filter rows for {n} "
                             "queries")
        bitmap = ns_filters.make_filter(namespaces, self.cfg.n_namespaces,
                                        device=self.device)
        return ns_filters.pad_filter(bitmap, self.cfg.max_batch)

    def query(self, query_emb, query_tokens,
              namespaces=None) -> hi.SearchResult:
        """Search ``n ≤ max_batch`` queries; results stay on the device."""
        n, qe, qt = self._pad(query_emb, query_tokens)
        res = self._search(qe, qt, filter=self._filter(namespaces, n))
        self.n_served += n
        return hi.SearchResult(doc_ids=res.doc_ids[:n],
                               scores=res.scores[:n],
                               n_candidates=res.n_candidates[:n],
                               partial=bool(res.partial))

    # mutation API: live only on MutableServer
    def add(self, doc_emb, doc_tokens, namespaces=None) -> np.ndarray:
        raise RuntimeError("this server is immutable; construct with "
                           "make_mutable_server / --mutable to enable "
                           "add/delete/compact")

    def delete(self, doc_ids) -> None:
        self.add(None, None)     # the same immutability error

    def compact(self) -> None:
        self.add(None, None)


def _positions(devices, device, n: int):
    """The devices of a mesh of ``n`` positions: ``devices`` when given,
    all ``n`` on the CPU when ``device`` is the CPU, else None (the first
    ``n`` cards)."""
    if devices is not None:
        return devices
    return ["cpu"] * n if dev_mod.resolve(device).type == "cpu" else None


class ShardedServer(Server):
    """Document-sharded serving (DESIGN.md §6): the request contract of
    :class:`Server` and its results bit for bit, the index split over a
    1-D mesh of ``cfg.n_shards`` positions (``mesh``, else one from
    ``devices``/``device``, see :func:`_positions`).  Queries and results
    live on the first position's device."""

    def __init__(self, index: hi.HybridIndex,
                 cfg: Optional[ServeConfig] = None, mesh=None, *,
                 devices=None, device: dev_mod.DeviceLike = "cuda"):
        self.cfg = ServeConfig() if cfg is None else cfg
        # widths resolve from the input index: the sharded form drops
        # the tuned record (per-index metadata, not per-shard)
        self._resolve_widths(index)
        self.mesh = mesh or shi.make_shard_mesh(
            self.cfg.n_shards,
            devices=_positions(devices, device, self.cfg.n_shards))
        self.device = self.mesh.devices.flat[0]
        self.index = shi.device_put(shi.partition(index, self.cfg.n_shards),
                                    self.mesh)
        self.set_fusion(self.cfg.fusion_weight)
        self.n_served = 0

    def _search(self, qe, qt, filter=None, widths=None) -> hi.SearchResult:
        kc, k2 = widths if widths is not None else (self.kc, self.k2)
        return shi.search(self.index, qe, qt, kc=kc, k2=k2,
                          top_r=self.cfg.top_r, mesh=self.mesh,
                          filter=filter, fusion=self.fusion)


class MeshServer(Server):
    """2-D (data, model) mesh serving with shard-loss degradation
    (DESIGN.md §12).

    The index is partitioned into ``cfg.n_shards`` document shards along
    the model axis and replicated along ``cfg.data_parallel`` data-axis
    slices; each slice searches its block of the query batch, and every
    result equals the single-device search bit for bit (the §6 merge
    runs per slice over the model axis only).

    :meth:`eject_shard` drops one model-axis shard from the serving set:
    requests are then served from the survivors' document ranges,
    flagged ``partial=True``, and :meth:`rejoin` restores the full mesh
    from a :meth:`checkpoint`, bit-identical to the results before the
    failure.  Both bump :attr:`epoch`, so a result cache never replays
    full results while degraded or the reverse."""

    def __init__(self, index: hi.HybridIndex,
                 cfg: Optional[ServeConfig] = None, mesh=None, *,
                 devices=None, device: dev_mod.DeviceLike = "cuda"):
        cfg = ServeConfig() if cfg is None else cfg
        data, model = max(1, int(cfg.data_parallel)), int(cfg.n_shards)
        if cfg.max_batch % data:
            raise ValueError(f"max_batch {cfg.max_batch} must divide over "
                             f"{data} data-axis slices")
        self.cfg = cfg
        self._resolve_widths(index)
        self.data, self.model = data, model
        self.data_axis = "data"
        self.mesh = mesh or mesh_mod.make_serving_mesh(
            data, model, devices=_positions(devices, device, data * model))
        self.device = self.mesh.devices.flat[0]
        self._full = shi.device_put(shi.partition(index, model), self.mesh)
        self.index = self._full
        # shapes and dtypes only: rejoin restores from the checkpoint,
        # never from the live planes
        self._template = shi.to_meta(self._full)
        self.health = fault.ShardHealth(model)
        self._survivor = None    # (sub_index, sub_mesh, offsets) | None
        self._mesh_epoch = 0
        self.set_fusion(cfg.fusion_weight)
        self.n_served = 0

    @property
    def epoch(self) -> int:
        """Bumps on every membership change (eject/rejoin): degraded and
        full results never share a cache key."""
        return self._mesh_epoch

    @property
    def partial(self) -> bool:
        return self.health.degraded

    def _search(self, qe, qt, filter=None, widths=None) -> hi.SearchResult:
        kc, k2 = widths if widths is not None else (self.kc, self.k2)
        da = self.data_axis if self.data > 1 else None
        kw = dict(kc=kc, k2=k2, top_r=self.cfg.top_r, filter=filter,
                  data_axis=da, fusion=self.fusion)
        if self._survivor is None:
            return shi.search(self._full, qe, qt, mesh=self.mesh, **kw)
        sub, sub_mesh, offsets = self._survivor
        res = shi.search(sub, qe, qt, mesh=sub_mesh, shard_offsets=offsets,
                         **kw)
        return res._replace(partial=True)

    # --- shard-loss degradation + recovery -------------------------------
    def note_shard_latency(self, shard: int, dt: float) -> bool:
        """Feed one measured per-shard latency into the straggler policy
        (:class:`repro_torch.distributed.fault.ShardHealth`); ejects the
        shard and returns True once it crosses ``MAX_STRIKES`` deadline
        misses."""
        if self.health.observe(shard, dt):
            self.eject_shard(shard)
            return True
        return False

    def eject_shard(self, shard: int) -> None:
        """Drop one model-axis shard from the serving set: later queries
        are served from the survivors' document ranges and flagged
        ``partial=True``.  Idempotent per shard; the last healthy shard
        cannot be ejected.  The survivors keep their positions' devices
        and planes (no copy)."""
        if shard in self.health.lost:
            return
        self.health.eject(shard)
        survivors = self.health.healthy
        sub_mesh = mesh_mod.make_serving_mesh(
            self.data, len(survivors),
            devices=list(self.mesh.devices[:, survivors].flat))
        sub = shi.device_put(shi.take_shards(self._full, survivors),
                             sub_mesh)
        offsets = shi.shard_offsets_for(survivors, self._full.docs_per_shard)
        self._survivor = (sub, sub_mesh, offsets)
        # a new index object: a runtime over this server builds its
        # programs again for the survivors' mesh
        self.index = sub
        self._mesh_epoch += 1

    def lost_doc_ranges(self) -> list:
        """[lo, hi) global doc-id ranges missing from results now, the
        degradation contract (DESIGN.md §12)."""
        per, n = self._full.docs_per_shard, self._full.n_docs
        return [(m * per, min((m + 1) * per, n)) for m in self.health.lost]

    def checkpoint(self, directory: str, step: int = 0) -> str:
        """Persist the full sharded index (codec spec in the manifest) in
        the reference's leaf layout; the path feeds :meth:`rejoin`."""
        from repro_torch.checkpoint import checkpoint as ckpt
        return ckpt.save_index(directory, step, self._full)

    def rejoin(self, checkpoint_path: str) -> None:
        """Restore the full mesh from a checkpoint: every lost shard
        returns, and results equal those before the failure bit for bit
        (one more epoch bump keeps caches honest)."""
        from repro_torch.checkpoint import checkpoint as ckpt
        restored = ckpt.restore_index(checkpoint_path, self._template)
        self._full = shi.device_put(restored, self.mesh)
        self.index = self._full
        self.health.rejoin()
        self._survivor = None
        self._mesh_epoch += 1


class MutableServer(Server):
    """Serving over a :class:`repro_torch.core.segments.
    MutableHybridIndex` (DESIGN.md §8): the padded-batch request
    contract of :class:`Server`, plus live ``add``/``delete``/
    ``compact``.  Mutations change plane values, never shapes; the index
    stays on its own device."""

    def __init__(self, mut: seg.MutableHybridIndex,
                 cfg: Optional[ServeConfig] = None):
        cfg = ServeConfig(mutable=True) if cfg is None else cfg
        self.mut = mut
        self.device = mut.device
        self.index = mut.base    # the padded-query plumbing reads it
        self.cfg = cfg
        # resolved from the base once: compaction's fresh base carries
        # no tuned record, and the widths must not move under it
        self._resolve_widths(mut.base)
        self.set_fusion(cfg.fusion_weight)
        self.n_served = 0

    def _search(self, qe, qt, filter=None, widths=None) -> hi.SearchResult:
        kc, k2 = widths if widths is not None else (self.kc, self.k2)
        return self.mut.search(qe, qt, kc=kc, k2=k2,
                               top_r=self.cfg.top_r, filter=filter,
                               fusion=self.fusion)

    @property
    def epoch(self) -> int:
        """The mutable index's mutation counter: bumps on every
        ``add``/``delete`` and across ``compact`` (DESIGN.md §10)."""
        return self.mut.epoch

    def sync_device(self) -> None:
        """Copy the delta planes and the tombstones of the current epoch
        into their device tensors, in place."""
        self.mut.sync_device()

    def add(self, doc_emb, doc_tokens, namespaces=None) -> np.ndarray:
        """Index new documents; returns their global doc ids.  On a
        namespaced server ``namespaces`` (one id or (n,) ids) is
        required."""
        ids = self.mut.add_docs(doc_emb, doc_tokens, namespaces=namespaces)
        self._auto_compact()
        return ids

    def delete(self, doc_ids) -> None:
        """Tombstone documents; they can never appear in results again."""
        self.mut.delete_docs(doc_ids)
        self._auto_compact()

    def _auto_compact(self) -> None:
        """Compact when the delta fill or the tombstone ratio crosses its
        configured watermark (both 0.0 = off by default)."""
        fill = self.cfg.compact_fill_watermark
        tomb = self.cfg.compact_tombstone_watermark
        if fill <= 0.0 and tomb <= 0.0:
            return
        if self.mut.needs_compact(fill_watermark=fill,
                                  tombstone_watermark=tomb):
            self.compact()

    def compact(self) -> None:
        """Fold delta + tombstones into a fresh base (equal to a
        from-scratch build over the surviving corpus)."""
        self.mut = self.mut.compact()
        self.index = self.mut.base


class ShardedMutableServer(MutableServer):
    """Mutable and document-sharded (DESIGN.md §6, §8, §12): a
    :class:`repro_torch.core.segments.ShardedMutableIndex` over
    ``cfg.n_shards`` positions, replicated over ``cfg.data_parallel``
    data-axis slices that split the query batch when it is above 1.
    Adds go to the shard that owns their ids; results equal
    :class:`MutableServer`'s bit for bit.  The mesh is ``mesh``, else
    one from ``devices``/``device`` (:func:`_positions`); queries and
    results live on its first position's device."""

    def __init__(self, mut: seg.MutableHybridIndex,
                 cfg: Optional[ServeConfig] = None, mesh=None, *,
                 devices=None, device: dev_mod.DeviceLike = "cuda"):
        cfg = ServeConfig(mutable=True) if cfg is None else cfg
        data, model = max(1, int(cfg.data_parallel)), int(cfg.n_shards)
        if cfg.max_batch % data:
            raise ValueError(f"max_batch {cfg.max_batch} must divide over "
                             f"{data} data-axis slices")
        self.cfg = cfg
        # resolved from the base once, as MutableServer's
        self._resolve_widths(mut.base)
        if mesh is None:
            pos = _positions(devices, device, data * model)
            mesh = (mesh_mod.make_serving_mesh(data, model, devices=pos)
                    if data > 1 else shi.make_shard_mesh(model, devices=pos))
        self.mesh = mesh
        self.mut = seg.ShardedMutableIndex(
            mut, model, mesh, data_axis="data" if data > 1 else None)
        self.device = mesh.devices.flat[0]
        self.index = mut.base
        self.set_fusion(cfg.fusion_weight)
        self.n_served = 0


def make_server(index: hi.HybridIndex, cfg: ServeConfig, *,
                device: dev_mod.DeviceLike = "cuda") -> Server:
    """The server for ``cfg``: :class:`MeshServer` for ``data_parallel >
    1``, :class:`ShardedServer` for ``n_shards > 1``, else
    :class:`Server` (a mutable one is :func:`make_mutable_server`'s).
    A mesh takes the first cards, or the CPU for ``device="cpu"``; build
    the mesh server with ``devices=`` to place its positions."""
    if cfg.mutable:
        raise ValueError("make_server serves a built immutable index; "
                         "use make_mutable_server(mut, cfg) for "
                         "ServeConfig(mutable=True)")
    if cfg.data_parallel > 1:
        return MeshServer(index, cfg, device=device)
    if cfg.n_shards > 1:
        return ShardedServer(index, cfg, device=device)
    return Server(index, cfg, device=device)


def make_mutable_server(mut: seg.MutableHybridIndex, cfg: ServeConfig, *,
                        device: dev_mod.DeviceLike = "cuda"
                        ) -> MutableServer:
    """A :class:`ShardedMutableServer` for ``n_shards > 1`` or
    ``data_parallel > 1`` (its mesh on the first cards, or the CPU for
    ``device="cpu"``), else a :class:`MutableServer`; ``mut`` must live
    on ``device``."""
    dev = dev_mod.resolve(device)
    if mut.device != dev:
        raise ValueError(f"mutable index lives on {mut.device}, serving "
                         f"asked for {dev}; create it with device="
                         f"{str(dev)!r}")
    if cfg.n_shards > 1 or cfg.data_parallel > 1:
        return ShardedMutableServer(mut, cfg, device=dev)
    return MutableServer(mut, cfg)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description="HI² serving demo loop")
    ap.add_argument("--docs", type=int, default=8000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--codec", default=codecs.DEFAULT,
                    metavar="|".join(codecs.registered()),
                    help="any registered codec spec, e.g. sq8 or refine:pq:4")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--kc", type=int, default=None,
                    help="clusters probed per query; default = the "
                         "index's tuned record if present, else "
                         f"{DEFAULT_KC} (DESIGN.md §14)")
    ap.add_argument("--k2", type=int, default=None,
                    help="term lists probed per query; default = the "
                         "index's tuned record if present, else "
                         f"{DEFAULT_K2}")
    ap.add_argument("--adaptive", action="store_true",
                    help="per-query adaptive widths over the tuned rung "
                         "ladder (needs an index tuned by "
                         "repro_torch.launch.tune; DESIGN.md §14)")
    ap.add_argument("--namespaces", type=int, default=0,
                    help="partition the corpus into N namespaces and demo "
                         "per-query filtered search (DESIGN.md §9)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the hand-written kernels) or cpu "
                         "(their plain PyTorch versions)")
    ap.add_argument("--shards", type=int, default=1,
                    help="document shards (mesh positions; DESIGN.md §6)")
    ap.add_argument("--data-parallel", type=int, default=1,
                    help="data-axis replica slices of the 2-D serving mesh "
                         "(DESIGN.md §12); shards x replicas positions")
    ap.add_argument("--runtime", action="store_true",
                    help="serve through the micro-batching runtime "
                         "(DESIGN.md §10; one CUDA graph per bucket on the "
                         "card) instead of direct batched calls")
    ap.add_argument("--linger-ms", type=float, default=2.0,
                    help="max wait of the oldest queued request for "
                         "co-riders before its bucket executes (--runtime)")
    ap.add_argument("--cache", type=int, default=0,
                    help="LRU query-result cache entries, 0 = off "
                         "(--runtime)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="with --runtime: serve plaintext metrics on "
                         "http://127.0.0.1:PORT/metrics (0 = ephemeral)")
    ap.add_argument("--mutable", action="store_true",
                    help="serve a mutable index and demo live "
                         "add/delete/compact (DESIGN.md §8)")
    ap.add_argument("--delta-capacity", type=int, default=1024,
                    help="delta slots between compactions (--mutable)")
    ap.add_argument("--fusion-weight", type=float, default=None,
                    metavar="W",
                    help="hybrid dense∥sparse serving (DESIGN.md §13): "
                         "build the BM25 impact plane and fuse dense and "
                         "sparse rankings by RRF with dense weight W in "
                         "[0,1] (1.0 = dense-only, 0.0 = pure lexical)")
    args = ap.parse_args(argv)
    codecs.get(args.codec)   # fail fast (with the registered names) on typos
    dev = dev_mod.resolve(args.device)

    from repro_torch.data import synthetic
    corpus = synthetic.generate(seed=0, n_docs=args.docs,
                                n_queries=args.queries,
                                hidden=64, vocab_size=4096)
    # round-robin tenant assignment for the demo corpus
    doc_ns = (np.arange(args.docs) % args.namespaces
              if args.namespaces else None)
    build_kwargs = dict(n_clusters=128, k1_terms=10, codec=args.codec,
                        pq_m=8, pq_k=256, cluster_capacity=192,
                        term_capacity=96, kmeans_iters=8,
                        sparse=args.fusion_weight is not None)
    cfg = ServeConfig(kc=args.kc, k2=args.k2, adaptive=args.adaptive,
                      max_batch=args.batch,
                      mutable=args.mutable,
                      delta_capacity=args.delta_capacity,
                      n_namespaces=args.namespaces,
                      n_shards=args.shards,
                      data_parallel=args.data_parallel,
                      fusion_weight=args.fusion_weight)
    if args.mutable:
        if args.docs < 512:
            sys.exit("--mutable demo needs --docs >= 512 (the base build "
                     "must keep enough docs for KMeans after the held-out "
                     "stream is split off)")
        # stream the last ~1/8 of the corpus in live, then compact;
        # never more than the delta can hold or half the corpus
        held = max(args.batch, args.docs // 8)
        held = min(held, args.delta_capacity, args.docs // 2)
        mut = seg.MutableHybridIndex.create(
            0, corpus.doc_emb[:-held], corpus.doc_tokens[:-held],
            corpus.vocab_size, delta_capacity=args.delta_capacity,
            doc_namespaces=None if doc_ns is None else doc_ns[:-held],
            device=dev, **build_kwargs)
        server = make_mutable_server(mut, cfg, device=dev)
    else:
        index = hi.build(0, corpus.doc_emb, corpus.doc_tokens,
                         corpus.vocab_size, doc_namespaces=doc_ns,
                         device=dev, **build_kwargs)
        server = make_server(index, cfg, device=dev)
    metrics = None
    if args.runtime:
        from repro_torch.launch import runtime as rt_mod
        front = rt_mod.ServingRuntime(
            server, rt_mod.RuntimeConfig(
                linger_ms=args.linger_ms, cache_size=args.cache,
                # the demo submits whole batches back-to-back; admission
                # control must not reject the demo's own requests
                queue_depth=max(256, 2 * args.batch)))
        front.warmup(64, corpus.query_tokens.shape[1])
        if args.metrics_port is not None:
            metrics = front.serve_metrics(args.metrics_port)
            print(f"metrics: http://127.0.0.1:{metrics.port}/metrics")
    else:
        front = server
        server.warmup(64, corpus.query_tokens.shape[1])
    t0 = time.perf_counter()
    for i in range(0, args.queries, args.batch):
        front.query(corpus.query_emb[i:i + args.batch],
                    corpus.query_tokens[i:i + args.batch])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if args.data_parallel > 1:
        layout = f"({args.data_parallel}, {args.shards}) mesh"
    elif args.shards > 1:
        layout = f"{args.shards} shard(s)"
    else:
        layout = "1 device"
    print(f"served {server.n_served} queries in {dt:.3f}s "
          f"({server.n_served / dt:.0f} q/s, {layout})")
    if args.namespaces:
        # each query restricted to one tenant; results must honor it
        b = min(args.batch, args.queries)
        want = [i % args.namespaces for i in range(b)]
        res = front.query(corpus.query_emb[:b], corpus.query_tokens[:b],
                          namespaces=want)
        ids = np.asarray(torch.as_tensor(res.doc_ids).cpu())
        n_cand = torch.as_tensor(res.n_candidates).float()
        ok = all((ids[i][ids[i] >= 0] % args.namespaces == want[i]).all()
                 for i in range(b))
        print(f"filtered: {b} queries x 1/{args.namespaces} namespaces, "
              f"mean candidates {float(n_cand.mean()):.0f}, "
              f"tenant isolation {'OK' if ok else 'VIOLATED'}")
        if not ok:
            sys.exit("namespace filter violated tenant isolation")
    if args.mutable:
        ids = front.add(corpus.doc_emb[-held:], corpus.doc_tokens[-held:],
                        namespaces=(None if not args.namespaces else
                                    doc_ns[-held:]))
        front.query(corpus.query_emb[:args.batch],
                    corpus.query_tokens[:args.batch])
        front.delete(ids[: held // 4])
        t0 = time.perf_counter()
        front.compact()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt_c = time.perf_counter() - t0
        print(f"mutable: added {held}, deleted {held // 4}, "
              f"compacted to {server.index.n_docs} docs in {dt_c:.2f}s")
    if args.runtime:
        if metrics is not None:
            metrics.close()
        front.close(drain=True)
        s = front.stats()
        cache = s["cache"]
        print(f"runtime: {s['n_batches']} batches over buckets "
              f"{s['buckets']} (counts {s['bucket_counts']}), "
              f"programs/bucket {s['warm_traces']}, "
              f"{s['post_warmup_traces']} post-warmup programs"
              + ("" if cache is None else
                 f", cache {cache['hits']} hits / {cache['misses']} "
                 f"misses"))


if __name__ == "__main__":
    main()

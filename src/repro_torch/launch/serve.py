"""Single-device serving (port of ``repro/launch/serve.py``:
``ServeConfig``, ``resolve_widths``, ``Server``, ``MutableServer``,
``make_server``, ``make_mutable_server`` and the ``main`` demo loop).

:class:`Server` holds one index on one device and pads every request
batch to ``max_batch``, so each search runs at one shape.  It serves
hybrid dense∥sparse fusion (DESIGN.md §13) when ``fusion_weight`` is
set: :meth:`Server.set_fusion` re-weights live.  :class:`MutableServer`
serves a :class:`repro_torch.core.segments.MutableHybridIndex` with live
``add``/``delete``/``compact`` (DESIGN.md §8).  The sharded, 2-D mesh
and micro-batching layouts of the reference are not yet ported: asking
for them raises.

    python -m repro_torch.launch.serve --device cpu --codec refine:sq8
    python -m repro_torch.launch.serve --device cpu --fusion-weight 0.5
    python -m repro_torch.launch.serve --device cpu --mutable --docs 3000

builds an index over the synthetic corpus and serves its queries, as
``python -m repro.launch.serve`` does; ``--fusion-weight W`` builds the
BM25 impact plane and fuses by RRF with dense weight W; ``--mutable``
streams the corpus's last eighth in, deletes a quarter of it and
compacts.  ``--device`` defaults to ``cuda``, and the device chooses the
kernels (no ``--use-kernel``).
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
from repro_torch.core.exec import filters as ns_filters

#: the hand-picked width defaults when no explicit width is set
DEFAULT_KC, DEFAULT_K2 = 6, 8


@dataclasses.dataclass
class ServeConfig:
    kc: Optional[int] = None     # None → DEFAULT_KC
    k2: Optional[int] = None     # None → DEFAULT_K2
    top_r: int = 100
    max_batch: int = 64
    n_namespaces: int = 0        # >0 → filtered search over N namespaces
    n_shards: int = 1            # >1: sharded layout, not yet ported
    data_parallel: int = 1       # >1: 2-D serving mesh, not yet ported
    mutable: bool = False        # serve a MutableHybridIndex (§8)
    delta_capacity: int = 1024   # delta slots between compactions
    # hybrid dense∥sparse fusion (§13): None = dense-only; else the RRF
    # dense weight in [0, 1] (sparse gets 1-w).  Needs an index built
    # with sparse=True, otherwise the dense-only result is served.
    fusion_weight: Optional[float] = None
    # auto-compaction watermarks (§8): compact when the delta fill or
    # the tombstone ratio crosses its threshold; 0 disables (the default)
    compact_fill_watermark: float = 0.0
    compact_tombstone_watermark: float = 0.0


def resolve_widths(cfg: ServeConfig, index) -> tuple:
    """``(kc, k2, source)``: an explicit ``ServeConfig`` value wins,
    else the defaults.  (Tuned widths are not yet ported, and
    :func:`repro_torch.checkpoint.checkpoint.load_index` refuses an
    index that carries them.)"""
    if cfg.kc is not None or cfg.k2 is not None:
        return (int(cfg.kc if cfg.kc is not None else DEFAULT_KC),
                int(cfg.k2 if cfg.k2 is not None else DEFAULT_K2),
                "explicit")
    return DEFAULT_KC, DEFAULT_K2, "default"


class Server:
    """Pads request batches to ``max_batch`` and searches them on
    ``device``, where the index is moved once at construction."""

    def __init__(self, index: hi.HybridIndex,
                 cfg: Optional[ServeConfig] = None, *,
                 device: dev_mod.DeviceLike = "cuda"):
        cfg = ServeConfig() if cfg is None else cfg
        for field, default, what in (("n_shards", 1, "sharded serving"),
                                     ("data_parallel", 1, "mesh serving")):
            if getattr(cfg, field) != default:
                raise NotImplementedError(f"{what} ({field}=) is not yet "
                                          "ported to repro_torch")
        self.device = dev_mod.resolve(device)
        self.index = index.to(self.device)
        self.cfg = cfg
        self.kc, self.k2, self.width_source = resolve_widths(cfg, index)
        self.set_fusion(cfg.fusion_weight)
        self.n_served = 0

    @property
    def epoch(self) -> int:
        """Index mutation counter (DESIGN.md §10): always 0, an immutable
        index never invalidates cached results."""
        return 0

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

    def _search(self, qe, qt, filter=None) -> hi.SearchResult:
        return hi.search(self.index, qe, qt, kc=self.kc, k2=self.k2,
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
                               partial=False)

    # mutation API: live only on MutableServer
    def add(self, doc_emb, doc_tokens, namespaces=None) -> np.ndarray:
        raise RuntimeError("this server is immutable; construct with "
                           "make_mutable_server / --mutable to enable "
                           "add/delete/compact")

    def delete(self, doc_ids) -> None:
        self.add(None, None)     # the same immutability error

    def compact(self) -> None:
        self.add(None, None)


class MutableServer(Server):
    """Serving over a :class:`repro_torch.core.segments.
    MutableHybridIndex` (DESIGN.md §8): the padded-batch request
    contract of :class:`Server`, plus live ``add``/``delete``/
    ``compact``.  Mutations change plane values, never shapes; the index
    stays on its own device."""

    def __init__(self, mut: seg.MutableHybridIndex,
                 cfg: Optional[ServeConfig] = None):
        cfg = ServeConfig(mutable=True) if cfg is None else cfg
        if cfg.n_shards != 1 or cfg.data_parallel != 1:
            raise NotImplementedError("sharded mutable serving (n_shards=, "
                                      "data_parallel=) is not yet ported "
                                      "to repro_torch")
        self.mut = mut
        self.device = mut.device
        self.index = mut.base    # the padded-query plumbing reads it
        self.cfg = cfg
        self.kc, self.k2, self.width_source = resolve_widths(cfg, mut.base)
        self.set_fusion(cfg.fusion_weight)
        self.n_served = 0

    def _search(self, qe, qt, filter=None) -> hi.SearchResult:
        return self.mut.search(qe, qt, kc=self.kc, k2=self.k2,
                               top_r=self.cfg.top_r, filter=filter,
                               fusion=self.fusion)

    @property
    def epoch(self) -> int:
        """The mutable index's mutation counter: bumps on every
        ``add``/``delete`` and across ``compact`` (DESIGN.md §10)."""
        return self.mut.epoch

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


def make_server(index: hi.HybridIndex, cfg: ServeConfig, *,
                device: dev_mod.DeviceLike = "cuda") -> Server:
    """The server for ``cfg``: the single-device :class:`Server` (other
    layouts raise "not yet ported"; a mutable one is
    :func:`make_mutable_server`'s)."""
    if cfg.mutable:
        raise ValueError("make_server serves a built immutable index; "
                         "use make_mutable_server(mut, cfg) for "
                         "ServeConfig(mutable=True)")
    return Server(index, cfg, device=device)


def make_mutable_server(mut: seg.MutableHybridIndex, cfg: ServeConfig, *,
                        device: dev_mod.DeviceLike = "cuda"
                        ) -> MutableServer:
    """A :class:`MutableServer` for ``mut``, which must live on
    ``device`` (the sharded mutable layout raises "not yet ported")."""
    dev = dev_mod.resolve(device)
    if mut.device != dev:
        raise ValueError(f"mutable index lives on {mut.device}, serving "
                         f"asked for {dev}; create it with device="
                         f"{str(dev)!r}")
    return MutableServer(mut, cfg)


#: reference flags whose layouts are not yet ported (flag → its default)
_UNPORTED_FLAGS = {"shards": 1, "data_parallel": 1, "runtime": False}


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description="HI² serving demo loop")
    ap.add_argument("--docs", type=int, default=8000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--codec", default=codecs.DEFAULT,
                    metavar="|".join(codecs.registered()),
                    help="any registered codec spec, e.g. sq8 or refine:pq:4")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--kc", type=int, default=None,
                    help=f"clusters probed per query (default {DEFAULT_KC})")
    ap.add_argument("--k2", type=int, default=None,
                    help=f"term lists probed per query (default "
                         f"{DEFAULT_K2})")
    ap.add_argument("--namespaces", type=int, default=0,
                    help="partition the corpus into N namespaces and demo "
                         "per-query filtered search (DESIGN.md §9)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the hand-written kernels) or cpu "
                         "(their plain PyTorch versions)")
    for flag in ("--shards", "--data-parallel"):
        ap.add_argument(flag, type=int, default=1, help="not yet ported")
    ap.add_argument("--runtime", action="store_true", help="not yet ported")
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
    for field, default in _UNPORTED_FLAGS.items():
        if getattr(args, field) != default:
            raise NotImplementedError(
                f"--{field.replace('_', '-')} is not yet ported to "
                "repro_torch")
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
    cfg = ServeConfig(kc=args.kc, k2=args.k2, max_batch=args.batch,
                      mutable=args.mutable,
                      delta_capacity=args.delta_capacity,
                      n_namespaces=args.namespaces,
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
    server.warmup(64, corpus.query_tokens.shape[1])
    t0 = time.perf_counter()
    for i in range(0, args.queries, args.batch):
        server.query(corpus.query_emb[i:i + args.batch],
                     corpus.query_tokens[i:i + args.batch])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"served {server.n_served} queries in {dt:.3f}s "
          f"({server.n_served / dt:.0f} q/s, 1 device)")
    if args.namespaces:
        # each query restricted to one tenant; results must honor it
        b = min(args.batch, args.queries)
        want = [i % args.namespaces for i in range(b)]
        res = server.query(corpus.query_emb[:b], corpus.query_tokens[:b],
                           namespaces=want)
        ids = res.doc_ids.cpu().numpy()
        ok = all((ids[i][ids[i] >= 0] % args.namespaces == want[i]).all()
                 for i in range(b))
        print(f"filtered: {b} queries x 1/{args.namespaces} namespaces, "
              f"mean candidates "
              f"{float(res.n_candidates.float().mean()):.0f}, "
              f"tenant isolation {'OK' if ok else 'VIOLATED'}")
        if not ok:
            sys.exit("namespace filter violated tenant isolation")
    if args.mutable:
        ids = server.add(corpus.doc_emb[-held:], corpus.doc_tokens[-held:],
                         namespaces=(None if not args.namespaces else
                                     doc_ns[-held:]))
        server.query(corpus.query_emb[:args.batch],
                     corpus.query_tokens[:args.batch])
        server.delete(ids[: held // 4])
        t0 = time.perf_counter()
        server.compact()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt_c = time.perf_counter() - t0
        print(f"mutable: added {held}, deleted {held // 4}, "
              f"compacted to {server.mut.n_base} docs in {dt_c:.2f}s")


if __name__ == "__main__":
    main()

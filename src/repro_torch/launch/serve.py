"""Single-device serving (port of ``repro/launch/serve.py``:
``ServeConfig``, ``resolve_widths``, ``Server``, ``MutableServer``,
``make_server``, ``make_mutable_server`` and the ``main`` demo loop).

The dispatch widths resolve once per server (DESIGN.md §14): an
explicit ``ServeConfig`` value, else the index's tuned record
(:mod:`repro_torch.launch.tune`), else :data:`DEFAULT_KC` /
:data:`DEFAULT_K2`.  With ``ServeConfig(adaptive=True)`` over a
multi-rung tuned record the server exposes the record's width ladder
(``rungs``, ``margin_cuts``), which the runtime serves per query.

:class:`Server` holds one index on one device and pads every request
batch to ``max_batch``, so each search runs at one shape.  It serves
hybrid dense∥sparse fusion (DESIGN.md §13) when ``fusion_weight`` is
set: :meth:`Server.set_fusion` re-weights live.  :class:`MutableServer`
serves a :class:`repro_torch.core.segments.MutableHybridIndex` with live
``add``/``delete``/``compact`` (DESIGN.md §8).  Either serves behind the
micro-batching runtime of :mod:`repro_torch.launch.runtime` (one CUDA
graph per bucket on the card).  The sharded and 2-D mesh layouts of the
reference are not yet ported: asking for them raises.

    python -m repro_torch.launch.serve --device cpu --codec refine:sq8
    python -m repro_torch.launch.serve --device cpu --fusion-weight 0.5
    python -m repro_torch.launch.serve --device cpu --mutable --docs 3000
    python -m repro_torch.launch.serve --device cpu --runtime --cache 64
    python -m repro_torch.launch.serve --device cpu --runtime --adaptive

builds an index over the synthetic corpus and serves its queries, as
``python -m repro.launch.serve`` does; ``--fusion-weight W`` builds the
BM25 impact plane and fuses by RRF with dense weight W; ``--mutable``
streams the corpus's last eighth in, deletes a quarter of it and
compacts; ``--runtime`` serves through the runtime and prints its
bucket stats.  ``--device`` defaults to ``cuda``, and the device chooses
the kernels (no ``--use-kernel``).
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
    n_shards: int = 1            # >1: sharded layout, not yet ported
    data_parallel: int = 1       # >1: 2-D serving mesh, not yet ported
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
        for field, default, what in (("n_shards", 1, "sharded serving"),
                                     ("data_parallel", 1, "mesh serving")):
            if getattr(cfg, field) != default:
                raise NotImplementedError(f"{what} ({field}=) is not yet "
                                          "ported to repro_torch")
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
_UNPORTED_FLAGS = {"shards": 1, "data_parallel": 1}


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
    for flag in ("--shards", "--data-parallel"):
        ap.add_argument(flag, type=int, default=1, help="not yet ported")
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
    cfg = ServeConfig(kc=args.kc, k2=args.k2, adaptive=args.adaptive,
                      max_batch=args.batch,
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
    print(f"served {server.n_served} queries in {dt:.3f}s "
          f"({server.n_served / dt:.0f} q/s, 1 device)")
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
              f"compacted to {server.mut.n_base} docs in {dt_c:.2f}s")
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

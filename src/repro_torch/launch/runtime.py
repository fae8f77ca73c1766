"""Serving runtime (port of ``repro/launch/runtime.py``: ``MIN_BUCKET``,
``CACHE_QUANT``, ``RuntimeOverloaded``, ``RuntimeClosed``,
``RuntimeConfig``, ``bucket_sizes``, ``QueryCache``, ``ServingRuntime``,
``render_metrics`` and ``MetricsServer``; DESIGN.md §10, §12):
bucketed micro-batching, an epoch-keyed LRU result cache, and admission
control in front of any server of :mod:`repro_torch.launch.serve` —
``Server``, ``MutableServer``, and the mesh layouts ``ShardedServer``,
``MeshServer`` and ``ShardedMutableServer``.

``Server.query`` is a synchronous, caller-batched API that pads every
batch to ``max_batch``.  Real traffic is many independent clients
submitting one query each; this module is the layer between them and
the search programs:

  · :meth:`ServingRuntime.submit` enqueues one query and returns a
    future.  A scheduler thread drains the queue into *shape buckets* —
    powers of two from :data:`MIN_BUCKET` up to ``max_batch`` — so a
    request batch of n pads to the next bucket, not to ``max_batch``.
    Each bucket is one search program, built by :meth:`ServingRuntime.
    warmup` (exactly one per bucket, counted by
    :func:`repro_torch.core.exec.trace_count`).  On the card a program
    is one CUDA graph captured over ``Server._search`` on static input
    buffers (the port's counterpart of the reference's one XLA program
    per bucket): a batch copies its rows into the buffers, replays the
    graph and copies one packed output back to the host, so the host
    issues three copies and one replay instead of every kernel and
    torch op of the pipeline.  On the CPU a program is the same call on
    the same buffers.  The oldest request waits at most ``linger_ms``
    for co-riders.
  · An LRU cache keyed on (index epoch, namespace filter, fusion spec,
    width rung, query bytes) returns bit-identical rows for repeated
    queries.  Mutations bump the index epoch and re-weighting fusion
    changes the key's fusion component, so no stale row is replayed.
  · Adaptive widths (DESIGN.md §14): over a server whose ``rungs`` hold
    a multi-rung tuned ladder, :meth:`ServingRuntime.submit` resolves
    each query's rung from its dispatch margin
    (:func:`repro_torch.core.exec.frontier.margins`, on the host in
    float64 against a float64 copy of the cluster embeddings taken once
    per ladder refresh), a batch carries requests of one rung only, and
    each (bucket, rung) is its own program: on the card one captured
    graph each, all in the one memory pool.  A single-rung runtime keys
    its programs and its ledger by bucket alone, as before.
  · Admission control bounds the queue: past ``queue_depth`` pending
    requests :meth:`submit` fails fast with :class:`RuntimeOverloaded`;
    :meth:`close` drains gracefully.
  · Over a mesh (DESIGN.md §12) the server's ``n_replicas`` data-axis
    slices split every batch into equal row blocks, so every bucket is a
    multiple of it (``bucket_sizes(quantum=)``), and request i of a
    batch rides row ``(i % D)·bucket/D + i // D`` (:meth:`ServingRuntime.
    _rows_idx`): a part-full bucket spreads its requests over every
    replica.  ``replica_dispatch`` counts them per replica.  When every
    mesh position shares one card a bucket's program is one CUDA graph
    captured across the positions' streams (one per bucket per mesh,
    not one per position or replica): the replay runs no worker thread
    and no barrier.  A mesh over several cards runs each bucket
    eagerly; :meth:`ServingRuntime.stats` says which programs were
    captured.  Every row carries the server's ``partial`` flag (a
    :class:`~repro_torch.launch.serve.MeshServer` serving its survivors
    after a shard loss), read under the serve lock.

Bit-identity contract: a query's rows are identical whether it rides a
bucket of b or the full ``max_batch`` pad of ``Server.query``.  The
reference gets this from XLA for b ≥ 2 and pads lone requests to 2
rows.  Here the card's three kernels on the path (``topk_scores``,
``pq_adc_fused``, ``sq8_dot_fused``) compute each lane the same way for
any batch, but cuBLAS (and the CPU's BLAS) choose another reduction
order for another row count, so every query-side product runs at one
fixed row count (:mod:`repro_torch.rowwise`).  With that, a 1-row bucket
is as exact as any other, so :data:`MIN_BUCKET` is 1.

A captured graph holds the addresses of the index's device planes: a
mutable index, single-device or sharded, keeps its delta planes and
tombstones at fixed addresses and copies each epoch into them before a
replay (``MutableServer.sync_device``); ``compact()`` makes a new index,
and a mesh server's eject or rejoin a new placement, so the runtime
captures every bucket again, as the reference recompiles.  A
fusion weight is baked into a graph, so :meth:`ServingRuntime.
set_fusion_weight` captures again too.

Threading model: client threads only enqueue numpy rows and wait on
futures; all device work happens on the one scheduler thread, or under
the serve lock in whichever thread calls ``warmup`` or a mutation, so
nothing touches the device while a graph is being captured.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import exec as qexec
from repro_torch.core import hybrid_index as hi
from repro_torch.core.exec import filters as ns_filters
from repro_torch.core.exec import frontier

#: Smallest micro-batch bucket.  Every query-side product runs at a fixed
#: row count and the kernels are per-lane, so a bucket of 1 gives the
#: same bits as any other (module docstring): a lone request pays a
#: 1-row program.
MIN_BUCKET = 1

#: Cache-key quantum for the L2-normalized query embedding (the
#: reference's): components are rounded to multiples of this before
#: hashing, so positive scalings of one query share an entry.
CACHE_QUANT = 1e-4


class RuntimeOverloaded(RuntimeError):
    """Admission control rejected the request: the queue is at
    ``queue_depth``.  ``retry_after_ms`` is the backoff hint."""

    def __init__(self, depth: int, retry_after_ms: float):
        super().__init__(
            f"request queue full ({depth} pending); retry in "
            f"{retry_after_ms:g} ms")
        self.retry_after_ms = retry_after_ms


class RuntimeClosed(RuntimeError):
    """The runtime is shutting down (or was never started)."""


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    linger_ms: float = 2.0     # max wait of the OLDEST request for co-riders
    queue_depth: int = 256     # pending-request bound (admission control)
    cache_size: int = 0        # LRU result-cache entries; 0 disables
    retry_after_ms: float = 5.0  # backoff hint carried by RuntimeOverloaded
    min_bucket: int = MIN_BUCKET


def bucket_sizes(max_batch: int, min_bucket: int = MIN_BUCKET,
                 quantum: int = 1) -> tuple:
    """The bucket ladder: powers of two from ``min_bucket`` up, capped
    by a final ``max_batch`` rung (itself, even when not a power of 2).

    ``quantum`` is the batch granularity of the serving layout: the
    data-axis replica count of a 2-D mesh server (DESIGN.md §12), whose
    batch splits into equal per-replica row blocks.  Every rung is a
    multiple of it (``max_batch`` itself must be)."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    q = max(1, int(quantum))
    if max_batch % q:
        raise ValueError(f"max_batch {max_batch} is not a multiple of "
                         f"the batch quantum {q}")
    sizes, b = [], max(1, min_bucket) * q
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return tuple(sizes)


class QueryCache:
    """Thread-safe LRU over normalized query keys (the reference's): a
    key is (index epoch, canonical namespace spec, fusion spec, rung,
    normalized embedding bytes, token bytes); a hit returns the stored
    rows verbatim, and mutations invalidate by bumping the epoch."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lru: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        """Lookup; counts hits only (the owner counts a miss when it
        computes the request)."""
        with self._lock:
            if key in self._lru:
                self._lru.move_to_end(key)
                self.hits += 1
                return self._lru[key]
            return None

    def put(self, key, value) -> None:
        with self._lock:
            self._lru[key] = value
            self._lru.move_to_end(key)
            while len(self._lru) > self.capacity:
                self._lru.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)


class _Request:
    __slots__ = ("qe", "qt", "ns", "rung", "future", "t_submit")

    def __init__(self, qe: np.ndarray, qt: np.ndarray, ns, rung: int,
                 future: Future):
        self.qe = qe
        self.qt = qt
        self.ns = ns
        self.rung = rung
        self.future = future
        self.t_submit = time.monotonic()


def _fail(future: Future, exc: BaseException) -> None:
    """``set_exception`` tolerating a client-side ``cancel()`` race."""
    try:
        future.set_exception(exc)
    except InvalidStateError:
        pass


def _canon_qe(qe: np.ndarray) -> bytes:
    """Cache-key bytes for one query embedding: L2-normalize (float64),
    quantize to :data:`CACHE_QUANT`, hash the integer grid point.  Zero
    vectors pass through unnormalized."""
    v = qe.astype(np.float64)
    n = float(np.linalg.norm(v))
    if n > 0.0:
        v = v / n
    return np.round(v / CACHE_QUANT).astype(np.int64).tobytes()


def _canon_ns(namespaces) -> Optional[tuple]:
    """One request's namespace spec (an int or an iterable of ids) as a
    canonical hashable tuple."""
    if namespaces is None:
        return None
    if np.isscalar(namespaces):
        return (int(namespaces),)
    return tuple(sorted({int(n) for n in namespaces}))


def _pack(res: hi.SearchResult) -> torch.Tensor:
    """A search result as one (B, 2R + 1) int32 plane — ids, the scores'
    bits, n_candidates — so a batch needs one copy to the host."""
    return torch.cat([res.doc_ids, res.scores.view(torch.int32),
                      res.n_candidates[:, None].to(torch.int32)], -1)


def _unpack(packed: np.ndarray, r: int) -> tuple:
    """(ids, scores, n_candidates) host planes of a :func:`_pack`ed
    batch."""
    return (packed[:, :r], packed[:, r:2 * r].view(np.float32),
            packed[:, 2 * r])


def captures(server) -> bool:
    """Whether the runtime captures ``server``'s programs as CUDA
    graphs: on a card, for a single-device server or a mesh whose
    positions all share that card (:attr:`repro_torch.distributed.
    collectives.Mesh.one_card`); a mesh over several cards runs eagerly,
    as the CPU does."""
    mesh = getattr(server, "mesh", None)
    return server.device.type == "cuda" and (mesh is None or mesh.one_card)


class _Program:
    """One bucket's search program over a server, at one width rung
    (``widths`` (kc, k2), or None for the server's own): static input
    buffers (``qe`` (b, h) f32, ``qt`` (b, L) int64 and, on a namespaced
    server, the (b, W) int64 bitmap) and ``server._search`` over them.
    When :func:`captures` holds it is warmed eagerly on a side stream
    (the kernels build and set their attributes there, once) and
    captured as one CUDA graph into ``pool`` (over a mesh, the worker
    threads' streams join the capture through :meth:`repro_torch.
    distributed.collectives.Mesh.run`'s fork and join events); a call
    copies the rows in through pinned buffers, replays the graph and
    copies the packed output out.  Otherwise a call runs the search on
    the buffers."""

    def __init__(self, server, bucket: int, hidden: int, query_len: int,
                 pool=None, widths: Optional[tuple] = None):
        dev = server.device
        n_ns = server.cfg.n_namespaces
        self.server = server
        self.widths = widths
        self.inputs = [
            torch.zeros((bucket, hidden), dtype=torch.float32, device=dev),
            torch.full((bucket, query_len), -1, dtype=torch.int64,
                       device=dev)]
        if n_ns:
            self.inputs.append(torch.zeros(
                (bucket, ns_filters.n_words(n_ns)), dtype=torch.int64,
                device=dev))
        self.graph = None
        self.capture_s = 0.0
        if captures(server):
            self.staged = [torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=True) for t in self.inputs]
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._run()
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=pool):
                self.out = self._run()
            torch.cuda.synchronize(dev)
            self.capture_s = time.perf_counter() - t0
            self.out_host = torch.empty(self.out.shape, dtype=torch.int32,
                                        pin_memory=True)
        qexec.record_trace()

    def _run(self) -> torch.Tensor:
        qe, qt, *ns = self.inputs
        return _pack(self.server._search(qe, qt,
                                         filter=ns[0] if ns else None,
                                         widths=self.widths))

    def __call__(self, rows: Sequence[np.ndarray]) -> np.ndarray:
        """The program on one bucket of host rows (qe, qt[, bitmap],
        every row of the bucket, pad rows included) → the packed
        (b, 2R + 1) int32 output on the host."""
        if self.graph is None:
            for t, a in zip(self.inputs, rows):
                t.copy_(torch.from_numpy(a))
            return self._run().cpu().numpy()
        for t, s, a in zip(self.inputs, self.staged, rows):
            s.numpy()[...] = a
            t.copy_(s, non_blocking=True)
        self.graph.replay()
        self.out_host.copy_(self.out, non_blocking=True)
        torch.cuda.current_stream(self.out.device).synchronize()
        return self.out_host.numpy().copy()


def graph_pool_bytes(pool) -> int:
    """Bytes the caching allocator holds in one graph memory pool."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool))


class ServingRuntime:
    """Bucketed micro-batching + caching + admission control over one
    server of :mod:`repro_torch.launch.serve` (any layout, plain or
    mutable, single-device or over a mesh; any codec; with or without
    namespaces and fusion).

    Lifecycle: construct → :meth:`warmup` (builds every bucket's
    program, starts the scheduler) → :meth:`submit`/:meth:`query` →
    :meth:`close`.  Usable as a context manager (``close(drain=True)``
    on exit).
    """

    def __init__(self, server, cfg: RuntimeConfig = RuntimeConfig()):
        if cfg.linger_ms < 0:
            raise ValueError("linger_ms must be >= 0")
        if cfg.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        self.server = server
        self.cfg = cfg
        self.max_batch = int(server.cfg.max_batch)
        # batch quantum: a 2-D mesh server splits each bucket over its
        # data-axis replicas (DESIGN.md §12) in equal row blocks
        self.n_replicas = max(1, int(getattr(server, "n_replicas", 1)))
        self.buckets = bucket_sizes(self.max_batch, cfg.min_bucket,
                                    self.n_replicas)
        self.cache = (QueryCache(cfg.cache_size) if cfg.cache_size > 0
                      else None)
        self._hidden: Optional[int] = None
        self._query_len: Optional[int] = None
        # serve lock: serializes search execution, captures, mutations,
        # and the epoch reads cache keys depend on
        self._serve_lock = threading.Lock()
        self._cond = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._thread: Optional[threading.Thread] = None
        self._closing = False
        self._drop_pending = False
        self._programs: dict = {}
        self._built_for: tuple = (None, None)   # (index, fusion) captured
        self.pool = None
        # telemetry
        self.n_served = 0
        self.n_rejected = 0
        self.n_batches = 0
        self.bucket_counts = {b: 0 for b in self.buckets}
        self.replica_dispatch = {r: 0 for r in range(self.n_replicas)}
        # width rungs (DESIGN.md §14): the server's static (kc, k2)
        # ladder; single-rung on every non-adaptive server, which then
        # keys its programs and ledger by bucket as before
        self.rung_dispatch: dict = {}
        self._cluster_emb: Optional[np.ndarray] = None
        self._refresh_rungs()
        self.warm_traces: dict = {}
        self.capture_seconds: dict = {}
        self.captured: dict = {}
        self.pool_bytes: Optional[int] = None
        # programs built by runtime batches after warmup: 0 unless the
        # server's index or fusion spec changed behind the runtime
        self.serve_traces = 0

    # --- lifecycle -------------------------------------------------------
    def warmup(self, hidden: int, query_len: int) -> None:
        """Build every bucket's search program (one per bucket — the
        counts land in :attr:`warm_traces`) and start the scheduler.
        Must run before :meth:`submit`; running it again after
        :meth:`close` revives the runtime.

        Before the scheduler starts, the objects alive at that point
        (the imports', the index's, the programs') are moved out of the
        collector's generations (``gc.freeze``), after one collection
        so that no garbage is kept.  A full collection during serving
        then scans only what serving made: unfrozen, one pass over the
        whole heap takes tens of ms and can split a bucket's burst of
        submissions past its linger."""
        self._hidden, self._query_len = int(hidden), int(query_len)
        with self._serve_lock:
            self._warm_buckets()
        gc.collect()
        gc.freeze()
        with self._cond:
            closing, t = self._closing, self._thread
        if (closing and t is not None
                and t is not threading.current_thread()):
            # close() from a done-callback stops the scheduler
            # asynchronously; wait it out so the revive below is real
            t.join()
            with self._cond:
                if self._thread is t:
                    self._thread = None
        with self._cond:
            if self._thread is None:
                self._closing = False
                self._drop_pending = False
                self._thread = threading.Thread(target=self._loop,
                                                name="hi2-serving-runtime",
                                                daemon=True)
                self._thread.start()

    def _device_ctx(self):
        dev = self.server.device
        return (torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext())

    def _refresh_rungs(self) -> None:
        """Snapshot the server's width ladder (DESIGN.md §14).  On a
        multi-rung ladder the dispatch margin needs the cluster
        embeddings on the host: a float64 copy is taken here, once per
        (re)warm, so a request pays the margin's product alone, and
        compaction's fresh base swaps its embeddings in with the new
        programs."""
        self.rungs = tuple(self.server.rungs)
        self.margin_cuts = tuple(self.server.margin_cuts)
        for r in range(len(self.rungs)):
            self.rung_dispatch.setdefault(r, 0)
        self._cluster_emb = (frontier.host64(
            self.server.index.cluster_sel.embeddings).copy()
            if len(self.rungs) > 1 else None)

    def _program_key(self, bucket: int, rung: int):
        """A program's (and its ledger entry's) key: the bucket on a
        single-rung ladder, (bucket, rung) on a multi-rung one."""
        return (bucket, rung) if len(self.rungs) > 1 else bucket

    def _warm_buckets(self) -> None:
        """Build the ladder at the current index and fusion spec (caller
        holds the serve lock; :meth:`warmup` recorded the query dims):
        one program per (bucket, rung), all graphs in one memory pool
        (replays are serialized)."""
        self._programs = {}
        self._refresh_rungs()
        multi = len(self.rungs) > 1
        self.server.sync_device()
        with self._device_ctx():
            cuda = captures(self.server)
            self.pool = torch.cuda.graph_pool_handle() if cuda else None
            for b in self.buckets:
                for r, widths in enumerate(self.rungs):
                    key = self._program_key(b, r)
                    before = qexec.trace_count()
                    self._programs[key] = _Program(
                        self.server, b, self._hidden, self._query_len,
                        self.pool, widths if multi else None)
                    self.warm_traces[key] = qexec.trace_count() - before
                    self.capture_seconds[key] = self._programs[key].capture_s
                    self.captured[key] = self._programs[key].graph is not None
            self.pool_bytes = graph_pool_bytes(self.pool) if cuda else None
        self._built_for = (self.server.index, self.server.fusion)

    def close(self, drain: bool = True) -> None:
        """Stop the runtime.  ``drain=True`` (the default) completes
        every accepted request first; ``drain=False`` fails pending
        futures with :class:`RuntimeClosed`.  Idempotent; from a
        done-callback the stop is asynchronous."""
        with self._cond:
            self._closing = True
            self._drop_pending = not drain
            self._cond.notify_all()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join()
            with self._cond:
                if self._thread is t:   # exiting schedulers self-clear
                    self._thread = None

    def __enter__(self) -> "ServingRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=True)

    # --- request path ----------------------------------------------------
    def submit(self, query_emb, query_tokens, namespaces=None) -> Future:
        """Enqueue ONE query; returns a future resolving to its
        :class:`~repro_torch.core.hybrid_index.SearchResult` rows (numpy:
        ``doc_ids``/``scores`` of shape (R,), scalar ``n_candidates``),
        bit-identical to the same query through ``Server.query``.

        Raises :class:`RuntimeOverloaded` past ``queue_depth`` pending
        requests and :class:`RuntimeClosed` after :meth:`close` (or
        before :meth:`warmup`).
        """
        self._check_serving()
        req = self._request(query_emb, query_tokens, namespaces)
        if not req.future.done():
            self._enqueue([req])
        return req.future

    def query(self, query_emb, query_tokens, namespaces=None,
              timeout: Optional[float] = None) -> hi.SearchResult:
        """Synchronous batch convenience with the ``Server.query``
        signature: one request a row, reassembled into numpy planes.
        The rows enter the queue under one hold of its lock, so the
        scheduler sees them together (a batch of up to ``max_batch``
        rows is one micro-batch whatever the linger), and admission
        control takes or rejects them as a whole: it raises
        :class:`RuntimeOverloaded` when they do not fit beside what is
        pending, and :class:`ValueError` for more rows than
        ``queue_depth``, which never fit.  ``timeout`` bounds each wait
        (None: unbounded)."""
        qe = np.atleast_2d(np.asarray(query_emb, np.float32))
        qt = np.atleast_2d(np.asarray(query_tokens, np.int64))
        n = qe.shape[0]
        if namespaces is not None and len(namespaces) != n:
            raise ValueError(f"{len(namespaces)} filter rows for {n} "
                             "queries")
        if n > self.cfg.queue_depth:
            raise ValueError(f"{n} rows exceed queue_depth="
                             f"{self.cfg.queue_depth}; split the batch")
        self._check_serving()
        reqs = [self._request(qe[i], qt[i],
                              None if namespaces is None else namespaces[i])
                for i in range(n)]
        self._enqueue([r for r in reqs if not r.future.done()])
        rows = [r.future.result(timeout=timeout) for r in reqs]
        return hi.SearchResult(
            doc_ids=np.stack([r.doc_ids for r in rows]),
            scores=np.stack([r.scores for r in rows]),
            n_candidates=np.stack([r.n_candidates for r in rows]),
            partial=any(bool(r.partial) for r in rows))

    def _check_serving(self) -> None:
        if self._thread is None or self._closing:
            raise RuntimeClosed(
                "runtime not serving; call warmup(hidden, query_len) "
                "first" if self._thread is None else "runtime closed")

    def _request(self, query_emb, query_tokens, namespaces) -> "_Request":
        """One validated request; its future already holds the row on a
        cache hit."""
        qe = np.asarray(query_emb, np.float32).reshape(-1)
        qt = np.asarray(query_tokens, np.int64).reshape(-1)
        if qe.shape[0] != self._hidden or qt.shape[0] != self._query_len:
            raise ValueError(
                f"query shapes ({qe.shape[0]},)/({qt.shape[0]},) do not "
                f"match the warmed ({self._hidden},)/({self._query_len},)")
        ns = _canon_ns(namespaces)
        if ns is not None:
            n_ns = self.server.cfg.n_namespaces
            if not n_ns:
                raise ValueError(
                    "this server was built without namespaces; construct "
                    "with ServeConfig(n_namespaces=N) / --namespaces N")
            # validated per request: a bad id in the scheduler would fail
            # every co-rider of its micro-batch
            bad = [i for i in ns if not 0 <= i < n_ns]
            if bad:
                raise ValueError(
                    f"namespace id(s) {bad} out of range [0, {n_ns})")
        rung = self._rung_for(qe)
        req = _Request(qe, qt, ns, rung, Future())
        if self.cache is not None:
            # lock-free pre-check; the scheduler re-checks under the lock
            hit = self.cache.get(self._key(qe, qt, ns, rung))
            if hit is not None:
                req.future.set_result(hit)
        return req

    def _enqueue(self, reqs: list) -> None:
        """Queue ``reqs`` under one hold of the lock and wake the
        scheduler once; past ``queue_depth`` none of them is queued."""
        if not reqs:
            return
        with self._cond:
            if self._closing:
                raise RuntimeClosed("runtime closed")
            if len(self._queue) + len(reqs) > self.cfg.queue_depth:
                self.n_rejected += len(reqs)
                raise RuntimeOverloaded(len(self._queue),
                                        self.cfg.retry_after_ms)
            now = time.monotonic()
            for req in reqs:
                req.t_submit = now
            self._queue.extend(reqs)
            self._cond.notify_all()

    # --- mutations (mutable servers): epoch-coherent forwarding ----------
    def add(self, doc_emb, doc_tokens, namespaces=None) -> np.ndarray:
        with self._serve_lock:
            base = self.server.index
            ids = self.server.add(doc_emb, doc_tokens,
                                  namespaces=namespaces)
            self._rewarm_if_compacted(base)
            return ids

    def delete(self, doc_ids) -> None:
        with self._serve_lock:
            base = self.server.index
            self.server.delete(doc_ids)
            self._rewarm_if_compacted(base)

    def _rewarm_if_compacted(self, base) -> None:
        """A watermark compaction inside ``add``/``delete`` swaps the
        base index; capture again here, under the serve lock and off the
        request path, as an explicit :meth:`compact` does.  Without one,
        the next batch copies the new epoch into the planes the graphs
        read (``sync_device``): nothing is captured."""
        if self.server.index is not base and self._hidden is not None:
            self._warm_buckets()

    def compact(self) -> None:
        with self._serve_lock:
            self.server.compact()
            # a new index: its planes live elsewhere, so every bucket is
            # captured again here, off the request path
            if self._hidden is not None:
                self._warm_buckets()

    def set_fusion_weight(self, weight: Optional[float]) -> None:
        """Re-weight hybrid fusion live (DESIGN.md §13).  The weight is
        baked into each captured graph, so the ladder is captured again
        under the serve lock; the spec's place in the cache key keeps
        rows fused at the old weight from replaying."""
        with self._serve_lock:
            self.server.set_fusion(weight)
            if self._hidden is not None:
                self._warm_buckets()

    # --- observability ---------------------------------------------------
    def stats(self) -> dict:
        cache = None
        if self.cache is not None:
            h, m = self.cache.hits, self.cache.misses
            cache = {"hits": h, "misses": m, "entries": len(self.cache),
                     "hit_rate": (h / (h + m)) if h + m else 0.0}
        with self._cond:
            depth = len(self._queue)
        return {
            "buckets": list(self.buckets),
            "warm_traces": dict(self.warm_traces),
            "post_warmup_traces": self.serve_traces,
            "n_served": self.n_served,
            "n_rejected": self.n_rejected,
            "n_batches": self.n_batches,
            "queue_depth": depth,
            "bucket_counts": dict(self.bucket_counts),
            "n_replicas": self.n_replicas,
            "replica_dispatch": dict(self.replica_dispatch),
            "rungs": [list(r) for r in self.rungs],
            "rung_dispatch": dict(self.rung_dispatch),
            "widths": [self.server.kc, self.server.k2],
            "width_source": self.server.width_source,
            "cache": cache,
            "capture_seconds": dict(self.capture_seconds),
            "captured": dict(self.captured),
            "graph_pool_bytes": self.pool_bytes,
        }

    def serve_metrics(self, port: int = 0) -> "MetricsServer":
        """Expose :meth:`stats` as plaintext on
        ``http://127.0.0.1:port/metrics`` (``port=0``: ephemeral); the
        caller ``close()``s the returned :class:`MetricsServer`."""
        return MetricsServer(self, port)

    def assert_one_compile_per_bucket(self) -> None:
        """The warmup contract (DESIGN.md §10): every bucket (every
        (bucket, rung) on a multi-rung ladder) built at most once during
        warmup and nothing built since."""
        bad = {b: n for b, n in self.warm_traces.items() if n > 1}
        if bad:
            raise AssertionError(
                f"buckets built more than once during warmup: {bad}")
        if self.serve_traces:
            raise AssertionError(
                f"{self.serve_traces} search program(s) built after "
                "warmup — the index or fusion spec changed behind the "
                "runtime")

    # --- internals -------------------------------------------------------
    def _epoch(self) -> int:
        return self.server.epoch

    def _rung_for(self, qe: np.ndarray) -> int:
        """One query's width rung from its dispatch margin (DESIGN.md
        §14), computed on the L2-normalized embedding — the canonical
        form the cache key hashes — so positive scalings of one query
        resolve one rung.  Constant 0 on a single-rung ladder."""
        if len(self.rungs) <= 1:
            return 0
        m = frontier.margins(self._cluster_emb, qe[None])
        return int(frontier.resolve_rung(m, self.margin_cuts)[0])

    def _key(self, qe: np.ndarray, qt: np.ndarray, ns, rung: int,
             epoch: Optional[int] = None) -> tuple:
        """The one cache-key schema (the reference's); the scheduler
        passes its lock-pinned ``epoch``.  The resolved rung joins the
        key, so a row computed at one rung never replays for a query
        resolved to another, even on an ulp-level margin flip at a
        cut."""
        e = self._epoch() if epoch is None else epoch
        return (e, ns, self.server.fusion, rung, _canon_qe(qe),
                qt.tobytes())

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_batch

    def _rows_idx(self, n: int, bucket: int) -> list:
        """Row placement for n requests in a bucket: identity on 1-D
        layouts; on a D-replica mesh request i rides row ``(i % D) ·
        bucket/D + i // D``, round-robin over the contiguous per-replica
        row blocks the data axis splits the bucket into, so a part-full
        bucket spreads its requests over every replica."""
        d = self.n_replicas
        if d == 1:
            return list(range(n))
        per = bucket // d
        return [(i % d) * per + (i // d) for i in range(n)]

    def _bitmap(self, specs: Sequence, bucket: int,
                rows_idx: Optional[Sequence[int]] = None
                ) -> Optional[np.ndarray]:
        """The bucket's (b, W) namespace bitmap, or None on an unfiltered
        server.  A namespaced server always gets one (allow-all rows for
        requests without a filter, a bitwise no-op), so each bucket has
        one program; rows no request rides (pad rows) match nothing.
        Request i's row is ``rows_idx[i]`` (default i)."""
        n_ns = self.server.cfg.n_namespaces
        if not n_ns:
            return None
        rows = [()] * bucket
        for i, ns in enumerate(specs):
            rows[i if rows_idx is None else rows_idx[i]] = (
                range(n_ns) if ns is None else ns)
        return ns_filters.filter_words(rows, n_ns)

    def _loop(self) -> None:
        try:
            self._run_scheduler()
        finally:
            with self._cond:
                if self._thread is threading.current_thread():
                    self._thread = None

    def _run_scheduler(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closing:
                    self._cond.wait()
                if not self._queue:          # closing and drained
                    return
                # linger: wait for co-riders until the oldest request's
                # deadline, then take what arrived (never past max_batch)
                deadline = self._queue[0].t_submit + self.cfg.linger_ms / 1e3
                while (len(self._queue) < self.max_batch
                       and not self._closing):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                if self._closing and self._drop_pending:
                    dropped = list(self._queue)
                    self._queue.clear()
                else:
                    dropped = None
                    # co-rung micro-batching (DESIGN.md §14): a batch
                    # runs one program, so it carries requests of one
                    # width rung.  Take the oldest request's rung, sweep
                    # the queue for co-rung riders (never past
                    # max_batch) and put the others back in arrival
                    # order: FIFO within each rung, and the oldest
                    # request always runs now.  A single-rung ladder
                    # sweeps everything, as before.
                    rung = self._queue[0].rung
                    batch, keep = [], []
                    while self._queue and len(batch) < self.max_batch:
                        req = self._queue.popleft()
                        (batch if req.rung == rung else keep).append(req)
                    self._queue.extendleft(reversed(keep))
            if dropped is not None:
                # futures resolve outside the locks: a done-callback may
                # re-enter submit()/close()
                for req in dropped:
                    _fail(req.future,
                          RuntimeClosed("runtime closed before execution"))
                return
            # claim each future: a client that cancel()ed while queued
            # drops out here
            batch = [r for r in batch
                     if r.future.set_running_or_notify_cancel()]
            if not batch:
                continue
            try:
                self._execute(batch)
            except BaseException as e:       # noqa: BLE001 — fail futures,
                for req in batch:            # never strand waiting clients
                    if not req.future.done():
                        _fail(req.future, e)

    def _execute(self, batch: list) -> None:
        rows = {}          # id(req) -> row; futures resolve outside the
        err = None         # serve lock, in batch order
        rung = batch[0].rung     # co-rung by construction (_run_scheduler)
        with self._serve_lock:
            epoch = self._epoch()
            misses = []
            for req in batch:
                hit = (None if self.cache is None else
                       self.cache.get(self._key(req.qe, req.qt, req.ns,
                                                req.rung, epoch)))
                if hit is not None:
                    rows[id(req)] = hit
                else:
                    misses.append(req)
            if misses:
                try:
                    self._run_batch(misses, rung, epoch, rows)
                except BaseException as e:   # noqa: BLE001 — the cache
                    err = e                  # hits still resolve below
        for req in batch:
            row = rows.get(id(req))
            if row is not None:
                req.future.set_result(row)
            else:
                req.future.set_exception(err)

    def _run_batch(self, misses: list, rung: int, epoch: int,
                   rows: dict) -> None:
        """One (bucket, rung) program over the cache misses (serve lock
        held): rows copied in at their placed rows with the pad rows
        rewritten, one replay, one packed copy out; every row carries
        the server's ``partial`` flag."""
        bucket = self._bucket_for(len(misses))
        place = self._rows_idx(len(misses), bucket)
        qe = np.zeros((bucket, self._hidden), np.float32)
        qt = np.full((bucket, self._query_len), -1, np.int64)
        for i, req in enumerate(misses):
            qe[place[i]], qt[place[i]] = req.qe, req.qt
        ns = self._bitmap([r.ns for r in misses], bucket, place)
        partial = bool(self.server.partial)
        before = qexec.trace_count()
        with self._device_ctx():
            index, fusion = self._built_for
            if (index is not self.server.index
                    or fusion != self.server.fusion):
                self._warm_buckets()     # counted in serve_traces
            self.server.sync_device()
            packed = self._programs[self._program_key(bucket, rung)](
                [qe, qt] + ([] if ns is None else [ns]))
        self.serve_traces += qexec.trace_count() - before
        ids, scores, n_cand = _unpack(packed, self.server.cfg.top_r)
        for i, req in enumerate(misses):
            j = place[i]
            row = hi.SearchResult(doc_ids=ids[j], scores=scores[j],
                                  n_candidates=n_cand[j], partial=partial)
            if self.cache is not None:
                self.cache.put(self._key(req.qe, req.qt, req.ns, req.rung,
                                         epoch), row)
            rows[id(req)] = row
            self.replica_dispatch[i % self.n_replicas] += 1
        if self.cache is not None:
            self.cache.misses += len(misses)
        self.n_served += len(misses)
        self.n_batches += 1
        self.bucket_counts[bucket] += 1
        self.rung_dispatch[rung] += len(misses)
        self.server.n_served += len(misses)


def render_metrics(stats: dict) -> str:
    """One :meth:`ServingRuntime.stats` dict as plaintext metrics
    (Prometheus exposition style), the reference's lines."""
    lines = [
        f"hi2_runtime_served_total {stats['n_served']}",
        f"hi2_runtime_rejected_total {stats['n_rejected']}",
        f"hi2_runtime_batches_total {stats['n_batches']}",
        f"hi2_runtime_queue_depth {stats['queue_depth']}",
        f"hi2_runtime_replicas {stats['n_replicas']}",
        f"hi2_runtime_post_warmup_compiles {stats['post_warmup_traces']}",
    ]
    for b in stats["buckets"]:
        lines.append(f'hi2_runtime_bucket_batches_total{{bucket="{b}"}} '
                     f"{stats['bucket_counts'][b]}")
    for b, n in sorted(stats["warm_traces"].items()):
        if isinstance(b, tuple):     # multi-rung ledger: (bucket, rung)
            lines.append(f'hi2_runtime_bucket_compiles{{bucket="{b[0]}",'
                         f'rung="{b[1]}"}} {n}')
        else:
            lines.append(f'hi2_runtime_bucket_compiles{{bucket="{b}"}} {n}')
    for r, n in sorted(stats["replica_dispatch"].items()):
        lines.append(f'hi2_runtime_replica_dispatch_total{{replica="{r}"}} '
                     f"{n}")
    kc, k2 = stats["widths"]
    lines.append(f'hi2_runtime_width_info{{source="{stats["width_source"]}"'
                 f',kc="{kc}",k2="{k2}"}} 1')
    lines.append(f"hi2_runtime_rungs {len(stats['rungs'])}")
    for r, n in sorted(stats["rung_dispatch"].items()):
        rkc, rk2 = stats["rungs"][int(r)]
        lines.append(f'hi2_runtime_rung_dispatch_total{{rung="{r}",'
                     f'kc="{rkc}",k2="{rk2}"}} {n}')
    cache = stats["cache"]
    if cache is not None:
        lines += [
            f"hi2_runtime_cache_hits_total {cache['hits']}",
            f"hi2_runtime_cache_misses_total {cache['misses']}",
            f"hi2_runtime_cache_entries {cache['entries']}",
            f"hi2_runtime_cache_hit_rate {cache['hit_rate']:.6f}",
        ]
    return "\n".join(lines) + "\n"


class MetricsServer:
    """Plaintext metrics endpoint over one :class:`ServingRuntime`:
    ``GET /metrics`` on a loopback-only stdlib HTTP server returns
    :func:`render_metrics` of a live :meth:`~ServingRuntime.stats`
    snapshot.  Daemon-threaded; ``close()`` stops it."""

    def __init__(self, runtime: ServingRuntime, port: int = 0):
        import http.server

        rt = runtime

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.split("?", 1)[0] != "/metrics":
                    self.send_error(404, "scrape /metrics")
                    return
                body = render_metrics(rt.stats()).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):     # scrapes are not stdout news
                pass

        self._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", port),
                                                      _Handler)
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="hi2-metrics", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

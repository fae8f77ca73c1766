"""Streaming index mutations, single device (port of
``repro/core/segments.py``: ``DeltaFull``, ``DeltaSegment``,
``_pair_sources``, ``search``, ``_insert_posting`` and
``MutableHybridIndex``; DESIGN.md §8).  ``ShardedMutableIndex`` comes
with the sharding slice.

    MutableHybridIndex = immutable base + one delta segment + tombstones

    add_docs()     assign through the *frozen* base selectors (cluster
                   argmax, BM25 terms under the base corpus statistics),
                   encode through the base codec params, append into
                   fixed-capacity delta planes.  New docs get global ids
                   ``n_base + slot``.
    delete_docs()  set a tombstone bit; the engine's filter stage masks
                   it before the total-order top-R selection, so a
                   deleted doc can never surface, not even through refine.
    compact()      a from-scratch :func:`repro_torch.core.hybrid_index.
                   build` over the surviving corpus with the original
                   seed, so the result equals rebuilding, leaf for leaf.

Search is the engine of :mod:`repro_torch.core.exec` over two sources,
the base planes and the delta planes, so every codec and the namespace
filter work unchanged on streamed documents.  Assignment, term scoring
and encoding of new documents run on the index's device; the list
inserts and the tombstones are host numpy, as in the reference.
:meth:`MutableHybridIndex.search` moves the delta planes and the
tombstones to the device once per mutation epoch, so repeated searches
between mutations copy nothing.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import device as dev_mod
from repro_torch.core import bm25
from repro_torch.core import cluster_selector as cs_mod
from repro_torch.core import codecs
from repro_torch.core import exec as qexec
from repro_torch.core import hybrid_index as hi
from repro_torch.core.exec import filters
from repro_torch.core.inverted_lists import PAD_DOC, PaddedLists

#: build arguments ``compact()`` cannot replay (raw selector planes)
_SELECTOR_KWARGS = ("cluster_sel", "doc_assign", "term_sel",
                    "term_pos_scores")


class DeltaFull(RuntimeError):
    """Raised by ``add_docs`` when the delta segment has no free slots;
    call ``compact()`` to fold the delta into a fresh base first."""


@dataclasses.dataclass(frozen=True)
class DeltaSegment:
    """The device-side view of the delta: fixed-capacity list planes over
    the same list ids as the base, codec doc planes with ``capacity``
    rows, entries holding *global* doc ids (``n_base + slot``)."""
    cluster_lists: PaddedLists                      # (L, Cc') i32
    term_lists: PaddedLists                         # (V, Ct') i32
    doc_planes: dict                                # leaves (capacity, ...)
    doc_assign: torch.Tensor                        # (capacity,) i32
    doc_ns: Optional[torch.Tensor] = None           # (capacity,) i32
    sparse_weights: Optional[torch.Tensor] = None   # (V, Ct') f32 impacts

    @property
    def capacity(self) -> int:
        return int(self.doc_assign.shape[0])


def _pair_sources(base: hi.HybridIndex, delta: DeltaSegment,
                  tombstones: torch.Tensor) -> list:
    """The (base, delta) source pair: the base as the immutable index
    serves it, plus the delta planes owning global ids
    [n_base, n_base + capacity)."""
    n_base, cap = base.n_docs, delta.capacity
    return [
        qexec.Source(cluster_lists=base.cluster_lists,
                     term_lists=base.term_lists, doc_planes=base.doc_planes,
                     size=n_base, tombstones=tombstones[:n_base],
                     doc_ns=base.doc_ns, sparse_weights=base.sparse_weights),
        qexec.Source(cluster_lists=delta.cluster_lists,
                     term_lists=delta.term_lists,
                     doc_planes=delta.doc_planes, size=cap, offset=n_base,
                     family_lo=n_base, family_hi=n_base + cap,
                     tombstones=tombstones[n_base:], doc_ns=delta.doc_ns,
                     sparse_weights=delta.sparse_weights),
    ]


def search(base: hi.HybridIndex, delta: DeltaSegment,
           tombstones: torch.Tensor, query_embeddings: torch.Tensor,
           query_tokens: torch.Tensor, *, kc: int, k2: int, top_r: int,
           filter: Optional[torch.Tensor] = None,
           fusion: Optional[qexec.FusionSpec] = None) -> hi.SearchResult:
    """Eq. 5 over base ∪ delta minus tombstones (DESIGN.md §8): one
    dispatch on the shared selectors, candidates gathered from both list
    families, deduplicated, tombstone- and namespace-masked together,
    scored against their own doc planes and selected under the total
    order *before* refine, so refine cannot resurrect a masked doc.
    Every tensor must already be on one device."""
    with torch.inference_mode():
        return qexec.execute(
            codecs.get(base.codec), base.codec_params, base.cluster_sel,
            base.term_sel, _pair_sources(base, delta, tombstones),
            query_embeddings, query_tokens, kc=kc, k2=k2, top_r=top_r,
            ns_filter=filter, fusion=fusion)


# --------------------------------------------------------------------------
# host-side mutable state
# --------------------------------------------------------------------------

def _insert_posting(entries: np.ndarray, scores: np.ndarray,
                    lengths: np.ndarray, list_id: int, doc_id: int,
                    score: float) -> bool:
    """Append one (doc, score) posting to a fixed-capacity delta list.
    A full list evicts its lowest-scoring posting (the first one, on
    ties) iff the newcomer beats it; a tie drops the newcomer.  Returns
    False when the posting was dropped."""
    cap = entries.shape[1]
    n = int(lengths[list_id])
    if n < cap:
        entries[list_id, n] = doc_id
        scores[list_id, n] = score
        lengths[list_id] = n + 1
        return True
    j = int(np.argmin(scores[list_id]))
    if score <= scores[list_id, j]:
        return False
    entries[list_id, j] = doc_id
    scores[list_id, j] = score
    return True


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class MutableHybridIndex:
    """Base HI² + one fixed-capacity delta segment + a tombstone set.

    Construct with :meth:`create` (which runs the base build on
    ``device``), then ``add_docs`` / ``delete_docs`` / ``search`` /
    ``compact``.  The raw corpus (embeddings, tokens, namespaces when
    filtered) is retained on the host: ``compact()`` rebuilds from it,
    which is what makes the rebuild equal a from-scratch build over the
    survivors."""

    def __init__(self, base: hi.HybridIndex, *, vocab_size: int, seed: int,
                 build_kwargs: dict, delta_capacity: int,
                 delta_cluster_capacity: int, delta_term_capacity: int,
                 corpus_emb: np.ndarray, corpus_tokens: np.ndarray,
                 corpus_ns: Optional[np.ndarray] = None, selectors=None):
        if delta_capacity < 1:
            raise ValueError("delta_capacity must be >= 1")
        self.base = base
        self.device = base.device
        self.vocab_size = int(vocab_size)
        self.seed = int(seed)
        self.build_kwargs = dict(build_kwargs)
        self.selectors = selectors
        self.delta_capacity = int(delta_capacity)
        self.delta_cluster_capacity = int(delta_cluster_capacity)
        self.delta_term_capacity = int(delta_term_capacity)
        self._corpus_emb = np.array(corpus_emb, np.float32)
        self._corpus_tokens = np.array(corpus_tokens, np.int32)
        if (corpus_ns is None) != (base.doc_ns is None):
            raise ValueError("corpus_ns must accompany a namespaced base")
        self._corpus_ns = (None if corpus_ns is None
                           else np.array(corpus_ns, np.int32))
        self._stats = bm25.fit(
            torch.from_numpy(self._corpus_tokens).to(self.device).long(),
            self.vocab_size)

        n_clusters = base.cluster_lists.n_lists
        hidden = self._corpus_emb.shape[1]
        cap = self.delta_capacity
        self._dc_entries = np.full((n_clusters, self.delta_cluster_capacity),
                                   PAD_DOC, np.int32)
        self._dc_scores = np.full((n_clusters, self.delta_cluster_capacity),
                                  -np.inf, np.float32)
        self._dc_lengths = np.zeros((n_clusters,), np.int32)
        self._dt_entries = np.full((self.vocab_size, self.delta_term_capacity),
                                   PAD_DOC, np.int32)
        self._dt_scores = np.full((self.vocab_size, self.delta_term_capacity),
                                  -np.inf, np.float32)
        self._dt_lengths = np.zeros((self.vocab_size,), np.int32)
        # preallocate codec planes by encoding a zero block: the exact
        # shapes and dtypes of any codec, with no per-codec branch
        with torch.inference_mode():
            zero = codecs.get(base.codec).encode(
                base.codec_params,
                torch.zeros((cap, hidden), dtype=torch.float32,
                            device=self.device))
        self._delta_planes = {k: _to_numpy(v) for k, v in zero.items()}
        self._delta_assign = np.zeros((cap,), np.int32)
        self._delta_ns = (None if self._corpus_ns is None
                          else np.zeros((cap,), np.int32))
        self._delta_emb = np.zeros((cap, hidden), np.float32)
        self._delta_tokens = np.full((cap, self._corpus_tokens.shape[1]),
                                     bm25.PAD_ID, np.int32)
        self._tomb = np.zeros((self.n_base + cap,), bool)
        self._count = 0
        self.dropped_postings = 0
        self._cache: Optional[tuple[DeltaSegment, torch.Tensor]] = None
        self._epoch = 0

    # --- construction ----------------------------------------------------
    @classmethod
    def create(cls, seed: int, doc_emb, doc_tokens, vocab_size: int, *,
               delta_capacity: int = 1024,
               delta_cluster_capacity: Optional[int] = None,
               delta_term_capacity: Optional[int] = None,
               doc_namespaces=None, selectors=None,
               device: dev_mod.DeviceLike = "cuda",
               **build_kwargs) -> "MutableHybridIndex":
        """Build the base index on ``device`` and wrap it with an empty
        delta segment.

        ``build_kwargs`` go to :func:`repro_torch.core.hybrid_index.
        build` and are replayed by ``compact()``, so they must be plain
        values (ints, strings, bools), not selector planes.
        ``doc_namespaces`` enables filtered search; streamed docs carry
        the ``namespaces=`` argument of :meth:`add_docs`.  ``selectors``
        (a :class:`repro_torch.launch.train.SupSelectors`) supplies
        supervised selectors: ``build_inputs`` for the base build and
        ``position_scores`` for streamed docs; being corpus-independent,
        ``compact()`` can replay it."""
        for k in _SELECTOR_KWARGS:
            if k in build_kwargs:
                raise ValueError(
                    f"build_kwargs[{k!r}] is not supported: compact() "
                    "replays the build from scratch and cannot persist "
                    "raw selector arrays — pass a corpus-independent "
                    "``selectors=`` object instead")
        dev = dev_mod.resolve(device)
        doc_emb = np.asarray(doc_emb, np.float32)
        doc_tokens = np.asarray(doc_tokens, np.int32)
        if doc_namespaces is not None:
            doc_namespaces = np.asarray(doc_namespaces, np.int32)
        sel_kwargs = {}
        if selectors is not None:
            sel_kwargs = selectors.build_inputs(doc_emb, doc_tokens,
                                                vocab_size)
            # the list count is the trained selector's, not the caller's
            n_sel = int(sel_kwargs["cluster_sel"].embeddings.shape[0])
            if build_kwargs.setdefault("n_clusters", n_sel) != n_sel:
                raise ValueError(
                    f"n_clusters={build_kwargs['n_clusters']} conflicts "
                    f"with the supervised selectors' {n_sel} clusters; "
                    "omit n_clusters to derive it")
        base = hi.build(seed, doc_emb, doc_tokens, vocab_size,
                        doc_namespaces=doc_namespaces, device=dev,
                        **sel_kwargs, **build_kwargs)
        n_clusters = base.cluster_lists.n_lists
        k1 = int(build_kwargs["k1_terms"])
        if delta_cluster_capacity is None:
            delta_cluster_capacity = min(
                delta_capacity, max(8, 4 * -(-delta_capacity // n_clusters)))
        if delta_term_capacity is None:
            delta_term_capacity = min(
                delta_capacity,
                max(8, 4 * -(-delta_capacity * k1 // vocab_size)))
        return cls(base, vocab_size=vocab_size, seed=seed,
                   build_kwargs=build_kwargs, delta_capacity=delta_capacity,
                   delta_cluster_capacity=delta_cluster_capacity,
                   delta_term_capacity=delta_term_capacity,
                   corpus_emb=doc_emb, corpus_tokens=doc_tokens,
                   corpus_ns=doc_namespaces, selectors=selectors)

    # --- views -----------------------------------------------------------
    @property
    def n_base(self) -> int:
        return self.base.n_docs

    @property
    def n_docs(self) -> int:
        """Allocated doc ids (base + filled delta slots), incl. deleted."""
        return self.n_base + self._count

    @property
    def delta_count(self) -> int:
        return self._count

    @property
    def delta_fill(self) -> float:
        return self._count / self.delta_capacity

    @property
    def n_deleted(self) -> int:
        return int(self._tomb[:self.n_docs].sum())

    @property
    def n_live(self) -> int:
        return self.n_docs - self.n_deleted

    @property
    def tombstone_ratio(self) -> float:
        """Deleted share of the allocated corpus: with :attr:`delta_fill`,
        one of the two auto-compaction watermarks (DESIGN.md §8)."""
        return self.n_deleted / self.n_docs if self.n_docs else 0.0

    def needs_compact(self, fill_watermark: float = 0.0,
                      tombstone_watermark: float = 0.0) -> bool:
        """True when delta fill >= ``fill_watermark`` or the tombstone
        ratio >= ``tombstone_watermark``; a watermark of 0 disables its
        trigger."""
        if fill_watermark > 0 and self.delta_fill >= fill_watermark:
            return True
        return (tombstone_watermark > 0
                and self.tombstone_ratio >= tombstone_watermark)

    @property
    def tombstones(self) -> np.ndarray:
        return self._tomb.copy()

    @property
    def filtered(self) -> bool:
        """True when the index carries namespace planes (DESIGN.md §9)."""
        return self._corpus_ns is not None

    @property
    def epoch(self) -> int:
        """Monotonic mutation counter: +1 per ``add_docs`` /
        ``delete_docs`` call and across ``compact()`` (which renumbers
        doc ids); two searches at one epoch see one corpus."""
        return self._epoch

    def is_deleted(self, ids) -> np.ndarray:
        return self._tomb[np.asarray(ids)]

    def namespaces_of(self, ids) -> np.ndarray:
        """Namespace id of each global doc id (filtered indexes only)."""
        if not self.filtered:
            raise ValueError("index has no namespace planes")
        return np.concatenate([self._corpus_ns,
                               self._delta_ns])[np.asarray(ids)]

    # --- mutation --------------------------------------------------------
    def add_docs(self, doc_emb, doc_tokens, namespaces=None,
                 timings: Optional[dict] = None) -> np.ndarray:
        """Append documents to the delta segment; returns their global
        ids.

        Assignment uses the frozen base state: cluster = argmax against
        the base selector, salient terms = BM25 under the base corpus
        statistics (refreshed only by ``compact()``) or the supervised
        ``selectors``' scorer.  ``namespaces`` ((n_new,) ids or one id)
        is required on a filtered index and refused on an unfiltered
        one.  Raises :class:`DeltaFull` when the segment has too few free
        slots.  ``timings``, when a dict, receives the seconds of the
        device part (assignment, term scores, encoding) and of the host
        list inserts."""
        emb = np.atleast_2d(np.asarray(doc_emb, np.float32))
        tokens = np.atleast_2d(np.asarray(doc_tokens, np.int32))
        n_new = emb.shape[0]
        if tokens.shape[0] != n_new:
            raise ValueError(f"emb/tokens row mismatch: {n_new} vs "
                             f"{tokens.shape[0]}")
        if namespaces is not None and not self.filtered:
            raise ValueError(
                "namespaces= on an unfiltered index; build with "
                "doc_namespaces= to enable filtered search")
        if self.filtered:
            if namespaces is None:
                raise ValueError(
                    "filtered index: add_docs needs namespaces= for the "
                    "new docs")
            ns = np.broadcast_to(np.asarray(namespaces, np.int32),
                                 (n_new,)).copy()
            if ns.min() < 0:
                raise ValueError("namespaces must be non-negative ids")
        width = self._corpus_tokens.shape[1]
        if tokens.shape[1] > width:
            raise ValueError(f"doc_tokens wider than the corpus "
                             f"({tokens.shape[1]} > {width})")
        if tokens.shape[1] < width:
            tokens = np.pad(tokens, ((0, 0), (0, width - tokens.shape[1])),
                            constant_values=bm25.PAD_ID)
        if self._count + n_new > self.delta_capacity:
            raise DeltaFull(
                f"delta segment full: {self._count}/{self.delta_capacity} "
                f"slots used, {n_new} more requested — compact() first")

        t0 = time.perf_counter()
        k1 = int(self.build_kwargs["k1_terms"])
        with torch.inference_mode():
            x = torch.from_numpy(emb).to(self.device)
            tok = torch.from_numpy(tokens).to(self.device).long()
            assign = cs_mod.select_for_doc(self.base.cluster_sel, x)
            a_scores = hi.assigned_scores(self.base.cluster_sel, x, assign)
            if self.selectors is not None:
                pos = self.selectors.position_scores(tok).to(self.device)
            else:
                pos = bm25.score_positions(tok, self._stats)
            t_ids, t_scores = bm25.top_terms(tok, pos, k1)
            enc = codecs.get(self.base.codec).encode(self.base.codec_params,
                                                     x)
            assign, a_scores = _to_numpy(assign), _to_numpy(a_scores)
            t_ids, t_scores = _to_numpy(t_ids), _to_numpy(t_scores)
            enc = {k: _to_numpy(v) for k, v in enc.items()}
        t1 = time.perf_counter()
        lo = self._count
        for k, v in enc.items():
            self._delta_planes[k][lo:lo + n_new] = v
        self._delta_emb[lo:lo + n_new] = emb
        self._delta_tokens[lo:lo + n_new] = tokens
        self._delta_assign[lo:lo + n_new] = assign
        if self.filtered:
            self._delta_ns[lo:lo + n_new] = ns

        ids = self.n_base + lo + np.arange(n_new)
        for i in range(n_new):
            gid = int(ids[i])
            if not _insert_posting(self._dc_entries, self._dc_scores,
                                   self._dc_lengths, int(assign[i]), gid,
                                   float(a_scores[i])):
                self.dropped_postings += 1
            for j in range(k1):
                term = int(t_ids[i, j])
                if term < 0:
                    continue
                if not _insert_posting(self._dt_entries, self._dt_scores,
                                       self._dt_lengths, term, gid,
                                       float(t_scores[i, j])):
                    self.dropped_postings += 1
        self._count += n_new
        self._cache = None
        self._epoch += 1
        if timings is not None:
            timings["device"] = t1 - t0
            timings["inserts"] = time.perf_counter() - t1
        return ids

    def delete_docs(self, doc_ids) -> None:
        """Tombstone documents by global id (base or delta; idempotent).
        Slots are reclaimed only by ``compact()``."""
        ids = np.asarray(doc_ids).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_docs):
            raise ValueError(
                f"doc id out of range [0, {self.n_docs}): "
                f"{ids[(ids < 0) | (ids >= self.n_docs)][:8]}")
        self._tomb[ids] = True
        self._cache = None
        self._epoch += 1

    # --- search ----------------------------------------------------------
    def delta_segment(self) -> DeltaSegment:
        self._materialize()
        return self._cache[0]

    def _materialize(self) -> None:
        """Move the delta planes and the tombstones to the device, once
        per epoch."""
        if self._cache is not None:
            return
        dev = self.device

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        delta = DeltaSegment(
            cluster_lists=PaddedLists(put(self._dc_entries),
                                      put(self._dc_lengths)),
            term_lists=PaddedLists(put(self._dt_entries),
                                   put(self._dt_lengths)),
            doc_planes={k: put(v) for k, v in self._delta_planes.items()},
            doc_assign=put(self._delta_assign),
            doc_ns=None if self._delta_ns is None else put(self._delta_ns),
            # the eviction score plane is the impact plane: -inf at empty
            # slots becomes 0.0, build_scored's pad fill
            sparse_weights=(
                None if self.base.sparse_weights is None else
                put(np.where(self._dt_entries == PAD_DOC, np.float32(0.0),
                             self._dt_scores))))
        self._cache = (delta, put(self._tomb))

    def search(self, query_embeddings, query_tokens, *, kc: int, k2: int,
               top_r: int, filter=None,
               fusion: Optional[qexec.FusionSpec] = None
               ) -> hi.SearchResult:
        """:func:`search` on the index's device; ``query_*`` may be numpy
        arrays or tensors, ``filter`` a (B, W) namespace bitmap (uint32
        numpy from the reference, or the int64 tensor of
        :func:`repro_torch.core.exec.filters.make_filter`)."""
        self._materialize()
        delta, tomb = self._cache
        return search(
            self.base, delta, tomb,
            dev_mod.as_tensor(query_embeddings, self.device, torch.float32),
            dev_mod.as_tensor(query_tokens, self.device, torch.int64),
            kc=kc, k2=k2, top_r=top_r,
            filter=(None if filter is None
                    else filters.as_words(filter, self.device)),
            fusion=fusion)

    # --- compaction ------------------------------------------------------
    def survivors(self) -> np.ndarray:
        """Old global ids of the live docs, in the (arrival) order the
        compacted index renumbers them: new id i ↔ old id survivors[i]."""
        return np.flatnonzero(~self._tomb[:self.n_docs])

    def surviving_corpus(self) -> tuple[np.ndarray, np.ndarray]:
        emb = np.concatenate([self._corpus_emb,
                              self._delta_emb[:self._count]])
        tokens = np.concatenate([self._corpus_tokens,
                                 self._delta_tokens[:self._count]])
        live = self.survivors()
        return emb[live], tokens[live]

    def surviving_namespaces(self) -> Optional[np.ndarray]:
        """Namespace ids of the survivors (None when unfiltered): what
        ``compact()`` re-indexes them under."""
        if not self.filtered:
            return None
        ns = np.concatenate([self._corpus_ns, self._delta_ns[:self._count]])
        return ns[self.survivors()]

    def compact(self, seed: Optional[int] = None) -> "MutableHybridIndex":
        """Fold delta + tombstones into a fresh base with an empty delta:
        a from-scratch build over the surviving corpus (KMeans, BM25
        statistics, codec training and all) with the original seed
        unless overridden, so the compacted index equals
        ``hi.build`` on the survivors, leaf for leaf.  Survivors are
        renumbered contiguously (:meth:`survivors` maps old to new)."""
        emb, tokens = self.surviving_corpus()
        if emb.shape[0] == 0:
            raise ValueError("cannot compact an index with zero live docs")
        out = type(self).create(
            self.seed if seed is None else seed, emb, tokens,
            self.vocab_size, delta_capacity=self.delta_capacity,
            delta_cluster_capacity=self.delta_cluster_capacity,
            delta_term_capacity=self.delta_term_capacity,
            doc_namespaces=self.surviving_namespaces(),
            selectors=self.selectors, device=self.device,
            **self.build_kwargs)
        # compaction renumbers survivors: epoch-keyed caches must not
        # serve pre-compaction entries against the new index
        out._epoch = self._epoch + 1
        return out

    # --- cost accounting (DESIGN.md §2 latency proxy) --------------------
    def families(self) -> list:
        """(cluster, term) list capacities per gather source."""
        return [(self.base.cluster_lists.capacity,
                 self.base.term_lists.capacity),
                (self.delta_cluster_capacity, self.delta_term_capacity)]

    def candidate_budget(self, kc: int, k2: int) -> int:
        return qexec.candidate_budget(kc, k2, self.families())

    def candidate_cost(self, kc: int, k2: int, top_r: int) -> int:
        return qexec.candidate_cost(self.base.codec, kc, k2, top_r,
                                    self.families())

    # --- persistence (read by repro_torch.checkpoint.load_mutable) -------
    def state_tree(self) -> dict:
        """The base index and every piece of delta and tombstone state,
        under the reference checkpoint's keys (the retained corpus, the
        namespace planes when filtered and the eviction score planes, so
        a restored index mutates as a never-saved one).  The reference
        also stores its build key; the port keeps its seed in
        :meth:`state_extra`."""
        delta = {
            "cluster_entries": self._dc_entries,
            "cluster_scores": self._dc_scores,
            "cluster_lengths": self._dc_lengths,
            "term_entries": self._dt_entries,
            "term_scores": self._dt_scores,
            "term_lengths": self._dt_lengths,
            "planes": self._delta_planes,
            "assign": self._delta_assign,
            "emb": self._delta_emb,
            "tokens": self._delta_tokens,
        }
        corpus = {"emb": self._corpus_emb, "tokens": self._corpus_tokens}
        if self.filtered:
            delta["ns"] = self._delta_ns
            corpus["ns"] = self._corpus_ns
        return {"base": self.base, "delta": delta,
                "tombstones": self._tomb, "corpus": corpus}

    def state_extra(self) -> dict:
        """JSON-able metadata stored next to :meth:`state_tree`: the
        reference's keys, plus the seed ``compact()`` replays."""
        return {"epoch": self._epoch,
                "delta_count": self._count,
                "delta_capacity": self.delta_capacity,
                "delta_cluster_capacity": self.delta_cluster_capacity,
                "delta_term_capacity": self.delta_term_capacity,
                "vocab_size": self.vocab_size,
                "build_kwargs": self.build_kwargs,
                "filtered": self.filtered,
                "sup_selectors": self.selectors is not None,
                "dropped_postings": self.dropped_postings,
                "seed": self.seed}

    @classmethod
    def from_state(cls, tree: dict, extra: dict, *, seed: int,
                   selectors=None) -> "MutableHybridIndex":
        """A mutable index from a :meth:`state_tree` (``base`` a
        :class:`~repro_torch.core.hybrid_index.HybridIndex` on the target
        device, every other leaf a numpy array) and its
        :meth:`state_extra` (or a manifest ``extra`` holding it under
        ``mutable``).  ``compact()`` replays ``seed``.  Supervised
        selector parameters are not part of the state: a checkpoint of a
        supervised index needs the same ``selectors=``."""
        m = extra["mutable"] if "mutable" in extra else extra
        if m.get("sup_selectors") and selectors is None:
            raise ValueError(
                "checkpoint was written from a supervised index; restore "
                "needs the matching selectors=")
        corpus_ns = tree["corpus"].get("ns")
        out = cls(tree["base"], vocab_size=int(m["vocab_size"]), seed=seed,
                  build_kwargs=dict(m["build_kwargs"]),
                  delta_capacity=int(m["delta_capacity"]),
                  delta_cluster_capacity=int(m["delta_cluster_capacity"]),
                  delta_term_capacity=int(m["delta_term_capacity"]),
                  corpus_emb=np.asarray(tree["corpus"]["emb"]),
                  corpus_tokens=np.asarray(tree["corpus"]["tokens"]),
                  corpus_ns=(None if corpus_ns is None
                             else np.asarray(corpus_ns)),
                  selectors=selectors)
        d = tree["delta"]
        # own, writable copies: all of this state is mutated in place
        out._dc_entries = np.array(d["cluster_entries"], np.int32)
        out._dc_scores = np.array(d["cluster_scores"], np.float32)
        out._dc_lengths = np.array(d["cluster_lengths"], np.int32)
        out._dt_entries = np.array(d["term_entries"], np.int32)
        out._dt_scores = np.array(d["term_scores"], np.float32)
        out._dt_lengths = np.array(d["term_lengths"], np.int32)
        out._delta_planes = {k: np.array(v) for k, v in d["planes"].items()}
        out._delta_assign = np.array(d["assign"], np.int32)
        if "ns" in d:
            out._delta_ns = np.array(d["ns"], np.int32)
        out._delta_emb = np.array(d["emb"], np.float32)
        out._delta_tokens = np.array(d["tokens"], np.int32)
        out._tomb = np.array(tree["tombstones"], bool)
        out._count = int(m["delta_count"])
        out.dropped_postings = int(m.get("dropped_postings", 0))
        # the epoch travels with the state: a restored index goes on
        # invalidating epoch-keyed caches where the saved one left off
        out._epoch = int(m.get("epoch", 0))
        out._cache = None
        return out

"""HI² — the Hybrid Inverted Index (port of
``repro/core/hybrid_index.py``: ``HybridIndex``, ``build``,
``build_ivf``, ``build_term_only``, ``base_source``, ``search``,
``search_ivf``, ``search_term_only``, ``candidate_budget``,
``candidate_cost``, ``with_tuned``; ``index_leaves`` stands in for the
reference's ``jax.tree.leaves`` of an index).

Each document is referenced from the inverted lists of exactly one
embedding cluster and K₁ᵀ salient terms.  :func:`build` computes them
on ``device`` — KMeans, BM25, codec training and encoding — and buckets
the lists on the host, as the reference does; an index can also be read
from a reference checkpoint (:mod:`repro_torch.checkpoint.checkpoint`).
A query is dispatched to K^C clusters and ≤ K₂ᵀ terms; the candidates
of both list families are merged, deduplicated, optionally filtered,
scored by the codec and the top-R returned (paper Eq. 5), as the
single-Source stage chain of :mod:`repro_torch.core.exec`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import device as dev_mod
from repro_torch import tree as tree_mod
from repro_torch.core import cluster_selector as cs_mod
from repro_torch.core import codecs
from repro_torch.core import exec as qexec
from repro_torch.core import inverted_lists as il
from repro_torch.core import term_selector as ts_mod
from repro_torch.core.exec import filters
from repro_torch.core.inverted_lists import PAD_DOC, PaddedLists

SearchResult = qexec.SearchResult
topk_by_score = qexec.topk_by_score


@dataclasses.dataclass(frozen=True)
class HybridIndex:
    cluster_sel: cs_mod.ClusterSelector
    term_sel: ts_mod.TermSelector
    cluster_lists: PaddedLists
    term_lists: PaddedLists
    codec_params: Any                # NamedTuple of tensors, or None
    doc_planes: dict                 # per-doc planes, every leaf (n_docs, ...)
    doc_assign: torch.Tensor         # φ(D), (n_docs,) i32
    doc_ns: Optional[torch.Tensor] = None          # (n_docs,) i32
    sparse_weights: Optional[torch.Tensor] = None  # (V, Ct) f32
    codec: str = codecs.DEFAULT
    # autotuned widths (DESIGN.md §14): metadata like the codec spec,
    # carried by checkpoints in the manifest and honoured by serving
    tuned: Optional[qexec.TunedWidths] = None
    # the most term-list postings of any one document (≤ K₁ᵀ), counted
    # from term_lists.entries when the index is built or loaded; it
    # bounds the sparse path's runs (stages.sparse_topk) and is never
    # stored in a checkpoint
    max_postings: Optional[int] = None

    def __post_init__(self):
        if self.max_postings is None:
            object.__setattr__(self, "max_postings",
                               count_max_postings(self.term_lists))

    @property
    def n_docs(self) -> int:
        return int(self.doc_assign.shape[0])

    @property
    def device(self) -> torch.device:
        return self.doc_assign.device

    def to(self, device) -> "HybridIndex":
        """The index with every tensor on ``device``."""
        opt = lambda t: None if t is None else t.to(device)  # noqa: E731
        return dataclasses.replace(
            self, cluster_sel=self.cluster_sel.to(device),
            term_sel=self.term_sel.to(device),
            cluster_lists=self.cluster_lists.to(device),
            term_lists=self.term_lists.to(device),
            codec_params=_params_to(self.codec_params, device),
            doc_planes={k: v.to(device) for k, v in self.doc_planes.items()},
            doc_assign=self.doc_assign.to(device),
            doc_ns=opt(self.doc_ns), sparse_weights=opt(self.sparse_weights))


def count_max_postings(lists: PaddedLists) -> int:
    """The most entries any one document has in ``lists`` (0 when the
    lists are empty); one device→host read."""
    ids = lists.entries.reshape(-1)
    ids = ids[ids != PAD_DOC].long()
    return int(torch.bincount(ids).max()) if ids.numel() else 0


#: (path, leaf) of every tensor or numpy array of an index (or any tree),
#: in the reference's leaf order: :func:`repro_torch.tree.leaves_with_paths`
index_leaves = tree_mod.leaves_with_paths


def _params_to(params, device):
    if params is None:
        return None
    if isinstance(params, dict):
        return {k: v.to(device) for k, v in params.items()}
    return params.to(device)


# --------------------------------------------------------------------------
# build
# --------------------------------------------------------------------------

def _generator(seed: int, stream: int, dev: torch.device) -> torch.Generator:
    """An independent generator per build stream (clusters, codec), as
    the reference splits its key: injecting ``cluster_sel`` does not
    move the codec's draws."""
    sub = np.random.SeedSequence([seed, stream]).generate_state(1)[0]
    return torch.Generator(device=dev).manual_seed(int(sub))


def _pad_lists(n_lists: int, dev: torch.device) -> PaddedLists:
    return PaddedLists(
        entries=torch.full((n_lists, 1), PAD_DOC, dtype=torch.int32,
                           device=dev),
        lengths=torch.zeros((n_lists,), dtype=torch.int32, device=dev))


def assigned_scores(cluster_sel: cs_mod.ClusterSelector, x: torch.Tensor,
                     assign: torch.Tensor) -> torch.Tensor:
    """⟨e_D, e_φ(D)⟩ per document, read off the same score matmul as
    :func:`cluster_selector.select_for_doc`, one block at a time."""
    return torch.cat([
        torch.gather(cs_mod.scores(cluster_sel, xb), 1,
                     ab[:, None].long())[:, 0]
        for xb, ab in zip(x.split(cs_mod.BLOCK), assign.split(cs_mod.BLOCK))])


def build(seed: int,
          doc_embeddings,
          doc_tokens,
          vocab_size: int,
          *,
          n_clusters: int,
          k1_terms: int,
          codec: str = codecs.DEFAULT,
          pq_m: int = 8,
          pq_k: int = 256,
          cluster_capacity: Optional[int] = None,
          term_capacity: Optional[int] = None,
          cluster_sel: Optional[cs_mod.ClusterSelector] = None,
          doc_assign=None,
          term_pos_scores=None,
          term_sel: Optional[ts_mod.TermSelector] = None,
          kmeans_iters: int = 15,
          use_clusters: bool = True,
          use_terms: bool = True,
          doc_namespaces=None,
          sparse: bool = False,
          device: dev_mod.DeviceLike = "cuda",
          timings: Optional[dict] = None,
          ) -> HybridIndex:
    """Build HI² over a corpus on ``device`` (the reference's
    ``build``, with ``seed`` in place of its key).

    The unsupervised path computes everything here (KMeans + BM25 +
    codec training); a caller may inject ``cluster_sel`` /
    ``doc_assign`` / ``term_pos_scores`` / ``term_sel`` instead.
    ``use_clusters`` / ``use_terms`` are the paper's ablations (§5.3),
    ``doc_namespaces`` ((n_docs,) ids) enables filtered search.
    ``sparse=True`` also builds the BM25 impact plane next to the term
    lists, for hybrid search through ``search(fusion=...)`` (DESIGN.md
    §13).  ``timings``, when a dict, receives the seconds of each build
    stage."""
    codec_impl = codecs.get(codec)    # fail fast on unknown specs
    if sparse and not use_terms:
        raise ValueError("sparse=True needs the term lists "
                         "(use_terms=True): the sparse path scores over "
                         "the term postings")
    dev = dev_mod.resolve(device)
    emb = dev_mod.as_tensor(doc_embeddings, dev, torch.float32)
    tokens = dev_mod.as_tensor(doc_tokens, dev, torch.int64)
    n_docs = emb.shape[0]
    if doc_namespaces is not None:    # fail fast BEFORE kmeans/codec train
        doc_namespaces = dev_mod.as_tensor(doc_namespaces, dev, torch.int32)
        if tuple(doc_namespaces.shape) != (n_docs,):
            raise ValueError(
                f"doc_namespaces must be ({n_docs},), got "
                f"{tuple(doc_namespaces.shape)}")
        if int(doc_namespaces.min()) < 0:
            raise ValueError("doc_namespaces must be non-negative ids")
    clock = [time.perf_counter()]

    def stage(name: str) -> None:
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            timings[name] = now - clock[0]
            clock[0] = now

    # --- cluster side -----------------------------------------------------
    if cluster_sel is None:
        cluster_sel, doc_assign = cs_mod.init_kmeans(
            _generator(seed, 0, dev), emb, n_clusters, n_iters=kmeans_iters)
    else:
        cluster_sel = cluster_sel.to(dev)
        if doc_assign is None:
            doc_assign = cs_mod.select_for_doc(cluster_sel, emb)
    doc_assign = dev_mod.as_tensor(doc_assign, dev, torch.int32)
    stage("clusters")
    if use_clusters:
        cluster_lists = il.build(
            np.arange(n_docs), doc_assign.cpu().numpy(),
            assigned_scores(cluster_sel, emb, doc_assign).cpu().numpy(),
            n_lists=n_clusters, capacity=cluster_capacity, device=dev)
    else:
        cluster_lists = _pad_lists(n_clusters, dev)
    stage("cluster_lists")

    # --- term side --------------------------------------------------------
    if term_sel is None or term_pos_scores is None:
        term_sel, term_pos_scores, _ = ts_mod.fit_unsup(tokens, vocab_size)
    else:
        term_sel = term_sel.to(dev)
        term_pos_scores = dev_mod.as_tensor(term_pos_scores, dev,
                                            torch.float32)
    stage("bm25")
    sparse_weights = None
    if use_terms:
        term_ids, term_scores = ts_mod.doc_terms(tokens, term_pos_scores,
                                                 k1_terms)
        postings = (np.repeat(np.arange(n_docs), k1_terms),
                    term_ids.cpu().numpy().reshape(-1),
                    term_scores.cpu().numpy().reshape(-1))
        kw = dict(n_lists=vocab_size, capacity=term_capacity, device=dev)
        if sparse:
            term_lists, sparse_weights = il.build_scored(*postings, **kw)
        else:
            term_lists = il.build(*postings, **kw)
    else:
        term_lists = _pad_lists(vocab_size, dev)
    stage("term_lists")

    # --- codec ------------------------------------------------------------
    codec_params = codec_impl.train(_generator(seed, 1, dev), emb,
                                    pq_m=pq_m, pq_k=pq_k)
    stage("codec_train")
    doc_planes = codec_impl.encode(codec_params, emb)
    stage("codec_encode")
    return HybridIndex(cluster_sel=cluster_sel, term_sel=term_sel,
                       cluster_lists=cluster_lists, term_lists=term_lists,
                       codec_params=codec_params, doc_planes=doc_planes,
                       doc_assign=doc_assign, doc_ns=doc_namespaces,
                       sparse_weights=sparse_weights, codec=codec)


def build_ivf(seed: int, doc_embeddings, doc_tokens, vocab_size: int, *,
              n_clusters: int, codec: str = "opq", pq_m: int = 8,
              pq_k: int = 256, cluster_capacity: Optional[int] = None,
              cluster_sel=None, doc_assign=None, kmeans_iters: int = 15,
              device: dev_mod.DeviceLike = "cuda") -> HybridIndex:
    """Cluster-only index (IVF-Flat / IVF-PQ / IVF-OPQ): the same build
    with the term lists off, so only the dispatched lists differ."""
    return build(seed, doc_embeddings, doc_tokens, vocab_size,
                 n_clusters=n_clusters, k1_terms=1, codec=codec,
                 pq_m=pq_m, pq_k=pq_k, cluster_capacity=cluster_capacity,
                 cluster_sel=cluster_sel, doc_assign=doc_assign,
                 kmeans_iters=kmeans_iters, use_clusters=True,
                 use_terms=False, device=device)


def build_term_only(seed: int, doc_embeddings, doc_tokens, vocab_size: int,
                    *, k1_terms: int, codec: str = "opq", pq_m: int = 8,
                    pq_k: int = 256, term_capacity: Optional[int] = None,
                    term_pos_scores=None, term_sel=None,
                    device: dev_mod.DeviceLike = "cuda") -> HybridIndex:
    """Term-only index (the paper's w.o. Clus ablation)."""
    return build(seed, doc_embeddings, doc_tokens, vocab_size,
                 n_clusters=1, k1_terms=k1_terms, codec=codec,
                 pq_m=pq_m, pq_k=pq_k, term_capacity=term_capacity,
                 term_pos_scores=term_pos_scores, term_sel=term_sel,
                 use_clusters=False, use_terms=True, device=device)


# --------------------------------------------------------------------------
# search — one exec.Source over this index
# --------------------------------------------------------------------------

def base_source(index: HybridIndex) -> qexec.Source:
    """The index as a single query-execution gather source."""
    return qexec.Source(cluster_lists=index.cluster_lists,
                        term_lists=index.term_lists,
                        doc_planes=index.doc_planes, size=index.n_docs,
                        doc_ns=index.doc_ns,
                        sparse_weights=index.sparse_weights,
                        max_postings=index.max_postings)


def search(index: HybridIndex, query_embeddings, query_tokens, *,
           kc: int, k2: int, top_r: int, filter=None, fusion=None,
           device: dev_mod.DeviceLike = "cuda") -> SearchResult:
    """Eq. 5: A(Q) = A^C(Q) ∪ A^T(Q), then codec scoring + top-R.

    ``query_embeddings`` (B, h) and ``query_tokens`` (B, len) may be
    numpy arrays or tensors; they move to ``device``, where the index
    must already live.  ``filter`` is an optional (B, W) namespace
    bitmap (uint32 numpy from the reference, or the int64 tensor of
    :func:`repro_torch.core.exec.filters.make_filter`).  ``fusion`` (a
    :class:`~repro_torch.core.exec.FusionSpec`) adds hybrid dense∥sparse
    search on an index built with ``sparse=True`` (DESIGN.md §13); on
    an index without the impact plane the result is the dense one, bit
    for bit."""
    dev = dev_mod.resolve(device)
    if index.device != dev:
        raise ValueError(f"index lives on {index.device}, search asked for "
                         f"{dev}; move it with index.to({str(dev)!r})")
    qe = dev_mod.as_tensor(query_embeddings, dev, torch.float32)
    qt = dev_mod.as_tensor(query_tokens, dev, torch.int64)
    ns = None if filter is None else filters.as_words(filter, dev)
    with torch.inference_mode():
        return qexec.execute(
            codecs.get(index.codec), index.codec_params, index.cluster_sel,
            index.term_sel, [base_source(index)], qe, qt,
            kc=kc, k2=k2, top_r=top_r, ns_filter=ns, fusion=fusion)


def candidate_budget(index: HybridIndex, kc: int, k2: int) -> int:
    """Static per-query candidate slots — the latency proxy (§2)."""
    return qexec.candidate_budget(
        kc, k2, [(index.cluster_lists.capacity, index.term_lists.capacity)])


def candidate_cost(index: HybridIndex, kc: int, k2: int, top_r: int) -> int:
    """:func:`candidate_budget` plus the codec's refine work (§7)."""
    return qexec.candidate_cost(
        index.codec, kc, k2, top_r,
        [(index.cluster_lists.capacity, index.term_lists.capacity)])


def with_tuned(index: HybridIndex,
               tuned: Optional[qexec.TunedWidths]) -> HybridIndex:
    """The index with ``tuned`` width metadata attached (DESIGN.md §14):
    the same planes, only the record changes."""
    return dataclasses.replace(index, tuned=tuned)


def search_ivf(index: HybridIndex, query_embeddings, query_tokens, *,
               kc: int, top_r: int,
               device: dev_mod.DeviceLike = "cuda") -> SearchResult:
    """Search with the term side off (k2=1 over an IVF index's PAD
    term lists)."""
    return search(index, query_embeddings, query_tokens, kc=kc, k2=1,
                  top_r=top_r, device=device)


def search_term_only(index: HybridIndex, query_embeddings, query_tokens, *,
                     k2: int, top_r: int,
                     device: dev_mod.DeviceLike = "cuda") -> SearchResult:
    return search(index, query_embeddings, query_tokens, kc=1, k2=k2,
                  top_r=top_r, device=device)

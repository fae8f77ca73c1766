"""HI² — the Hybrid Inverted Index, search side (port of
``repro/core/hybrid_index.py``: ``HybridIndex``, ``base_source``,
``search``, ``search_ivf``, ``search_term_only``, ``candidate_budget``,
``candidate_cost``; the build comes with a later slice — until then an
index is loaded from a reference checkpoint, see
:mod:`repro_torch.checkpoint.checkpoint`).

A query is dispatched to K^C clusters and ≤ K₂ᵀ terms; the candidates
of both list families are merged, deduplicated, optionally filtered,
scored by the codec and the top-R returned (paper Eq. 5), as the
single-Source stage chain of :mod:`repro_torch.core.exec`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import device as dev_mod
from repro_torch.core import cluster_selector as cs_mod
from repro_torch.core import codecs
from repro_torch.core import exec as qexec
from repro_torch.core import term_selector as ts_mod
from repro_torch.core.exec import filters
from repro_torch.core.inverted_lists import PaddedLists

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
            codec_params=(None if self.codec_params is None
                          else self.codec_params.to(device)),
            doc_planes={k: v.to(device) for k, v in self.doc_planes.items()},
            doc_assign=self.doc_assign.to(device),
            doc_ns=opt(self.doc_ns), sparse_weights=opt(self.sparse_weights))


def base_source(index: HybridIndex) -> qexec.Source:
    """The index as a single query-execution gather source."""
    return qexec.Source(cluster_lists=index.cluster_lists,
                        term_lists=index.term_lists,
                        doc_planes=index.doc_planes, size=index.n_docs,
                        doc_ns=index.doc_ns)


def search(index: HybridIndex, query_embeddings, query_tokens, *,
           kc: int, k2: int, top_r: int, filter=None, fusion=None,
           device: dev_mod.DeviceLike = "cuda") -> SearchResult:
    """Eq. 5: A(Q) = A^C(Q) ∪ A^T(Q), then codec scoring + top-R.

    ``query_embeddings`` (B, h) and ``query_tokens`` (B, len) may be
    numpy arrays or tensors; they move to ``device``, where the index
    must already live.  ``filter`` is an optional (B, W) namespace
    bitmap (uint32 numpy from the reference, or the int64 tensor of
    :func:`repro_torch.core.exec.filters.make_filter`).  Hybrid fusion
    is not yet ported."""
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

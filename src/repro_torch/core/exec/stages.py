"""The staged query-execution engine, single device (port of
``repro/core/exec/stages.py``; DESIGN.md §9):

    dispatch → gather → dedup → filter → score → topk → refine

over a list of :class:`Source`s on one device: one for an immutable
index, the (base, delta) pair of the mutable one
(:mod:`repro_torch.core.segments`, DESIGN.md §8), whose tombstones the
filter stage masks before selection.  ``execute(shard=...)`` raises
``NotImplementedError`` until the sharding slice lands.
``execute(fusion=...)`` adds the sparse BM25 path and the RRF fusion of
DESIGN.md §13 (:func:`sparse_topk`, :func:`fuse`) after refine.

Selection goes through :func:`topk_by_score`'s total order (score desc,
doc id asc), so results are a pure function of the (score, id) set of
the candidates, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Sequence

import torch

from repro_torch.core import cluster_selector as cs_mod
from repro_torch.core import inverted_lists as il
from repro_torch.core import term_selector as ts_mod
from repro_torch.core.codecs import base as codecs_base
from repro_torch.core.exec import filters
from repro_torch.core.exec import fusion as fusion_mod
from repro_torch.core.exec.fusion import FusionSpec
from repro_torch.core.inverted_lists import PAD_DOC, PaddedLists


class SearchResult(NamedTuple):
    doc_ids: torch.Tensor        # (B, R) i32, PAD_DOC when fewer candidates
    scores: torch.Tensor         # (B, R) f32
    n_candidates: torch.Tensor   # (B,) i32 — unique live docs evaluated
    partial: Any = False         # True only on degraded sharded serving


@dataclasses.dataclass(frozen=True)
class Source:
    """One gather+score source: a (cluster, term) list family over one
    set of codec doc planes, with the global id of local row 0.
    ``family_lo``/``family_hi`` bound the global id range of the whole
    family this source belongs to (base docs or delta slots), which
    routes refine-stage gathers when several families coexist.
    ``tombstones``/``doc_ns`` are optional per-row planes the filter
    stage reads; ``sparse_weights`` is the BM25 impact plane aligned with
    ``term_lists.entries`` that the sparse path of
    ``execute(fusion=...)`` reads (DESIGN.md §13)."""
    cluster_lists: PaddedLists
    term_lists: PaddedLists
    doc_planes: dict
    size: int                                    # local rows per plane
    offset: int = 0
    family_lo: int = 0
    family_hi: Optional[int] = None              # default offset + size
    tombstones: Optional[torch.Tensor] = None    # (size,) bool
    doc_ns: Optional[torch.Tensor] = None        # (size,) i32 namespaces
    sparse_weights: Optional[torch.Tensor] = None  # (V, Ct) f32 impacts

    @property
    def hi_bound(self) -> int:
        """Upper bound on the global ids this source may own."""
        return (self.offset + self.size if self.family_hi is None
                else self.family_hi)


@dataclasses.dataclass
class Frontier:
    """Per-stage state: the candidate id plane plus each source's
    local-row view of its block of it."""
    cands: torch.Tensor                    # (B, C) global ids
    local: tuple                           # per-source (B, C_s) rows
    live: Optional[torch.Tensor] = None    # (B, C) bool
    scores: Optional[torch.Tensor] = None  # (B, C) f32, -inf where masked


# --------------------------------------------------------------------------
# selection primitive
# --------------------------------------------------------------------------

def topk_by_score(scores: torch.Tensor, ids: torch.Tensor, r: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-r rows under the total order (score desc, doc id asc) →
    (scores, ids) of shape (B, r), ``-inf``/PAD_DOC filled when fewer
    than r slots exist.

    The reference is one two-key ``lax.sort``; torch has no multi-key
    sort, so this sorts stably by id, then stably by descending score."""
    by_id = torch.argsort(ids, dim=-1, stable=True)
    return _topk_of_id_sorted(torch.gather(scores, -1, by_id),
                              torch.gather(ids, -1, by_id), r)


def _topk_of_id_sorted(s: torch.Tensor, i: torch.Tensor, r: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`topk_by_score` of rows whose ids already ascend (the
    output of :func:`fusion.sum_by_doc`): a stable sort by descending
    score alone gives the total order."""
    top_s, order = torch.sort(s, dim=-1, descending=True, stable=True)
    k_eff = min(r, s.shape[-1])
    top_s = top_s[..., :k_eff]
    top_ids = torch.gather(i, -1, order[..., :k_eff])
    if k_eff < r:
        top_s = torch.nn.functional.pad(top_s, (0, r - k_eff),
                                        value=-torch.inf)
        top_ids = torch.nn.functional.pad(top_ids, (0, r - k_eff),
                                          value=PAD_DOC)
    return top_s, top_ids


# --------------------------------------------------------------------------
# stages
# --------------------------------------------------------------------------

def dispatch(cluster_sel: cs_mod.ClusterSelector,
             term_sel: ts_mod.TermSelector, query_embeddings: torch.Tensor,
             query_tokens: torch.Tensor, kc: int, k2: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Query → K^C cluster list ids + ≤K₂ᵀ term list ids (Eq. 5 LHS).
    On the card the cluster top-k is the ``topk_scores`` kernel."""
    cluster_ids, _ = cs_mod.select_for_query(cluster_sel, query_embeddings,
                                             kc)
    term_ids = ts_mod.query_terms(term_sel, query_tokens, k2)
    return cluster_ids, term_ids


def gather(sources: Sequence[Source], cluster_ids: torch.Tensor,
           term_ids: torch.Tensor) -> Frontier:
    """Every source's dispatched list rows in one candidate plane
    (source-major, [cluster | term] within a source)."""
    pieces, local = [], []
    for s in sources:
        c = torch.cat([il.gather_candidates(s.cluster_lists, cluster_ids),
                       il.gather_candidates(s.term_lists, term_ids)], dim=-1)
        pieces.append(c)
        local.append((c - s.offset).clamp(0, s.size - 1))
    cands = pieces[0] if len(pieces) == 1 else torch.cat(pieces, -1)
    return Frontier(cands=cands, local=tuple(local))


def dedup(frontier: Frontier) -> torch.Tensor:
    """First-occurrence mask over the whole candidate plane."""
    return il.dedup_mask(frontier.cands)


def filter_stage(frontier: Frontier, sources: Sequence[Source],
                 keep: torch.Tensor, ns_filter: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """keep ∧ ¬tombstoned ∧ namespace-allowed, per candidate slot: a
    filtered doc carries ``-inf`` into selection, so it can never take a
    top-R′ slot or come back through refine (DESIGN.md §9)."""
    live = keep
    if any(s.tombstones is not None for s in sources):
        dead = torch.cat([
            s.tombstones[loc.long()] if s.tombstones is not None
            else torch.zeros(loc.shape, dtype=torch.bool, device=loc.device)
            for s, loc in zip(sources, frontier.local)], -1)
        live = live & ~dead
    if ns_filter is None:
        return live
    missing = [i for i, s in enumerate(sources) if s.doc_ns is None]
    if missing:
        raise ValueError(
            "search(filter=...) needs namespace planes on every source, "
            f"but source(s) {missing} have none — load an index built "
            "with doc_namespaces= / pass namespaces= to add_docs")
    ns = torch.cat([s.doc_ns[loc.long()]
                    for s, loc in zip(sources, frontier.local)], -1)
    return live & filters.allowed_mask(ns_filter, ns)


def score(codec_impl: codecs_base.Codec, codec_params: Any,
          sources: Sequence[Source], frontier: Frontier, live: torch.Tensor,
          query_embeddings: torch.Tensor) -> torch.Tensor:
    """Codec-score each source's block against its own doc planes; each
    scorer owns the mask-to-``-inf`` (the fused kernel applies it)."""
    parts, off = [], 0
    for s, loc in zip(sources, frontier.local):
        w = loc.shape[-1]
        scorer = codec_impl.make_scorer(codec_params, s.doc_planes,
                                        query_embeddings)
        parts.append(scorer(loc, live[..., off:off + w]))
        off += w
    return parts[0] if len(parts) == 1 else torch.cat(parts, -1)


def topk(frontier: Frontier, r_prime: int
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Total-order top-R′ selection over the scored frontier."""
    return topk_by_score(frontier.scores, frontier.cands, r_prime)


def sparse_topk(sources: Sequence[Source], term_ids: torch.Tensor, r: int,
                ns_filter: Optional[torch.Tensor]
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sparse (BM25) query path (DESIGN.md §13): top-r documents by
    summed term impact over the ≤K₂ᵀ dispatched term lists of every
    source, which the dense path probes too.  Tombstoned and
    namespace-filtered postings mask to (PAD_DOC, 0) per source, as in
    the dense filter stage; documents whose impacts sum to 0 rank as
    non-matches.  Returns ``(scores, ids, n_sparse)``: (B, r) planes
    (``-inf``/PAD_DOC padded) and the unique matched-doc count per
    query."""
    b = term_ids.shape[0]
    safe = term_ids.clamp(min=0).long()
    probed = (term_ids >= 0)[:, :, None]
    ids_parts, w_parts = [], []
    for s in sources:
        ids = torch.where(probed, s.term_lists.entries[safe],
                          PAD_DOC).reshape(b, -1)
        w = torch.where(probed, s.sparse_weights[safe], 0.0).reshape(b, -1)
        live = ids != PAD_DOC
        if s.tombstones is not None or ns_filter is not None:
            loc = (ids - s.offset).clamp(0, s.size - 1).long()
            if s.tombstones is not None:
                live = live & ~s.tombstones[loc]
            if ns_filter is not None:
                live = live & filters.allowed_mask(ns_filter, s.doc_ns[loc])
        ids_parts.append(torch.where(live, ids, PAD_DOC))
        w_parts.append(torch.where(live, w, 0.0))
    sid, totals, first = fusion_mod.sum_by_doc(torch.cat(ids_parts, -1),
                                               torch.cat(w_parts, -1))
    rep = first & (sid != PAD_DOC) & (totals > 0.0)
    scores = torch.where(rep, totals, -torch.inf)
    top_s, top_ids = _topk_of_id_sorted(scores, sid, r)
    return top_s, top_ids, rep.sum(dim=-1, dtype=torch.int32)


def fuse(dense_scores: torch.Tensor, dense_ids: torch.Tensor,
         sparse_scores: torch.Tensor, sparse_ids: torch.Tensor,
         fusion: FusionSpec, top_r: int
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reciprocal-rank fusion of the final dense and sparse rankings
    (DESIGN.md §13): ``weight/(rrf_k+1+rank)`` from the dense list,
    ``(1−weight)/(rrf_k+1+rank)`` from the sparse one, summed per
    document and selected under :func:`topk_by_score`'s total order.
    At ``weight=1.0`` sparse contributions are exactly 0.0 and
    sparse-only documents mask out, so the fused ids equal the
    dense-only ones bit for bit."""
    d = fusion_mod.rrf_contributions(dense_scores, fusion.weight,
                                     fusion.rrf_k)
    sp = fusion_mod.rrf_contributions(sparse_scores, 1.0 - fusion.weight,
                                      fusion.rrf_k)
    ids = torch.cat(
        [torch.where(torch.isfinite(dense_scores), dense_ids, PAD_DOC),
         torch.where(torch.isfinite(sparse_scores), sparse_ids.to(
             dense_ids.dtype), PAD_DOC)], -1)
    sid, totals, first = fusion_mod.sum_by_doc(ids, torch.cat([d, sp], -1))
    live = first & (sid != PAD_DOC) & (totals > 0.0)
    return _topk_of_id_sorted(torch.where(live, totals, -torch.inf), sid,
                              top_r)


# --------------------------------------------------------------------------
# refine plumbing: route frontier ids back to the owning source
# --------------------------------------------------------------------------

def _route_gather(sources: Sequence[Source], plane_group,
                  ids: torch.Tensor) -> torch.Tensor:
    """Rows for global ``ids`` from per-source planes (one plane for one
    source, else a tuple in source order), each id routed to the family
    that stores it: ids at or above a later source's ``family_lo`` take
    its rows.  Out-of-source rows are clipped garbage that callers mask
    through ``owned`` or finite scores."""
    if len(sources) == 1:
        s = sources[0]
        return plane_group[(ids - s.offset).clamp(0, s.size - 1).long()]
    rows = None
    for s, plane in zip(sources, plane_group):
        mine = plane[(ids - s.offset).clamp(0, s.size - 1).long()]
        if rows is None:
            rows = mine
            continue
        here = (ids >= s.family_lo).reshape(
            ids.shape + (1,) * (mine.dim() - ids.dim()))
        rows = torch.where(here, mine, rows)
    return rows


def refine_planes(sources: Sequence[Source]) -> dict:
    """The doc planes handed to ``codec.refine``: one source's own, else
    per-key tuples of every source's planes (``ctx.gather`` routes
    them)."""
    if len(sources) == 1:
        return sources[0].doc_planes
    return {k: tuple(s.doc_planes[k] for s in sources)
            for k in sources[0].doc_planes}


def make_refine_ctx(sources: Sequence[Source]) -> codecs_base.RefineCtx:
    """RefineCtx over a source list: gathers route by family range,
    ``owned`` is the union of the sources' id ranges, ``psum`` the
    identity (one device)."""
    def gather_fn(plane_group, ids):
        return _route_gather(sources, plane_group, ids)

    def owned(ids):
        mask = None
        for s in sources:
            m = ((ids >= s.offset) & (ids < s.offset + s.size)
                 & (ids < s.hi_bound))
            mask = m if mask is None else mask | m
        return mask

    return codecs_base.RefineCtx(gather=gather_fn, owned=owned,
                                 psum=lambda x: x)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

def execute(codec_impl: codecs_base.Codec, codec_params: Any,
            cluster_sel: cs_mod.ClusterSelector,
            term_sel: ts_mod.TermSelector, sources: Sequence[Source],
            query_embeddings: torch.Tensor, query_tokens: torch.Tensor, *,
            kc: int, k2: int, top_r: int,
            ns_filter: Optional[torch.Tensor] = None,
            shard: Any = None,
            fusion: Optional[FusionSpec] = None) -> SearchResult:
    """Run the stage chain over ``sources`` (Eq. 5 + DESIGN.md §9).
    ``ns_filter`` is an int64 (B, W) namespace bitmap
    (:func:`repro_torch.core.exec.filters.make_filter`) or None.

    ``fusion`` (a :class:`FusionSpec`) adds the sparse BM25 path and RRF
    fusion after refine when every source carries ``sparse_weights``;
    otherwise the result is the dense-only one, bit for bit.  Under
    fusion, ``scores`` are RRF mass and ``n_candidates`` also counts the
    unique sparse-matched documents (a document both paths see counts
    in each)."""
    if shard is not None:
        raise NotImplementedError("sharded execution is not yet ported")
    cluster_ids, term_ids = dispatch(cluster_sel, term_sel,
                                     query_embeddings, query_tokens, kc, k2)
    frontier = gather(sources, cluster_ids, term_ids)
    keep = dedup(frontier)
    frontier.live = filter_stage(frontier, sources, keep, ns_filter)
    frontier.scores = score(codec_impl, codec_params, sources, frontier,
                            frontier.live, query_embeddings)
    top_s, top_ids = topk(frontier, codec_impl.refine_width(top_r))
    top_s, top_ids = codec_impl.refine(
        codec_params, refine_planes(sources), query_embeddings,
        top_s, top_ids, top_r, make_refine_ctx(sources))
    # the reference's §13 contract: an index without the impact plane
    # serves the dense-only result, unchanged to the bit
    if fusion is not None and all(s.sparse_weights is not None
                                  for s in sources):
        sp_s, sp_ids, n_sparse = sparse_topk(sources, term_ids, top_r,
                                             ns_filter)
        top_s, top_ids = fuse(top_s, top_ids, sp_s, sp_ids, fusion, top_r)
    else:
        n_sparse = 0
    n_cand = frontier.live.sum(dim=-1, dtype=torch.int32) + n_sparse
    valid = torch.isfinite(top_s)
    return SearchResult(
        doc_ids=torch.where(valid, top_ids,
                            torch.full_like(top_ids, PAD_DOC)).to(torch.int32),
        scores=torch.where(valid, top_s, torch.zeros_like(top_s)),
        n_candidates=n_cand)

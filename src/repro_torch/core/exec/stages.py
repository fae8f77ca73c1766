"""The staged query-execution engine, single device (port of
``repro/core/exec/stages.py``; DESIGN.md §9):

    dispatch → gather → dedup → filter → score → topk → refine

over a list of :class:`Source`s.  This slice serves one Source on one
device: several sources (the mutable index), ``execute(shard=...)`` and
``execute(fusion=...)`` raise ``NotImplementedError`` until the
mutable, sharding and fusion slices land.

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
from repro_torch.core.inverted_lists import PAD_DOC, PaddedLists


class SearchResult(NamedTuple):
    doc_ids: torch.Tensor        # (B, R) i32, PAD_DOC when fewer candidates
    scores: torch.Tensor         # (B, R) f32
    n_candidates: torch.Tensor   # (B,) i32 — unique live docs evaluated
    partial: Any = False         # True only on degraded sharded serving


@dataclasses.dataclass(frozen=True)
class Source:
    """One gather+score source: a (cluster, term) list family over one
    set of codec doc planes, with the global id of local row 0 and the
    optional namespace plane the filter stage reads.  (The reference's
    tombstone, family-range and impact planes come with the mutable and
    fusion slices.)"""
    cluster_lists: PaddedLists
    term_lists: PaddedLists
    doc_planes: dict
    size: int                                    # local rows per plane
    offset: int = 0
    doc_ns: Optional[torch.Tensor] = None        # (size,) i32 namespaces


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
    s = torch.gather(scores, -1, by_id)
    i = torch.gather(ids, -1, by_id)
    top_s, order = torch.sort(s, dim=-1, descending=True, stable=True)
    k_eff = min(r, scores.shape[-1])
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
    """keep ∧ namespace-allowed, per candidate slot: a filtered doc
    carries ``-inf`` into selection (DESIGN.md §9)."""
    if ns_filter is None:
        return keep
    missing = [i for i, s in enumerate(sources) if s.doc_ns is None]
    if missing:
        raise ValueError(
            "search(filter=...) needs namespace planes on every source, "
            f"but source(s) {missing} have none — load an index built "
            "with doc_namespaces=")
    ns = torch.cat([s.doc_ns[loc.long()]
                    for s, loc in zip(sources, frontier.local)], -1)
    return keep & filters.allowed_mask(ns_filter, ns)


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


# --------------------------------------------------------------------------
# refine plumbing (one source; multi-source routing comes with the
# mutable slice)
# --------------------------------------------------------------------------

def make_refine_ctx(source: Source) -> codecs_base.RefineCtx:
    """RefineCtx over one source: gathers map global ids to its rows,
    ``owned`` is its id range, ``psum`` the identity."""
    def gather_fn(plane, ids):
        return plane[(ids - source.offset).clamp(0, source.size - 1).long()]

    def owned(ids):
        return (ids >= source.offset) & (ids < source.offset + source.size)

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
            shard: Any = None, fusion: Any = None) -> SearchResult:
    """Run the stage chain over ``sources`` (Eq. 5 + DESIGN.md §9).
    ``ns_filter`` is an int64 (B, W) namespace bitmap
    (:func:`repro_torch.core.exec.filters.make_filter`) or None."""
    if shard is not None:
        raise NotImplementedError("sharded execution is not yet ported")
    if len(sources) != 1:
        raise NotImplementedError("multi-source (mutable) execution is not "
                                  "yet ported")
    if fusion is not None:
        raise NotImplementedError("hybrid dense∥sparse fusion is not yet "
                                  "ported")
    cluster_ids, term_ids = dispatch(cluster_sel, term_sel,
                                     query_embeddings, query_tokens, kc, k2)
    frontier = gather(sources, cluster_ids, term_ids)
    keep = dedup(frontier)
    frontier.live = filter_stage(frontier, sources, keep, ns_filter)
    frontier.scores = score(codec_impl, codec_params, sources, frontier,
                            frontier.live, query_embeddings)
    top_s, top_ids = topk(frontier, codec_impl.refine_width(top_r))
    top_s, top_ids = codec_impl.refine(
        codec_params, sources[0].doc_planes, query_embeddings,
        top_s, top_ids, top_r, make_refine_ctx(sources[0]))
    n_cand = frontier.live.sum(dim=-1, dtype=torch.int32)
    valid = torch.isfinite(top_s)
    return SearchResult(
        doc_ids=torch.where(valid, top_ids,
                            torch.full_like(top_ids, PAD_DOC)).to(torch.int32),
        scores=torch.where(valid, top_s, torch.zeros_like(top_s)),
        n_candidates=n_cand)

"""The query-execution layer (port of ``repro/core/exec``; DESIGN.md
§9): :mod:`.stages` (the engine, over one source or the mutable index's
(base, delta) pair), :mod:`.filters` (namespace bitmaps),
:mod:`.fusion` (the hybrid dense∥sparse spec and its per-document
aggregation, DESIGN.md §13) and :mod:`.cost` (the latency proxy).  The
frontier tuner and sharded execution come with later slices."""
from repro_torch.core.exec import filters
from repro_torch.core.exec.cost import candidate_budget, candidate_cost
from repro_torch.core.exec.fusion import FusionSpec
from repro_torch.core.exec.stages import (Frontier, SearchResult, Source,
                                          dedup, dispatch, execute,
                                          filter_stage, fuse, gather,
                                          make_refine_ctx, refine_planes,
                                          score, sparse_topk, topk,
                                          topk_by_score)

__all__ = [
    "Frontier", "FusionSpec", "SearchResult", "Source", "candidate_budget",
    "candidate_cost", "dedup", "dispatch", "execute", "filter_stage",
    "filters", "fuse", "gather", "make_refine_ctx", "refine_planes",
    "score", "sparse_topk", "topk", "topk_by_score",
]

"""The query-execution layer (port of ``repro/core/exec``; DESIGN.md
§9): :mod:`.stages` (the engine), :mod:`.filters` (namespace bitmaps)
and :mod:`.cost` (the latency proxy).  Fusion, the frontier tuner and
sharded execution come with later slices."""
from repro_torch.core.exec import filters
from repro_torch.core.exec.cost import candidate_budget, candidate_cost
from repro_torch.core.exec.stages import (Frontier, SearchResult, Source,
                                          dedup, dispatch, execute,
                                          filter_stage, gather,
                                          make_refine_ctx, score, topk,
                                          topk_by_score)

__all__ = [
    "Frontier", "SearchResult", "Source", "candidate_budget",
    "candidate_cost", "dedup", "dispatch", "execute", "filter_stage",
    "filters", "gather", "make_refine_ctx", "score",
    "topk", "topk_by_score",
]

"""The query-execution layer (port of ``repro/core/exec``; DESIGN.md
§9): :mod:`.stages` (the engine, over one source or the mutable index's
(base, delta) pair), :mod:`.filters` (namespace bitmaps),
:mod:`.fusion` (the hybrid dense∥sparse spec and its per-document
aggregation, DESIGN.md §13) and :mod:`.cost` (the latency proxy);
:func:`trace_count` counts the search programs the serving runtime
builds; :mod:`.frontier` holds the width tuner's grid, records and
rung rule (DESIGN.md §14).  :class:`ShardEnv` runs the engine on one
position of a sharded mesh (DESIGN.md §6)."""
from repro_torch.core.exec import filters
from repro_torch.core.exec import frontier
from repro_torch.core.exec.cost import candidate_budget, candidate_cost
from repro_torch.core.exec.frontier import TunedWidths
from repro_torch.core.exec.fusion import FusionSpec
from repro_torch.core.exec.stages import (Frontier, SearchResult, ShardEnv,
                                          Source, dedup, dispatch, execute,
                                          filter_stage, fuse, gather,
                                          make_refine_ctx, record_trace,
                                          refine_planes, score, sparse_topk,
                                          topk, topk_by_score, trace_count)

__all__ = [
    "Frontier", "FusionSpec", "SearchResult", "ShardEnv", "Source",
    "TunedWidths",
    "candidate_budget", "candidate_cost", "dedup", "dispatch", "execute",
    "filter_stage", "filters", "frontier", "fuse", "gather",
    "make_refine_ctx", "record_trace", "refine_planes", "score",
    "sparse_topk", "topk", "topk_by_score", "trace_count",
]

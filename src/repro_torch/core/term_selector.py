"""Term selector, search side (port of ``repro/core/term_selector.py``:
``TermSelector`` and ``query_terms``; the indexing side comes with the
build slice)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bm25
from repro_torch.core.bm25 import PAD_ID


class TermSelector(NamedTuple):
    """Search-time state: the stored corpus-average term scores s̄."""
    avg_scores: torch.Tensor  # (V,) f32

    def to(self, device) -> "TermSelector":
        return TermSelector(self.avg_scores.to(device))


def query_terms(selector: TermSelector, query_tokens: torch.Tensor,
                k2: int) -> torch.Tensor:
    """Unique query terms ranked by stored s̄ (paper Eq. 8) → (B, k2)
    term ids with PAD_ID fill.

    ``lax.top_k`` breaks ties lowest-index-first and ``torch.topk``
    promises no tie order, so the top-k is a stable descending sort cut
    at k."""
    first = bm25.first_occurrence_mask(query_tokens)
    sbar = selector.avg_scores[query_tokens.clamp(min=0).long()]
    masked = torch.where(first, sbar, torch.full_like(sbar, -torch.inf))
    k_eff = min(k2, query_tokens.shape[-1])
    top_s, top_i = torch.sort(masked, dim=-1, descending=True, stable=True)
    top_s, top_i = top_s[:, :k_eff], top_i[:, :k_eff]
    ids = torch.gather(query_tokens, -1, top_i)
    ids = torch.where(torch.isfinite(top_s), ids,
                      torch.full_like(ids, PAD_ID)).to(torch.int32)
    if k_eff < k2:
        ids = torch.nn.functional.pad(ids, (0, k2 - k_eff), value=PAD_ID)
    return ids

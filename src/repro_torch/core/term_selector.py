"""Term selector, paper §4.2 Eq. 7–8 (port of
``repro/core/term_selector.py``: ``TermSelector``, ``query_terms``,
``doc_terms``, ``fit_unsup``, ``score_vectors``, and the HI²_sup scorer
``TermMLP`` / ``init_mlp`` / ``mlp_token_scores``).

Indexing side: the top-K₁ᵀ salient terms of each document, scored by
BM25 (HI²_unsup) or by the MLP over encoder token states (HI²_sup).
Search side: dispatch the query to ≤ K₂ᵀ of its own terms ranked by the
stored corpus-average term scores s̄ — no model on the query path."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import bm25
from repro_torch.core.bm25 import PAD_ID


class TermMLP(NamedTuple):
    """f(·) in Eq. 7: two-layer MLP with ReLU, R^h → R."""
    w1: torch.Tensor  # (h, h)
    b1: torch.Tensor  # (h,)
    w2: torch.Tensor  # (h, 1)
    b2: torch.Tensor  # (1,)

    def to(self, device) -> "TermMLP":
        return TermMLP(*(t.to(device) for t in self))


def init_mlp(generator: torch.Generator, hidden: int) -> TermMLP:
    """w1, w2 from N(0, 1/hidden) (drawn in that order from
    ``generator``, on its device), zero biases."""
    s = 1.0 / math.sqrt(hidden)

    def normal(shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=generator.device) * s

    w1 = normal((hidden, hidden))
    return TermMLP(w1=w1,
                   b1=torch.zeros((hidden,), device=generator.device),
                   w2=normal((hidden, 1)),
                   b2=torch.zeros((1,), device=generator.device))


def mlp_token_scores(mlp: TermMLP, hidden_states: torch.Tensor,
                     tokens: torch.Tensor) -> torch.Tensor:
    """Per-position saliency from encoder states, (B, L, h) → (B, L):
    softplus of the MLP (positive, on BM25's scale); PAD positions score
    0."""
    x = torch.relu(hidden_states @ mlp.w1 + mlp.b1)
    s = torch.nn.functional.softplus((x @ mlp.w2 + mlp.b2)[..., 0])
    return s * (tokens != PAD_ID)


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


def doc_terms(tokens: torch.Tensor, position_scores: torch.Tensor, k1: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Indexing side: top-K₁ᵀ unique terms per document (+ scores)."""
    return bm25.top_terms(tokens, position_scores, k1)


def score_vectors(tokens: torch.Tensor, position_scores: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """s_D / s_Q over the vocabulary (Eq. 12), max-pooled over repeats."""
    return bm25.score_vector(tokens, position_scores, vocab_size)


def fit_unsup(tokens: torch.Tensor, vocab_size: int, alpha: float = 0.82,
              beta: float = 0.68
              ) -> tuple[TermSelector, torch.Tensor, bm25.BM25Stats]:
    """HI²_unsup: BM25 stats + s̄ from the corpus → (selector,
    per-position corpus scores (n, L), stats)."""
    stats = bm25.fit(tokens, vocab_size)
    pos_scores = bm25.score_positions(tokens, stats, alpha=alpha, beta=beta)
    sbar = bm25.average_term_scores(tokens, pos_scores, vocab_size)
    return TermSelector(avg_scores=sbar), pos_scores, stats

"""BM25 term scoring, paper Eq. 7 (port of ``repro/core/bm25.py``:
``PAD_ID``, ``BM25Stats``, ``first_occurrence_mask``,
``term_frequency``, ``fit``, ``score_positions``, ``top_terms``,
``average_term_scores`` and ``score_vector``).

    s_v = (α+1) · IDF(v) · TF(v,D) / (TF(v,D) + α · (1 − β + β·|D|/avgdl))

with α=0.82, β=0.68.  Documents are (n, L) token-id matrices padded with
``PAD_ID``.  The reference finds repeats through an (n, L, L) equality
plane; at a million 64-token documents that plane is 4 GB of bools, so
the port finds them per row with a stable sort instead — the same
first-occurrence mask and term counts, in (n, L) memory, over chunks of
documents.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import kmeans

PAD_ID = -1

#: documents per chunk of the per-row sorts (bounds the transient memory)
CHUNK = 1 << 18


class BM25Stats(NamedTuple):
    idf: torch.Tensor      # (V,) f32
    avgdl: torch.Tensor    # () f32
    n_docs: int


def _runs(tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, L) → ((n, L) bool first occurrence of each term in its row,
    (n, L) i64 count of that term in its row), PAD included.  A stable
    sort keeps the earliest position first within each run."""
    s, order = torch.sort(tokens, dim=-1, stable=True)
    new = torch.ones_like(s, dtype=torch.bool)
    new[:, 1:] = s[:, 1:] != s[:, :-1]
    run = new.long().cumsum(-1) - 1                        # run id per slot
    length = torch.zeros_like(run).scatter_add_(1, run, torch.ones_like(run))
    first = torch.empty_like(new).scatter_(1, order, new)
    count = torch.empty_like(run).scatter_(1, order, length.gather(1, run))
    return first, count


def _chunked(fn, tokens: torch.Tensor) -> torch.Tensor:
    return torch.cat([fn(t) for t in tokens.split(CHUNK)])


def first_occurrence_mask(tokens: torch.Tensor) -> torch.Tensor:
    """(n, L) → (n, L) bool: True at the first position of each unique
    non-PAD term."""
    return _chunked(lambda t: _runs(t)[0] & (t != PAD_ID), tokens)


def term_frequency(tokens: torch.Tensor) -> torch.Tensor:
    """(n, L) → (n, L) f32: TF of the term at each position within its
    document, 0 at PAD."""
    return _chunked(lambda t: _runs(t)[1].float() * (t != PAD_ID), tokens)


def fit(tokens: torch.Tensor, vocab_size: int) -> BM25Stats:
    """Corpus statistics: IDF per vocab term + average doc length."""
    valid = tokens != PAD_ID
    doc_len = valid.sum(dim=-1, dtype=torch.float32)              # (n,)
    first = first_occurrence_mask(tokens)
    # repeats and PAD count in a sentinel bin past the vocabulary
    flat = torch.where(first, tokens, vocab_size).reshape(-1).long()
    df = torch.bincount(flat, minlength=vocab_size + 1)[:vocab_size].float()
    n = tokens.shape[0]
    # BM25+-style IDF, floored at 0 to avoid negative saliency
    idf = torch.clamp(torch.log((n - df + 0.5) / (df + 0.5) + 1.0), min=0.0)
    return BM25Stats(idf=idf, avgdl=doc_len.mean(), n_docs=n)


def score_positions(tokens: torch.Tensor, stats: BM25Stats,
                    alpha: float = 0.82, beta: float = 0.68) -> torch.Tensor:
    """Eq. 7 BM25 branch at every token position → (n, L) f32, 0 at
    PAD; repeated terms get their term's (identical) score."""
    valid = tokens != PAD_ID
    tf = term_frequency(tokens)
    doc_len = valid.sum(dim=-1, keepdim=True, dtype=torch.float32)
    idf = stats.idf[tokens.clamp(min=0)]
    denom = tf + alpha * (1.0 - beta + beta * doc_len / stats.avgdl)
    s = (alpha + 1.0) * idf * tf / torch.clamp(denom, min=1e-6)
    return s * valid


def top_terms(tokens: torch.Tensor, scores: torch.Tensor, k: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k unique terms per doc by score → ((n, k) i32 term ids with
    PAD_ID fill, (n, k) f32 scores), in ``lax.top_k`` order: a stable
    descending sort, lowest position first on ties."""
    uniq = first_occurrence_mask(tokens)
    masked = torch.where(uniq, scores, torch.full_like(scores, -torch.inf))
    top_s, top_i = torch.sort(masked, dim=-1, descending=True, stable=True)
    top_s, top_i = top_s[:, :k], top_i[:, :k]
    term_ids = torch.gather(tokens, -1, top_i)
    ok = torch.isfinite(top_s)
    return (torch.where(ok, term_ids, PAD_ID).to(torch.int32),
            torch.where(ok, top_s, 0.0))


def average_term_scores(tokens: torch.Tensor, scores: torch.Tensor,
                        vocab_size: int) -> torch.Tensor:
    """s̄_v (Eq. 8): mean score of term v across the documents that
    contain it → (V,) f32."""
    first = first_occurrence_mask(tokens)
    # each term's first occurrences, summed in document order on every
    # device (no atomics on the card)
    sums, counts = kmeans.segment_sum(scores[first].float(), tokens[first],
                                      vocab_size)
    return sums / torch.clamp(counts.float(), min=1.0)


def score_vector(tokens: torch.Tensor, scores: torch.Tensor,
                 vocab_size: int) -> torch.Tensor:
    """Dense (n, V) score vectors s_D (Eq. 12) from per-position scores:
    repeated terms collapse by max (Eq. 7's max over d_i = v), terms a
    row does not hold (and PAD) are 0.

    The reference's ``segment_max``: a max from −inf per (row, term),
    PAD positions sent to a dropped segment.  ``scatter_reduce("amax",
    include_self=False)`` gives the same values and the same gradient —
    split evenly among tied maxima, 0 at PAD and at terms a row lacks —
    and a max is the same whatever order the card's atomics take."""
    n, length = tokens.shape
    valid = tokens != PAD_ID
    row = torch.arange(n, device=tokens.device)[:, None].expand(n, length)
    seg = torch.where(valid, row * vocab_size + tokens.clamp(min=0).long(),
                      n * vocab_size)
    src = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    out = torch.full((n * vocab_size + 1,), -torch.inf, dtype=scores.dtype,
                     device=scores.device).scatter_reduce(
        0, seg.reshape(-1), src.reshape(-1), "amax", include_self=False)
    out = out[:n * vocab_size].reshape(n, vocab_size)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))

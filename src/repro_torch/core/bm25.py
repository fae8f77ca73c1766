"""BM25 helpers the query path needs (port of ``repro/core/bm25.py``:
``PAD_ID`` and ``first_occurrence_mask``; the index-build statistics
come with the build slice)."""
from __future__ import annotations

import torch

PAD_ID = -1


def first_occurrence_mask(tokens: torch.Tensor) -> torch.Tensor:
    """(n, L) → (n, L) bool: True at the first position of each unique
    non-PAD term."""
    eq = tokens[:, :, None] == tokens[:, None, :]                # (n, L, L)
    before = torch.ones(eq.shape[-2:], dtype=torch.bool,
                        device=tokens.device).tril(diagonal=-1)  # j < i
    seen_before = (eq & before).any(dim=-1)
    return (tokens != PAD_ID) & ~seen_before

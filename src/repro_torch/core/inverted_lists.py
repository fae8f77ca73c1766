"""Fixed-capacity padded inverted lists (port of
``repro/core/inverted_lists.py``).

    entries: (n_lists, capacity) int32 doc ids, PAD_DOC (-1) beyond length
    lengths: (n_lists,)          int32

Construction is host-side numpy (a copy of the reference's ``_bucket``,
so the planes are byte-identical); the search-time gather and dedup run
as torch ops on whatever device the planes live on.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import device as dev_mod

PAD_DOC = -1


class PaddedLists(NamedTuple):
    entries: torch.Tensor   # (n_lists, capacity) i32, PAD_DOC padded
    lengths: torch.Tensor   # (n_lists,) i32

    @property
    def n_lists(self) -> int:
        return self.entries.shape[0]

    @property
    def capacity(self) -> int:
        return self.entries.shape[1]

    def to(self, device) -> "PaddedLists":
        return PaddedLists(self.entries.to(device), self.lengths.to(device))


def _bucket(doc_ids: np.ndarray, list_ids: np.ndarray,
            scores: Optional[np.ndarray], n_lists: int,
            capacity: Optional[int]
            ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bucket (doc, list[, score]) triples into (entries, lengths,
    weights) numpy planes: each list sorted by descending score (FIFO
    when ``scores`` is None) and cut at ``capacity``; negative list ids
    are dropped."""
    doc_ids = np.asarray(doc_ids).reshape(-1)
    list_ids = np.asarray(list_ids).reshape(-1)
    keep = list_ids >= 0
    doc_ids, list_ids = doc_ids[keep], list_ids[keep]
    if scores is None:
        scores = -np.arange(len(doc_ids), dtype=np.float64)  # FIFO
    else:
        scores = np.asarray(scores, np.float64).reshape(-1)[keep]

    order = np.lexsort((-scores, list_ids))
    doc_ids, list_ids, scores = doc_ids[order], list_ids[order], scores[order]
    counts = np.bincount(list_ids, minlength=n_lists)
    if capacity is None:
        capacity = max(int(counts.max(initial=1)), 1)

    starts = np.zeros(n_lists + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    rank_in_list = np.arange(len(doc_ids)) - starts[list_ids]
    keep2 = rank_in_list < capacity

    entries = np.full((n_lists, capacity), PAD_DOC, np.int32)
    entries[list_ids[keep2], rank_in_list[keep2]] = doc_ids[keep2]
    weights = np.zeros((n_lists, capacity), np.float32)
    weights[list_ids[keep2], rank_in_list[keep2]] = scores[keep2]
    lengths = np.minimum(counts, capacity).astype(np.int32)
    return entries, lengths, weights


def build(doc_ids: np.ndarray, list_ids: np.ndarray,
          scores: Optional[np.ndarray], n_lists: int,
          capacity: Optional[int] = None, *,
          device: dev_mod.DeviceLike = "cuda") -> PaddedLists:
    """Bucket assignment triples into padded lists on ``device``; the
    overflow of a list drops its lowest-scoring documents."""
    dev = dev_mod.resolve(device)
    entries, lengths, _ = _bucket(doc_ids, list_ids, scores, n_lists,
                                  capacity)
    return PaddedLists(entries=torch.from_numpy(entries).to(dev),
                       lengths=torch.from_numpy(lengths).to(dev))


def build_scored(doc_ids: np.ndarray, list_ids: np.ndarray,
                 scores: np.ndarray, n_lists: int,
                 capacity: Optional[int] = None, *,
                 device: dev_mod.DeviceLike = "cuda"
                 ) -> tuple[PaddedLists, torch.Tensor]:
    """:func:`build` plus the aligned impact plane of sparse search
    (DESIGN.md §13): ``weights[v, j]`` is the score of posting
    ``entries[v, j]``, 0.0 at pads.  ``scores`` is required: the FIFO
    fallback's insertion-order scores are no impacts."""
    if scores is None:
        raise ValueError(
            "build_scored needs real per-posting scores; the FIFO "
            "fallback of build() has no meaningful impacts")
    dev = dev_mod.resolve(device)
    entries, lengths, weights = _bucket(doc_ids, list_ids, scores, n_lists,
                                        capacity)
    return (PaddedLists(entries=torch.from_numpy(entries).to(dev),
                        lengths=torch.from_numpy(lengths).to(dev)),
            torch.from_numpy(weights).to(dev))


def gather_candidates(lists: PaddedLists,
                      dispatched: torch.Tensor) -> torch.Tensor:
    """(B, K) dispatched list ids (PAD=-1 allowed) → (B, K·capacity)
    candidate doc ids, PAD_DOC where invalid."""
    rows = lists.entries[dispatched.clamp(min=0).long()]     # (B, K, cap)
    rows = torch.where((dispatched >= 0)[:, :, None], rows,
                       torch.full_like(rows, PAD_DOC))
    return rows.reshape(dispatched.shape[0], -1)


def dedup_mask(candidates: torch.Tensor) -> torch.Tensor:
    """First-occurrence mask over each row.  The sort must be stable so
    that the first slot of a duplicated id is the one kept, as with
    ``jnp.argsort``."""
    order = torch.argsort(candidates, dim=-1, stable=True)
    sorted_ids = torch.gather(candidates, -1, order)
    is_dup = torch.zeros_like(sorted_ids, dtype=torch.bool)
    is_dup[:, 1:] = sorted_ids[:, 1:] == sorted_ids[:, :-1]
    keep_sorted = ~is_dup & (sorted_ids != PAD_DOC)
    return torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)

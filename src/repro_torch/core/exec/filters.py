"""Per-query namespace filters (port of ``repro/core/exec/filters.py``:
``allowed_mask``, ``make_filter``, ``allow_all``, ``pad_filter``,
``namespace_histogram``; DESIGN.md §9).

A query's predicate is a bitmap over namespace ids, ``W = ceil(n / 32)``
words of 32 bits; doc d passes query b iff bit ``doc_ns[d]`` of row b is
set.  The reference holds the words as uint32.  torch's uint32 has few
ops and its shifts are not dependable, so the port holds each 32-bit
word in an int64 — the bit layout is unchanged — and converts uint32
arrays at the boundary (:func:`as_words`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import device as dev_mod

#: bits per bitmap word
WORD = 32


def n_words(n_namespaces: int) -> int:
    """Bitmap words per query for ``n_namespaces`` namespaces."""
    if n_namespaces < 1:
        raise ValueError(f"n_namespaces must be >= 1, got {n_namespaces}")
    return -(-n_namespaces // WORD)


def as_words(ns_filter, device) -> torch.Tensor:
    """A (B, W) bitmap of 32-bit words (uint32 numpy from the reference,
    or any integer tensor) as an int64 tensor on ``device``."""
    if isinstance(ns_filter, torch.Tensor):
        return ns_filter.to(device=device, dtype=torch.int64)
    arr = np.asarray(ns_filter)
    if arr.dtype.kind not in "iu":
        raise ValueError(f"filter bitmap must hold integers, got {arr.dtype}")
    return torch.from_numpy(arr.astype(np.int64)).to(device)


def make_filter(allowed: Sequence, n_namespaces: int, *,
                device: dev_mod.DeviceLike = "cuda") -> torch.Tensor:
    """(B, W) int64 bitmap: ``allowed`` holds, per query, the namespace
    ids it may see (an int is one namespace).  Out-of-range ids raise."""
    dev = dev_mod.resolve(device)
    return torch.from_numpy(filter_words(allowed, n_namespaces)).to(dev)


def filter_words(allowed: Sequence, n_namespaces: int) -> np.ndarray:
    """:func:`make_filter`'s bitmap as a host (B, W) int64 array."""
    out = np.zeros((len(allowed), n_words(n_namespaces)), np.int64)
    for b, spec in enumerate(allowed):
        ids = [spec] if np.isscalar(spec) else list(spec)
        for ns in ids:
            ns = int(ns)
            if not 0 <= ns < n_namespaces:
                raise ValueError(
                    f"namespace id {ns} out of range [0, {n_namespaces}) "
                    f"in filter row {b}")
            out[b, ns // WORD] |= 1 << (ns % WORD)
    return out


def allow_all(batch: int, n_namespaces: int, *,
              device: dev_mod.DeviceLike = "cuda") -> torch.Tensor:
    """The pass-everything bitmap, :func:`make_filter`'s words for every
    namespace on every row: search with it is bit-identical to search
    with no filter."""
    return make_filter([range(n_namespaces)] * batch, n_namespaces,
                       device=device)


def allowed_mask(ns_filter: torch.Tensor, ns_ids: torch.Tensor
                 ) -> torch.Tensor:
    """(B, W) int64 bitmap × (B, C) namespace ids → (B, C) bool.  Ids
    outside ``[0, W·32)`` match nothing (fail closed)."""
    w = ns_filter.shape[-1]
    ids = ns_ids.long()
    word = torch.div(ids, WORD, rounding_mode="floor").clamp(0, w - 1)
    bit = ids.remainder(WORD)
    words = torch.gather(ns_filter, -1, word)
    hit = ((words >> bit) & 1).bool()
    return hit & (ids >= 0) & (ids < w * WORD)


def pad_filter(ns_filter: Optional[torch.Tensor], batch: int
               ) -> Optional[torch.Tensor]:
    """Zero-pad a bitmap to the serving ``max_batch`` (padded query rows
    match nothing)."""
    if ns_filter is None:
        return None
    pad = batch - ns_filter.shape[0]
    if pad < 0:
        raise ValueError(
            f"filter batch {ns_filter.shape[0]} exceeds max_batch {batch}")
    return torch.nn.functional.pad(ns_filter, (0, 0, 0, pad))


def namespace_histogram(doc_ns, n_namespaces: int) -> np.ndarray:
    """Docs per namespace (a host ``np.bincount``) — selectivity
    accounting for benchmarks."""
    if isinstance(doc_ns, torch.Tensor):
        doc_ns = doc_ns.cpu().numpy()
    return np.bincount(np.asarray(doc_ns).reshape(-1),
                       minlength=n_namespaces)

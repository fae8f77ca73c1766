"""Static index pruning, paper Appendix B (port of
``repro/core/pruning.py``: ``prune_percentile``, ``prune_to_threshold``).

Lists longer than the γ-th percentile length (γ = 0.996) drop their
lowest-scoring references down to it.  Padded lists are stored
score-descending, so pruning truncates the trailing columns.  It runs on
the host, like the reference; the result lives where the input did.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.inverted_lists import PAD_DOC, PaddedLists


def prune_percentile(lists: PaddedLists, gamma: float = 0.996
                     ) -> PaddedLists:
    lengths = lists.lengths.cpu().numpy()
    threshold = int(np.quantile(lengths, gamma, method="lower"))
    return prune_to_threshold(lists, max(threshold, 1))


def prune_to_threshold(lists: PaddedLists, threshold: int) -> PaddedLists:
    entries = lists.entries.cpu().numpy().copy()
    lengths = lists.lengths.cpu().numpy().copy()
    if threshold < entries.shape[1]:
        entries[:, threshold:] = PAD_DOC   # score-descending: tail = lowest
        lengths = np.minimum(lengths, threshold)
        entries = entries[:, :threshold]
    dev = lists.entries.device
    return PaddedLists(entries=torch.from_numpy(entries).to(dev),
                       lengths=torch.from_numpy(lengths).to(dev))

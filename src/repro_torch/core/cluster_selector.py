"""Cluster selector, search side (port of
``repro/core/cluster_selector.py``: ``ClusterSelector``, ``scores``,
``select_for_query``).

Dispatch goes through :func:`repro_torch.kernels.assign_topk.ops.topk_scores`
for every device: on a CUDA tensor that is the hand-written running
top-k kernel (the (B, L) score plane never reaches device memory), on a
CPU tensor its plain version.  There is no ``use_kernel`` switch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.assign_topk import ops as at_ops


class ClusterSelector(NamedTuple):
    embeddings: torch.Tensor   # (L, h) f32

    @property
    def n_clusters(self) -> int:
        return self.embeddings.shape[0]

    def to(self, device) -> "ClusterSelector":
        return ClusterSelector(self.embeddings.to(device))


def scores(selector: ClusterSelector, x: torch.Tensor) -> torch.Tensor:
    """⟨e_x, e_C⟩ for a batch: (B, h) → (B, L)."""
    return x.float() @ selector.embeddings.T


def select_for_query(selector: ClusterSelector,
                     query_embeddings: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-K^C clusters per query (paper Eq. 6) → ((B, k) i32 ids,
    (B, k) f32 scores), ``lax.top_k`` order: score desc, lowest index
    first on ties."""
    top_s, top_i = at_ops.topk_scores(
        query_embeddings.float().contiguous(), selector.embeddings, k)
    return top_i, top_s

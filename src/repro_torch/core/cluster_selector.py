"""Cluster selector, paper §4.1 (port of
``repro/core/cluster_selector.py``: ``ClusterSelector``,
``init_kmeans``, ``scores``, ``select_for_doc``, ``select_for_query``).

Documents are indexed to their argmax cluster (one list per doc);
queries are dispatched to the top-K^C clusters (Eq. 6).  Dispatch goes
through :func:`repro_torch.kernels.assign_topk.ops.topk_scores` for
every device: on a CUDA tensor that is the hand-written running
top-k kernel (the (B, L) score plane never reaches device memory), on a
CPU tensor its plain version.  There is no ``use_kernel`` switch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import kmeans
from repro_torch.kernels.assign_topk import ops as at_ops

#: documents per block of the indexing-side argmax (bounds the (n, L)
#: score plane to BLOCK rows)
BLOCK = 16_384


class ClusterSelector(NamedTuple):
    embeddings: torch.Tensor   # (L, h) f32

    @property
    def n_clusters(self) -> int:
        return self.embeddings.shape[0]

    def to(self, device) -> "ClusterSelector":
        return ClusterSelector(self.embeddings.to(device))


def init_kmeans(generator: torch.Generator, doc_embeddings: torch.Tensor,
                n_clusters: int, n_iters: int = 20
                ) -> tuple[ClusterSelector, torch.Tensor]:
    """KMeans init → (selector, φ(D) assignments).  φ(D) is the
    INNER-PRODUCT argmax over the centroids (paper §4.1), not the L2
    assignment KMeans itself used."""
    centroids, _ = kmeans.kmeans_fit(generator, doc_embeddings,
                                     n_clusters=n_clusters, n_iters=n_iters)
    selector = ClusterSelector(embeddings=centroids)
    return selector, select_for_doc(selector, doc_embeddings)


def scores(selector: ClusterSelector, x: torch.Tensor) -> torch.Tensor:
    """⟨e_x, e_C⟩ for a batch: (B, h) → (B, L)."""
    return x.float() @ selector.embeddings.T


def select_for_doc(selector: ClusterSelector, doc_embeddings: torch.Tensor
                   ) -> torch.Tensor:
    """Indexing side: each document goes to exactly one cluster, the
    argmax of :func:`scores` (lowest index on ties) → (n,) i32."""
    return torch.cat([torch.argmax(scores(selector, x), dim=-1)
                      for x in doc_embeddings.split(BLOCK)]).to(torch.int32)


def select_for_query(selector: ClusterSelector,
                     query_embeddings: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-K^C clusters per query (paper Eq. 6) → ((B, k) i32 ids,
    (B, k) f32 scores), ``lax.top_k`` order: score desc, lowest index
    first on ties."""
    top_s, top_i = at_ops.topk_scores(
        query_embeddings.float().contiguous(), selector.embeddings, k)
    return top_i, top_s

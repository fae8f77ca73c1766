"""Retrieval quality metrics (port of ``repro/core/metrics.py``):
Recall@K and MRR@K.  qrels are (B,) positive doc ids or a (B, P)
matrix padded with -1."""
from __future__ import annotations

import torch


def _hits(retrieved, qrels, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    retrieved = torch.as_tensor(retrieved)[:, :k]
    qrels = torch.as_tensor(qrels, device=retrieved.device)
    if qrels.dim() == 1:
        qrels = qrels[:, None]
    hit = ((retrieved[:, :, None] == qrels[:, None, :])
           & (qrels[:, None, :] >= 0))                          # (B, k, P)
    return hit, qrels


def recall_at_k(retrieved, qrels, k: int) -> float:
    """retrieved: (B, R) ranked doc ids; fraction of positives found."""
    hit, qrels = _hits(retrieved, qrels, k)
    per_q = (hit.any(dim=1).sum(dim=-1)
             / (qrels >= 0).sum(dim=-1).clamp(min=1))
    return float(per_q.float().mean())


def mrr_at_k(retrieved, qrels, k: int) -> float:
    """Mean reciprocal rank of the first relevant doc within the top k."""
    hit, _ = _hits(retrieved, qrels, k)
    hit_any = hit.any(dim=-1)                                   # (B, k)
    ranks = hit_any.int().argmax(dim=-1)                        # first hit
    rr = torch.where(hit_any.any(dim=-1), 1.0 / (ranks + 1.0),
                     torch.zeros((), device=hit_any.device))
    return float(rr.float().mean())

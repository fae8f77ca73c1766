"""Plain PyTorch versions of the dispatch top-k and KMeans assignment
kernels (port of ``repro/kernels/assign_topk/ref.py``: ``topk_scores``
and ``assign_argmax``).  The wrappers take them for CPU tensors; on the
card only the smoke check calls them."""
from __future__ import annotations

import torch

from repro_torch import rowwise


def topk_scores(x: torch.Tensor, emb: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k plain inner products per row of ``x`` against ``emb``:
    ((N, k) f32 scores, (N, k) i32 ids) in ``lax.top_k`` order, score
    descending and lowest index first on ties.  ``torch.topk`` promises
    no tie order, so this is a stable descending sort cut at k.  The
    product runs at a fixed row count, so a row's scores do not depend
    on N (:func:`repro_torch.rowwise.fixed_rows`), as the kernel's do."""
    e = emb.float()
    s = rowwise.fixed_rows(lambda r: r @ e.T, x.float())
    vals, idx = torch.sort(s, dim=-1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32)


def assign_argmax(x: torch.Tensor, centroids: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per point, the max and argmax over centroids of ⟨x, c⟩ − ½‖c‖²
    (the L2 argmin), lowest index first on ties: x (N, h), centroids
    (L, h) → ((N,) f32, (N,) i32), or batched (m, N, h) × (m, L, h) →
    ((m, N), (m, N))."""
    c = centroids.float()
    s = (x.float() @ c.transpose(-1, -2)
         - 0.5 * torch.sum(c * c, dim=-1)[..., None, :])
    idx = torch.argmax(s, dim=-1)              # first maximal index
    return (torch.gather(s, -1, idx[..., None])[..., 0],
            idx.to(torch.int32))

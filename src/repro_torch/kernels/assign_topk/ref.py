"""Plain PyTorch version of the dispatch top-k kernel (port of
``repro/kernels/assign_topk/ref.py::topk_scores``).  The wrapper takes
it for CPU tensors; on the card only the smoke check calls it."""
from __future__ import annotations

import torch


def topk_scores(x: torch.Tensor, emb: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k plain inner products per row of ``x`` against ``emb``:
    ((N, k) f32 scores, (N, k) i32 ids) in ``lax.top_k`` order, score
    descending and lowest index first on ties.  ``torch.topk`` promises
    no tie order, so this is a stable descending sort cut at k."""
    s = x.float() @ emb.float().T
    vals, idx = torch.sort(s, dim=-1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32)

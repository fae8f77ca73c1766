"""Flat codec (port of ``repro/core/codecs/flat.py``: ``search`` and
``FlatCodec``).  Full-precision embeddings and the exact inner product —
the quality upper bound of every other codec and the bitwise-parity
codec of the port's tests.  No kernel: the gathered fp32 rows are the
score input itself, as in the reference.

:func:`search` is the brute-force top-k over a whole corpus — the exact
oracle recall is measured against — blocked so the (B, n_docs) score
plane never exists.  The scorer gathers candidate rows a few queries at
a time: at the ``serve_msmarco`` widths one 256-query batch would
gather 50 GB of fp32 rows at once.
"""
from __future__ import annotations

import torch

from repro_torch.core.codecs import base

#: bytes of gathered candidate rows the scorer holds at once
GATHER_BYTES = 1 << 31


def search(query_embeddings: torch.Tensor, doc_embeddings: torch.Tensor,
           k: int, block: int = 65536) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by inner product → (scores (B, k) f32, ids (B, k)
    i32), in ``lax.top_k`` order (score desc, lowest id first on ties):
    each block's scores are merged into the running list by a stable
    sort, the list (holding lower ids) first."""
    q = query_embeddings.float()
    b = q.shape[0]
    best_s = torch.full((b, k), -torch.inf, device=q.device)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=q.device)
    for start in range(0, doc_embeddings.shape[0], block):
        blk = doc_embeddings[start:start + block].float()
        ids = torch.arange(start, start + blk.shape[0], device=q.device)
        cat_s = torch.cat([best_s, q @ blk.T], dim=-1)
        cat_i = torch.cat([best_i, ids.expand(b, -1)], dim=-1)
        top_s, pos = torch.sort(cat_s, dim=-1, descending=True, stable=True)
        best_s, best_i = top_s[:, :k], torch.gather(cat_i, -1, pos[:, :k])
    return best_s, best_i.to(torch.int32)


class FlatCodec(base.Codec):
    name = "flat"

    def encode(self, params, embeddings: torch.Tensor) -> dict:
        return {"emb": embeddings.float()}

    def decode(self, params, doc_planes: dict) -> torch.Tensor:
        return doc_planes["emb"]

    def make_scorer(self, params, doc_planes: dict, queries: torch.Tensor):
        q = queries.float()
        emb = doc_planes["emb"]

        def score(ids: torch.Tensor, live: torch.Tensor = None
                  ) -> torch.Tensor:
            # the gathered (b, C, h) rows, a few queries at a time
            step = max(1, GATHER_BYTES // max(
                1, ids.shape[1] * emb.shape[1] * emb.element_size()))
            s = torch.cat([
                torch.einsum("bh,bch->bc", qb, base.gather_rows(emb, ib))
                for qb, ib in zip(q.split(step), ids.split(step))])
            return s if live is None else torch.where(
                live, s, torch.full_like(s, -torch.inf))

        return score

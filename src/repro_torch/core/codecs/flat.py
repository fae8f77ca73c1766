"""Flat codec, search side (port of ``repro/core/codecs/flat.py``:
the scorer).  Full-precision embeddings and the exact inner product —
the bitwise-parity codec of the port's tests.  No kernel: the gathered
fp32 rows are the score input itself, as in the reference."""
from __future__ import annotations

import torch

from repro_torch.core.codecs import base


class FlatCodec(base.Codec):
    name = "flat"

    def make_scorer(self, params, doc_planes: dict, queries: torch.Tensor):
        q = queries.float()
        emb = doc_planes["emb"]

        def score(ids: torch.Tensor, live: torch.Tensor = None
                  ) -> torch.Tensor:
            rows = base.gather_rows(emb, ids)                 # (B, C, h)
            s = torch.einsum("bh,bch->bc", q, rows)
            return s if live is None else torch.where(
                live, s, torch.full_like(s, -torch.inf))

        return score

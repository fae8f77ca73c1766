"""Two-stage refine codec (port of ``repro/core/codecs/refine.py``:
``RefineCodec``) — wrap any base codec with an exact re-rank of the
top-R′ frontier against fp16 embeddings.

Stage 1 scores every candidate with the base codec and selects the
total-order top-R′, R′ = mult·R.  Stage 2 gathers the fp16 rows of just
those R′ docs, rescores them with an exact fp32 inner product, and takes
the final total-order top-R.  The R′-row gather and product are plain
torch, as the reference computes them outside any kernel.

Spec grammar: ``refine[:base[:mult]]`` — e.g. ``refine`` (over pq,
R′=4R), ``refine:opq``, ``refine:sq8:4``.
"""
from __future__ import annotations

import torch

from repro_torch.core.codecs import base

DEFAULT_BASE = "pq"
DEFAULT_MULT = 4


class RefineCodec(base.Codec):
    def __init__(self, base_codec: base.Codec, mult: int = DEFAULT_MULT):
        if mult < 1:
            raise ValueError(f"refine mult must be >= 1, got {mult}")
        self.base = base_codec
        self.mult = int(mult)
        self.name = f"refine:{base_codec.name}:{self.mult}"

    # --- build-time: base planes + the fp16 refine plane -----------------
    def train(self, generator, embeddings, *, pq_m=8, pq_k=256):
        return self.base.train(generator, embeddings, pq_m=pq_m, pq_k=pq_k)

    def encode(self, params, embeddings: torch.Tensor) -> dict:
        planes = dict(self.base.encode(params, embeddings))
        planes["refine_emb"] = embeddings.to(torch.float16)
        return planes

    def decode(self, params, doc_planes: dict) -> torch.Tensor:
        # stage-2 representation: what the final ranking is computed on
        return doc_planes["refine_emb"].float()

    # --- search-time -----------------------------------------------------
    def make_scorer(self, params, doc_planes: dict, queries: torch.Tensor):
        # stage 1 is the base codec; the refine plane is never gathered
        # at candidate width
        return self.base.make_scorer(params, doc_planes, queries)

    def refine_width(self, top_r: int) -> int:
        return self.mult * top_r

    def refine(self, params, doc_planes: dict, queries: torch.Tensor,
               scores: torch.Tensor, ids: torch.Tensor, top_r: int,
               ctx: base.RefineCtx) -> tuple[torch.Tensor, torch.Tensor]:
        from repro_torch.core.exec import stages
        emb = ctx.gather(doc_planes["refine_emb"], ids)      # (B, R′, h)
        exact = torch.einsum("bh,brh->br", queries.float(), emb.float())
        exact = ctx.psum(torch.where(ctx.owned(ids), exact, 0.0))
        # slots beyond the valid frontier stay -inf and sort last
        exact = torch.where(torch.isfinite(scores), exact, -torch.inf)
        return stages.topk_by_score(exact, ids, top_r)

    # --- accounting ------------------------------------------------------
    def candidate_cost(self, budget: int, top_r: int) -> int:
        # each refined doc ≈ one exact (flat) candidate of gather+dot work
        return budget + self.refine_width(top_r)

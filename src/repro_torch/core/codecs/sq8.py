"""8-bit scalar quantization codec (port of ``repro/core/codecs/sq8.py``:
``SQ8Codec``) — Faiss's ``SQ8``: a per-dimension min/max affine map onto
one byte,

    code_d = round((x_d − lo_d) / scale_d),   scale_d = (hi_d − lo_d)/255

so a document costs h bytes, and scoring stays a dequantized dot:

    ⟨q, x̂⟩ = ⟨q·scale, code⟩ + ⟨q, lo⟩

The first term is the fused kernel
:func:`repro_torch.kernels.sq8_dot.ops.sq8_dot_fused` (gather + dot +
live mask, no (B, C, h) rows); the per-query bias is added after its
mask (``-inf`` + bias stays ``-inf``).  Training and encoding run over
blocks of documents, so no fp32 copy of a large fp16 corpus exists.
"""
from __future__ import annotations

import torch

from repro_torch.core.codecs import base
from repro_torch.kernels.sq8_dot import ops as sq8_ops

#: documents per block of train/encode
BLOCK = 1 << 18


def _blocks(x: torch.Tensor):
    return (block.float() for block in x.split(BLOCK))


class SQ8Codec(base.Codec):
    name = "sq8"

    def train(self, generator, embeddings: torch.Tensor, *, pq_m: int = 8,
              pq_k: int = 256) -> dict:
        mins, maxs = zip(*((x.amin(dim=0), x.amax(dim=0))
                           for x in _blocks(embeddings)))
        lo = torch.stack(mins).amin(dim=0)
        span = torch.stack(maxs).amax(dim=0) - lo
        # constant dims quantize to code 0 and decode to lo exactly; the
        # divisor is a tensor because CUDA divides by a scalar as a
        # multiply by its reciprocal, which can move the last bit
        scale = torch.where(span > 0, span / torch.full_like(span, 255.0),
                            1.0)
        return {"lo": lo, "scale": scale}

    def encode(self, params: dict, embeddings: torch.Tensor) -> dict:
        return {"codes": torch.cat([
            torch.clamp(torch.round((x - params["lo"]) / params["scale"]),
                        0, 255).to(torch.uint8)
            for x in _blocks(embeddings)])}

    def decode(self, params: dict, doc_planes: dict) -> torch.Tensor:
        return doc_planes["codes"].float() * params["scale"] + params["lo"]

    def make_scorer(self, params: dict, doc_planes: dict,
                    queries: torch.Tensor):
        q = queries.float()
        q_scaled = (q * params["scale"]).contiguous()           # (B, h)
        bias = q @ params["lo"]                                  # (B,)
        codes_plane = doc_planes["codes"]

        def score(ids: torch.Tensor, live: torch.Tensor = None
                  ) -> torch.Tensor:
            if live is None:
                live = torch.ones(ids.shape, dtype=torch.bool,
                                  device=ids.device)
            return sq8_ops.sq8_dot_fused(
                q_scaled, codes_plane, ids.to(torch.int32).contiguous(),
                live.contiguous()) + bias[:, None]

        return score

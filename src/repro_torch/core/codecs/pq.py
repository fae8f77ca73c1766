"""PQ and OPQ, search side (port of ``repro/core/codecs/pq.py``:
``PQCodebook``, ``OPQCodebook``, ``adc_lut``, ``opq_adc_lut``,
``adc_score``, ``_adc_scorer`` and the scorers of ``PQCodec`` /
``OPQCodec``; training and encoding come with the build slice).

ADC (paper Eq. 4): a query builds one (m, k) inner-product LUT, and a
candidate's score is the sum of the m LUT entries its codes select.  The
score stage is the fused kernel
:func:`repro_torch.kernels.pq_adc.ops.pq_adc_fused`, which gathers the
code rows itself and applies the live mask.  OPQ rotates the query into
codebook space first (``<xR, c> = <x, cRᵀ>``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.codecs import base
from repro_torch.kernels.pq_adc import ops as adc_ops
from repro_torch.kernels.pq_adc import ref as adc_ref


class PQCodebook(NamedTuple):
    """codewords: (m, k, dsub) f32 — ``m`` independent sub-codebooks."""
    codewords: torch.Tensor

    @property
    def m(self) -> int:
        return self.codewords.shape[0]

    @property
    def k(self) -> int:
        return self.codewords.shape[1]

    @property
    def dsub(self) -> int:
        return self.codewords.shape[2]

    def to(self, device) -> "PQCodebook":
        return PQCodebook(self.codewords.to(device))


class OPQCodebook(NamedTuple):
    rotation: torch.Tensor        # (h, h) orthogonal
    codebook: PQCodebook

    @property
    def m(self) -> int:
        return self.codebook.m

    def to(self, device) -> "OPQCodebook":
        return OPQCodebook(self.rotation.to(device),
                           self.codebook.to(device))


def adc_lut(codebook: PQCodebook, queries: torch.Tensor) -> torch.Tensor:
    """(B, h) → (B, m, k): lut[b, j, i] = <e_Q^j, v_{j,i}>."""
    b, h = queries.shape
    qf = queries.float().reshape(b, codebook.m, h // codebook.m)
    return torch.einsum("bmd,mkd->bmk", qf, codebook.codewords.float())


def opq_adc_lut(opq: OPQCodebook, queries: torch.Tensor) -> torch.Tensor:
    """Rotate the query into codebook space; the LUT is then plain PQ."""
    return adc_lut(opq.codebook, queries.float() @ opq.rotation)


#: plain ADC over gathered (B, C, m) codes — the kernel's yardstick
adc_score = adc_ref.pq_adc


def _adc_scorer(lut: torch.Tensor, codes_plane: torch.Tensor):
    def score(ids: torch.Tensor, live: torch.Tensor = None) -> torch.Tensor:
        if live is None:
            live = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
        # the fused kernel gathers rows of the (N, m) plane itself and
        # masks in-kernel: no (B, C, m) codes tensor on the card
        return adc_ops.pq_adc_fused(lut.contiguous(), codes_plane,
                                    ids.to(torch.int32).contiguous(),
                                    live.contiguous())

    return score


class PQCodec(base.Codec):
    name = "pq"

    def make_scorer(self, params: PQCodebook, doc_planes: dict,
                    queries: torch.Tensor):
        return _adc_scorer(adc_lut(params, queries), doc_planes["codes"])


class OPQCodec(PQCodec):
    name = "opq"

    def make_scorer(self, params: OPQCodebook, doc_planes: dict,
                    queries: torch.Tensor):
        return _adc_scorer(opq_adc_lut(params, queries), doc_planes["codes"])

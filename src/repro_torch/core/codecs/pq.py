"""PQ and OPQ — the quantization math of paper §3.2 (Eq. 3–4) and its
codecs (port of ``repro/core/codecs/pq.py``: ``PQCodebook``,
``OPQCodebook``, ``split_fragments``, ``train_pq``, ``pq_encode``,
``pq_decode``, ``reconstruction_mse``, ``train_opq``, ``opq_encode``,
``opq_reconstruction_mse``, ``adc_lut``, ``opq_adc_lut``, ``adc_score``,
``_adc_scorer``, ``PQCodec`` and ``OPQCodec``).

PQ splits an h-dim embedding into m fragments and quantizes each to one
of k codewords: m uint8 codes per document for k ≤ 256.  Training fits
the m sub-codebooks as one batched KMeans (the reference's ``vmap``);
encoding runs over blocks of documents, since the (n, m, k) distance
plane of a million documents at m=96, k=256 would be 98 GB.  OPQ
alternates PQ training on rotated data with a Procrustes solve for the
rotation; SVD signs differ between libraries, so its rotation matches
the reference only up to what the reconstruction error can see.

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

from repro_torch.core import kmeans
from repro_torch.core.codecs import base
from repro_torch.kernels.pq_adc import ops as adc_ops
from repro_torch.kernels.pq_adc import ref as adc_ref

#: documents per block of :func:`pq_encode` (bounds its (m, n, k) plane)
ENCODE_BLOCK = 8192


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


def split_fragments(x: torch.Tensor, m: int) -> torch.Tensor:
    """(n, h) → (n, m, h/m)."""
    n, h = x.shape
    if h % m:
        raise ValueError(f"dim {h} not divisible by m={m}")
    return x.reshape(n, m, h // m)


def train_pq(generator: torch.Generator, x: torch.Tensor, m: int,
             k: int = 256, n_iters: int = 15) -> PQCodebook:
    """One KMeans per fragment, batched over the m subspaces."""
    frags = split_fragments(x.float(), m).transpose(0, 1)   # (m, n, dsub)
    codewords, _ = kmeans.kmeans_fit(generator, frags.contiguous(),
                                     n_clusters=k, n_iters=n_iters)
    return PQCodebook(codewords=codewords)


def pq_encode(codebook: PQCodebook, x: torch.Tensor) -> torch.Tensor:
    """Quantize embeddings to codes: (n, h) → (n, m) i32, per subspace
    the argmax of ⟨x, c⟩ − ‖c‖²/2 (the L2 argmin, lowest code on
    ties)."""
    frags = split_fragments(x.float(), codebook.m).transpose(0, 1)
    return kmeans.assign_blocked(frags, codebook.codewords,
                                 block=ENCODE_BLOCK).T.contiguous()


def pq_decode(codebook: PQCodebook, codes: torch.Tensor) -> torch.Tensor:
    """Reconstruct embeddings from codes: (n, m) → (n, h)."""
    frag = torch.arange(codebook.m, device=codes.device)
    gathered = codebook.codewords[frag[None, :], codes.long()]  # (n, m, d)
    return gathered.reshape(codes.shape[0], -1)


def reconstruction_mse(codebook: PQCodebook, x: torch.Tensor
                       ) -> torch.Tensor:
    x = x.float()
    err = pq_decode(codebook, pq_encode(codebook, x)) - x
    return torch.mean(torch.sum(err * err, dim=-1))


def train_opq(generator: torch.Generator, x: torch.Tensor, m: int,
              k: int = 256, n_outer: int = 4,
              n_kmeans_iters: int = 10) -> OPQCodebook:
    """The alternating scheme: PQ-train on rotated data (fix R, fit the
    codebooks), then solve Procrustes for R (fix the codebooks:
    R = U Vᵀ from the SVD of XᵀX̂, X̂ = decode(encode(XR)))."""
    x = x.float()
    r = torch.eye(x.shape[-1], dtype=torch.float32, device=x.device)
    for _ in range(n_outer):
        xr = x @ r
        cb = train_pq(generator, xr, m=m, k=k, n_iters=n_kmeans_iters)
        # Procrustes: min_R ‖X R − X̂‖_F  s.t. RᵀR = I
        xhat = pq_decode(cb, pq_encode(cb, xr))
        u, _, vt = torch.linalg.svd(x.T @ xhat, full_matrices=False)
        r = u @ vt
    # the final codebook on the final rotation
    cb = train_pq(generator, x @ r, m=m, k=k, n_iters=n_kmeans_iters)
    return OPQCodebook(rotation=r, codebook=cb)


def opq_encode(opq: OPQCodebook, x: torch.Tensor) -> torch.Tensor:
    return pq_encode(opq.codebook, x.float() @ opq.rotation)


def opq_reconstruction_mse(opq: OPQCodebook, x: torch.Tensor
                           ) -> torch.Tensor:
    return reconstruction_mse(opq.codebook, x.float() @ opq.rotation)


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


def _pack_codes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """uint8 codes when k ≤ 256 (4× less device memory and gather
    traffic than int32), else int32."""
    return codes.to(torch.uint8) if k <= 256 else codes


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

    def train(self, generator: torch.Generator, embeddings: torch.Tensor,
              *, pq_m: int = 8, pq_k: int = 256) -> PQCodebook:
        return train_pq(generator, embeddings, m=pq_m, k=pq_k)

    def encode(self, params: PQCodebook, embeddings: torch.Tensor) -> dict:
        return {"codes": _pack_codes(pq_encode(params, embeddings),
                                     params.k)}

    def decode(self, params: PQCodebook, doc_planes: dict) -> torch.Tensor:
        return pq_decode(params, doc_planes["codes"])

    def make_scorer(self, params: PQCodebook, doc_planes: dict,
                    queries: torch.Tensor):
        return _adc_scorer(adc_lut(params, queries), doc_planes["codes"])


class OPQCodec(PQCodec):
    name = "opq"

    def train(self, generator: torch.Generator, embeddings: torch.Tensor,
              *, pq_m: int = 8, pq_k: int = 256) -> OPQCodebook:
        return train_opq(generator, embeddings, m=pq_m, k=pq_k)

    def encode(self, params: OPQCodebook, embeddings: torch.Tensor
               ) -> dict:
        return {"codes": _pack_codes(opq_encode(params, embeddings),
                                     params.codebook.k)}

    def decode(self, params: OPQCodebook, doc_planes: dict
               ) -> torch.Tensor:
        # decode in rotated space, rotate back (R orthogonal: R⁻¹ = Rᵀ)
        return (pq_decode(params.codebook, doc_planes["codes"])
                @ params.rotation.T)

    def make_scorer(self, params: OPQCodebook, doc_planes: dict,
                    queries: torch.Tensor):
        return _adc_scorer(opq_adc_lut(params, queries), doc_planes["codes"])

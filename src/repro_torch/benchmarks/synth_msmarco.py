"""The synthetic ``serve_msmarco`` planes: index leaves and queries
synthesized on the host from one seed, the ``refine:sq8:4`` planes drawn
on the card, and what one full batch of the main path hands each kernel.

``chip_smoke.py`` serves these planes; ``kernel_variants.py --kernel
sq8_dot_fused`` times ``sq8_dot_fused`` on the same candidate plane from
the same ``--seed``:

    rng = np.random.default_rng(seed)
    leaves = synth_leaves(rng)
    qe, qt = synth_queries(rng, BATCH * SMOKE_BATCHES)
    index = ckpt.index_from_numpy(leaves, "opq", device=dev)
    rindex, _ = refine_index(index, dev, seed, qe)
    inp = main_path_inputs(rindex, qe0, qt0)    # the first batch

The shape is ``src/repro/configs/hi2_synth.py::HI2ServeShape`` at full
width (N 8,841,984 documents, h 768); building it takes ≈ 25 s of host
time and ≈ 22 GB of device memory, so it is made on the card's machine.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import exec as qexec
from repro_torch.core import hybrid_index as hi
from repro_torch.core import inverted_lists
from repro_torch.core.codecs import pq as pq_codec
from repro_torch.core.codecs import sq8 as sq8_codec

# the serve_msmarco serving shape (configs/hi2_synth.py::HI2ServeShape)
N_DOCS, HIDDEN, N_CLUSTERS, VOCAB = 8_841_984, 768, 10_000, 30_528
CLUSTER_CAP = TERM_CAP = 1_024
PQ_M, PQ_K = 96, 256
KC, K2, TOP_R = 30, 32, 100
BATCH, QUERY_LEN = 256, 32
K1_TERMS = 3                         # indexed terms per document
REFINE_CODEC = "refine:sq8:4"        # serve_msmarco_refine_sq8's codec
SMOKE_BATCHES = 4                    # chip_smoke.py's default --batches


def synth_leaves(rng: np.random.Generator) -> dict:
    """Index leaves at the serve_msmarco shape: Gaussian centroids and
    codewords, an orthogonal rotation (QR of a Gaussian), uniform codes
    and doc→cluster assignment, K₁ᵀ=3 Zipf terms per document with
    random impacts in [0.05, 1.05) (the (V, Ct) f32 impact plane of
    hybrid search, descending per list, 0.0 at pads), positive average
    term scores."""
    zipf = 1.0 / np.arange(1, VOCAB + 1) ** 1.07
    zipf /= zipf.sum()
    doc_assign = rng.integers(0, N_CLUSTERS, N_DOCS).astype(np.int32)
    cl = inverted_lists.build(np.arange(N_DOCS), doc_assign, None,
                              N_CLUSTERS, CLUSTER_CAP, device="cpu")
    terms = rng.choice(VOCAB, size=N_DOCS * K1_TERMS, p=zipf)
    tl, impacts = inverted_lists.build_scored(
        np.repeat(np.arange(N_DOCS), K1_TERMS), terms,
        rng.random(terms.size) + 0.05, VOCAB, TERM_CAP, device="cpu")
    rotation, _ = np.linalg.qr(rng.normal(size=(HIDDEN, HIDDEN)))
    return {
        ".cluster_sel.embeddings":
            rng.normal(size=(N_CLUSTERS, HIDDEN)).astype(np.float32),
        ".term_sel.avg_scores": (rng.random(VOCAB) + 0.1).astype(np.float32),
        ".cluster_lists.entries": cl.entries.numpy(),
        ".cluster_lists.lengths": cl.lengths.numpy(),
        ".term_lists.entries": tl.entries.numpy(),
        ".term_lists.lengths": tl.lengths.numpy(),
        ".sparse_weights": impacts.numpy(),
        ".codec_params.rotation": rotation.astype(np.float32),
        ".codec_params.codebook.codewords": rng.normal(
            size=(PQ_M, PQ_K, HIDDEN // PQ_M)).astype(np.float32),
        ".doc_planes['codes']": rng.integers(0, PQ_K, (N_DOCS, PQ_M),
                                             dtype=np.uint8),
        ".doc_assign": doc_assign,
    }


def planted_docs(entries: np.ndarray, best: np.ndarray) -> np.ndarray:
    """One member of each query's best cluster, a different one for
    queries that share a cluster."""
    taken: dict = {}
    qrels = np.empty(len(best), np.int64)
    for i, c in enumerate(best):
        taken[c] = taken.get(c, -1) + 1
        qrels[i] = entries[c, taken[c]]
    if (qrels < 0).any():
        raise RuntimeError("a best cluster has too few members to plant a "
                           "positive")
    return qrels


def synth_queries(rng: np.random.Generator, n: int):
    """Unit-norm query embeddings and Zipf query tokens."""
    zipf = 1.0 / np.arange(1, VOCAB + 1) ** 1.07
    zipf /= zipf.sum()
    qe = rng.normal(size=(n, HIDDEN))
    qe /= np.linalg.norm(qe, axis=-1, keepdims=True)
    qt = rng.choice(VOCAB, size=(n, QUERY_LEN), p=zipf).astype(np.int32)
    return qe.astype(np.float32), qt


def refine_index(index, dev, seed: int, qe: np.ndarray):
    """The ``refine:sq8:4`` index over ``index``'s lists and selectors:
    fp16 refine rows ~ N(0, 1/h) drawn on the card in chunks from an
    explicit generator, SQ8 ranges and codes from the codec's own train
    and encode of those rows.  Each query's planted positive (a member
    of its best cluster, as in phase 3) gets the query as its refine row
    and the query's encoding as its codes.  Returns (index, qrels)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    emb = torch.empty((N_DOCS, HIDDEN), dtype=torch.float16, device=dev)
    for i in range(0, N_DOCS, sq8_codec.BLOCK):
        rows = emb[i:i + sq8_codec.BLOCK]
        rows.copy_(torch.randn(rows.shape, generator=gen, device=dev)
                   / math.sqrt(HIDDEN))
    codec = sq8_codec.SQ8Codec()
    params = codec.train(gen, emb)
    codes = codec.encode(params, emb)["codes"]
    q = torch.from_numpy(qe).to(dev)
    best = (q @ index.cluster_sel.embeddings.T).argmax(dim=1).cpu().numpy()
    qrels = planted_docs(index.cluster_lists.entries.cpu().numpy(), best)
    at = torch.from_numpy(qrels).to(dev)
    emb[at] = q.half()
    codes[at] = codec.encode(params, q.half())["codes"]
    return dataclasses.replace(
        index, codec=REFINE_CODEC, codec_params=params,
        doc_planes={"codes": codes, "refine_emb": emb}), qrels


def main_path_inputs(index, qe0, qt0) -> dict:
    """What the main path hands each kernel for one full batch: the
    dispatch inputs, the candidate rows and live mask, and the score
    stage's LUT (opq) or pre-scaled queries and bias (sq8)."""
    with torch.inference_mode():
        cl_ids, tm_ids = qexec.dispatch(index.cluster_sel, index.term_sel,
                                        qe0, qt0, KC, K2)
        frontier = qexec.gather([hi.base_source(index)], cl_ids, tm_ids)
        inp = dict(x=qe0, emb=index.cluster_sel.embeddings, cl_ids=cl_ids,
                   cands=frontier.cands,
                   rows=frontier.local[0].contiguous(),
                   live=qexec.dedup(frontier).contiguous(),
                   plane=index.doc_planes["codes"])
        if index.codec == "opq":
            inp["lut"] = pq_codec.opq_adc_lut(index.codec_params,
                                              qe0).contiguous()
        else:
            inp["q_scaled"] = (qe0 * index.codec_params["scale"]
                               ).contiguous()
            inp["bias"] = qe0 @ index.codec_params["lo"]
        return inp

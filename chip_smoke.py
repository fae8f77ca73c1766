#!/usr/bin/env python3
"""On-card smoke of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py [--seed 0] [--batches 4]

Phases, in order; any failure raises, so the script exits non-zero and
never prints the final line.  Every phase prints its seconds.

  1. card     the ``nvidia-smi`` name/power-limit line and torch's name;
  2. build    every CUDA kernel from this checkout's sources (one nvcc
              per source, in parallel) into ``build/kernels/``;
  3. index    the ``serve_msmarco`` shape (configs/hi2_synth.py:
              8,841,984 docs, h=768, L=10,000, V=30,528, capacities
              1,024, OPQ m=96 k=256) synthesized on the host from
              ``--seed`` and moved to the card;
  4. parity   each kernel against its plain PyTorch version on the
              card at edge shapes, and the two kernels of the ``opq``
              path at its full width;
  5. serving  ``Server(ServeConfig(kc=30, k2=32, top_r=100,
              max_batch=256))`` answers ``--batches`` batches of 256
              queries with every launch count reset just before; each
              kernel of the path must have launched, and each query must
              rank first the positive planted for it (recall@1 = 1);
  6. check    the first 8 queries against the same search on the CPU
              (the plain path) over the same planes;
  7. times    each kernel, its plain version and the library yardstick
              with CUDA events, beside the kernel's bound;
  8. profile  device time by kernel over one served batch
              (torch.profiler) and the device's busy share;
  9. refine   the ``serve_msmarco_refine_sq8`` setting (codec
              ``refine:sq8:4``) over the same lists: an fp16 refine
              plane drawn on the card from ``--seed`` and its SQ8
              encoding (the codec's own train + encode, on the card),
              then phases 4–8 again for ``sq8_dot_fused`` at that width;
 10. build    the port's own index build on the card: the synthetic
              corpus at N = 1,048,576 (full widths), built as
              ``refine:sq8:4``, then ``opq`` and ``flat`` over the same
              KMeans; each is served in 256-query batches and scored
              (R@100, MRR@10) beside the brute-force ``flat.search``;
              ``refine:sq8:4`` must stay within 0.01 R@100 of ``flat``.
              Each build is a counted run: KMeans and OPQ training must
              launch ``assign_argmax`` the expected number of times;
 11a. flash   ``flash_attention`` against its plain version at edge cases
              (f32 / bf16, d 16-128, causal, windows, GQA, ragged and
              fully-masked rows, strided inputs; out and lse) and at
              llama3-8b's attention shape;
 11b. assign  ``assign_argmax`` against its plain version at ragged N / L,
              h 8 / 40 / 768, the batched PQ axis, constructed ties, and
              the build's full width on 65,536 corpus points;
 12. sup      the HI²_sup indexing path: the term-scorer encoder at the
              paper's BERT slot (768-d, 12 heads, 2 layers, V = 30,528;
              random weights from ``--seed`` carried across in the
              reference's leaf layout) and phase 10's cluster embeddings;
              position scores of 1,024 docs against the CPU plain path;
              ``build_sup_index(codec="refine:sq8:4")`` over all N as a
              counted run (one ``flash_attention`` launch per layer per
              4,096-doc chunk); 4 x 256 queries served and 8 checked
              against the CPU; R@100 / MRR@10 beside phase 10's;
 13. times    both new kernels at the path's shapes, beside their bounds,
              plain versions and library yardsticks;

then prints the ``kernels`` JSON line and, last, the ``ok`` line.  Each
kernel's ``launches`` is read from the counted run of the path that runs
it: ``pq_adc_fused`` and ``topk_scores`` from phase 5, ``sq8_dot_fused``
from 9c, ``assign_argmax`` from phase 10's builds, ``flash_attention``
from phase 12.  It imports only the port, never jax or the reference
package, and exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.core import exec as qexec  # noqa: E402
from repro_torch.core import hybrid_index as hi  # noqa: E402
from repro_torch.core import inverted_lists  # noqa: E402
from repro_torch.core import metrics  # noqa: E402
from repro_torch.core import term_selector as ts_mod  # noqa: E402
from repro_torch.core.codecs import flat as flat_codec  # noqa: E402
from repro_torch.core.codecs import pq as pq_codec  # noqa: E402
from repro_torch.core.codecs import sq8 as sq8_codec  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.assign_topk import ops as at_ops  # noqa: E402
from repro_torch.kernels.assign_topk import ref as at_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.pq_adc import ops as adc_ops  # noqa: E402
from repro_torch.kernels.pq_adc import ref as adc_ref  # noqa: E402
from repro_torch.kernels.sq8_dot import ops as sq8_ops  # noqa: E402
from repro_torch.kernels.sq8_dot import ref as sq8_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

# the serve_msmarco serving shape (configs/hi2_synth.py::HI2ServeShape)
N_DOCS, HIDDEN, N_CLUSTERS, VOCAB = 8_841_984, 768, 10_000, 30_528
CLUSTER_CAP = TERM_CAP = 1_024
PQ_M, PQ_K = 96, 256
KC, K2, TOP_R = 30, 32, 100
BATCH, QUERY_LEN = 256, 32
K1_TERMS = 3                         # indexed terms per document
REFINE_CODEC = "refine:sq8:4"        # serve_msmarco_refine_sq8's codec

# the on-card build (phase 10): N cut from 8.8 M, widths kept
BUILD_DOCS, BUILD_QUERIES, BUILD_ITERS = 1_048_576, 1_024, 15
REFINE_RECALL_GAP = 0.01             # R@100 of refine:sq8:4 vs flat
DESIGN_RECALL_GAP = 0.001            # the DESIGN.md §7 contract, reported
# assign_argmax launches of each phase-10 build: KMeans runs BUILD_ITERS
# Lloyd steps and a final assignment; OPQ (codecs/pq.py::train_opq
# defaults) fits PQ_FITS = 5 PQ codebooks of PQ_ITERS + 1 assignments,
# encodes 4 times for Procrustes, and the build encodes once more
PQ_FITS, PQ_ITERS, OPQ_OUTER = 5, 10, 4
BUILD_ASSIGN_LAUNCHES = {REFINE_CODEC: BUILD_ITERS + 1,
                         "opq": PQ_FITS * (PQ_ITERS + 1) + OPQ_OUTER + 1,
                         "flat": 0}
# stage seconds of the cuBLAS + argmax assignment route that
# assign_argmax replaced, on an H100 80GB HBM3 at 700 W (PERF.md §5)
CUBLAS_ROUTE_STAGES = {"clusters": 6.65, "codec_train": 13.13}

# the HI²_sup term scorer: the encoder train_hi2_sup builds at the
# paper's BERT slot (768-d, 12 heads, d_ff 4·d, 2 layers = SupTrainConfig
# encoder_layers), f32 compute; chunks of ENCODE_BATCH documents
ENC_LAYERS, ENC_HEADS, ENCODE_BATCH = 2, 12, 4096
N_SUP_CHECK = 1_024                  # docs held against the CPU encoder
SUP_TOL = 1e-4                       # position scores, rtol = atol
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # out, rtol = atol
LSE_TOL = 1e-4
ASSIGN_TOL = 1e-5                    # rtol = atol: dot-product order
ASSIGN_BLOCK = 65_536                # points per block of a timed plane
ASSIGN_SIZES = (1, 7, 513, 10_000)   # ragged N and L of phase 11b
# llama3-8b's attention (configs/llama3_8b.py): B, S, Hq, Hkv, d (bf16)
LLAMA_ATTN = (1, 4096, 32, 8, 128)

# H100 SXM published peaks (NVIDIA H100 datasheet)
PEAK_FP32_FLOPS = 67e12              # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12                 # HBM3

ADC_TOL = 1e-4                       # rtol = atol: m-reduction order
TOPK_TOL = 1e-5                      # rtol = atol: dot-product order
SQ8_EDGE_RTOL, SQ8_EDGE_ATOL = 1e-4, 1e-2   # the JAX kernel test's own
SQ8_TOL = 1e-4                       # rtol = atol after the bias
N_CHECK = 8                          # queries held against the CPU path

#: kernel → (its wrapper module, the name of its launch count there)
COUNTERS = {"pq_adc_fused": (adc_ops, "launches"),
            "topk_scores": (at_ops, "launches"),
            "sq8_dot_fused": (sq8_ops, "launches"),
            "assign_argmax": (at_ops, "assign_launches"),
            "flash_attention": (fa_ops, "launches")}


def log(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


@contextlib.contextmanager
def phase(name: str):
    """Print the phase's seconds when it ends (after the card's queued
    work has finished)."""
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    log(f"[seconds] {name}: {time.perf_counter() - t0:.1f} s")


def reset_counts() -> None:
    for mod, attr in COUNTERS.values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {k: getattr(mod, attr) for k, (mod, attr) in COUNTERS.items()}


# --------------------------------------------------------------------------
# phase 3: the synthetic serve_msmarco index
# --------------------------------------------------------------------------

def synth_leaves(rng: np.random.Generator) -> dict:
    """Index leaves at the serve_msmarco shape: Gaussian centroids and
    codewords, an orthogonal rotation (QR of a Gaussian), uniform codes
    and doc→cluster assignment, K₁ᵀ=3 Zipf terms per document with
    random positive impacts, positive average term scores."""
    zipf = 1.0 / np.arange(1, VOCAB + 1) ** 1.07
    zipf /= zipf.sum()
    doc_assign = rng.integers(0, N_CLUSTERS, N_DOCS).astype(np.int32)
    cl = inverted_lists.build(np.arange(N_DOCS), doc_assign, None,
                              N_CLUSTERS, CLUSTER_CAP, device="cpu")
    terms = rng.choice(VOCAB, size=N_DOCS * K1_TERMS, p=zipf)
    tl = inverted_lists.build(np.repeat(np.arange(N_DOCS), K1_TERMS), terms,
                              rng.random(terms.size), VOCAB, TERM_CAP,
                              device="cpu")
    rotation, _ = np.linalg.qr(rng.normal(size=(HIDDEN, HIDDEN)))
    return {
        ".cluster_sel.embeddings":
            rng.normal(size=(N_CLUSTERS, HIDDEN)).astype(np.float32),
        ".term_sel.avg_scores": (rng.random(VOCAB) + 0.1).astype(np.float32),
        ".cluster_lists.entries": cl.entries.numpy(),
        ".cluster_lists.lengths": cl.lengths.numpy(),
        ".term_lists.entries": tl.entries.numpy(),
        ".term_lists.lengths": tl.lengths.numpy(),
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
        fail("a best cluster has too few members to plant a positive")
    return qrels


def plant_positives(leaves: dict, qe: np.ndarray) -> np.ndarray:
    """Give each query one document it must rank first: a member of
    its best cluster whose codes are the query's best codeword in every
    fragment (the highest ADC score any document can reach).  Rewrites
    those rows of the codes leaf; returns the (n,) positive doc ids."""
    best = (qe @ leaves[".cluster_sel.embeddings"].T).argmax(axis=1)
    frags = (qe @ leaves[".codec_params.rotation"]).reshape(
        len(qe), PQ_M, -1)
    codes = np.einsum("bmd,mkd->bmk", frags,
                      leaves[".codec_params.codebook.codewords"]).argmax(-1)
    qrels = planted_docs(leaves[".cluster_lists.entries"], best)
    leaves[".doc_planes['codes']"][qrels] = codes.astype(np.uint8)
    return qrels


def synth_queries(rng: np.random.Generator, n: int):
    """Unit-norm query embeddings and Zipf query tokens."""
    zipf = 1.0 / np.arange(1, VOCAB + 1) ** 1.07
    zipf /= zipf.sum()
    qe = rng.normal(size=(n, HIDDEN))
    qe /= np.linalg.norm(qe, axis=-1, keepdims=True)
    qt = rng.choice(VOCAB, size=(n, QUERY_LEN), p=zipf).astype(np.int32)
    return qe.astype(np.float32), qt


# --------------------------------------------------------------------------
# phase 9: the serve_msmarco_refine_sq8 planes
# --------------------------------------------------------------------------

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


# --------------------------------------------------------------------------
# comparisons
# --------------------------------------------------------------------------

def check_masked(got, want, rtol: float, atol: float, kname: str,
                 what: str) -> float:
    """-inf lanes identical, finite scores within rtol/atol; returns the
    largest absolute error."""
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        fail(f"{kname} {what}: -inf lanes differ from the plain version")
    fin = torch.isfinite(want)
    if not torch.allclose(got[fin], want[fin], rtol=rtol, atol=atol):
        fail(f"{kname} {what}: scores differ beyond rtol {rtol}, atol "
             f"{atol}")
    return float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0


def check_adc(got, want, what: str) -> float:
    return check_masked(got, want, ADC_TOL, ADC_TOL, "pq_adc_fused", what)


def check_topk(got, want, full, what: str) -> float:
    """Scores within TOPK_TOL; ids identical except where the two
    orders swap documents whose exact (plain) scores lie within
    TOPK_TOL.  ``full`` is the plain (N, L) score plane."""
    gs, gi = got
    ws, wi = want
    if not torch.allclose(gs, ws, rtol=TOPK_TOL, atol=TOPK_TOL):
        fail(f"topk_scores {what}: scores differ beyond {TOPK_TOL}")
    diff = gi != wi
    if diff.any():
        own = torch.gather(full, 1, gi.long())      # plain score of got ids
        gap = (own - ws).abs()[diff]
        if (gap > TOPK_TOL + TOPK_TOL * ws.abs()[diff]).any():
            fail(f"topk_scores {what}: ids differ beyond score ties")
    if not all(len(set(row)) == len(row) for row in gi.tolist()):
        fail(f"topk_scores {what}: an id repeats within a row")
    return float((gs - ws).abs().max())


def topk_match(ref_ids, ref_s, got_ids, got_s, tol: float) -> bool:
    """Top-R ids equal up to swaps between scores within ``tol``; scores
    within rtol=atol=``tol`` (numpy arrays of one query)."""
    if not np.allclose(got_s, ref_s, rtol=tol, atol=tol):
        return False
    for p in np.flatnonzero(got_ids != ref_ids):
        where = np.flatnonzero(ref_ids == got_ids[p])
        ref = ref_s[where[0]] if where.size else ref_s[-1]
        if abs(ref - got_s[p]) > tol + tol * abs(ref):
            return False
    return True


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

class Timer:
    """CUDA-event times of a callable, L2 flushed before every run (the
    serving path finds the kernels' inputs cold)."""

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps: int, warm: int = 2) -> float:
        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def profile_batch(server, qe, qt, top: int = 12) -> None:
    """Device time by kernel over one served batch (torch.profiler),
    and the device's busy share of the batch's wall time."""
    from torch.profiler import ProfilerActivity, profile
    server.query(qe, qt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.query(qe, qt)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: an operator's row repeats its kernels' time
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy_us = sum(r[0] for r in rows)
    if not rows:
        log("[profile] the profiler saw no device time")
        return
    log(f"[profile] one batch ({server.index.codec}): wall "
        f"{wall_us / 1e3:.3f} ms (profiled), device busy "
        f"{busy_us / 1e3:.3f} ms ({busy_us / wall_us:.1%}); top {top} by "
        f"device time:")
    for us, count, key in rows[:top]:
        log(f"[profile]   {us / 1e3:8.3f} ms  {us / busy_us:6.1%}  "
            f"x{count:<4d} {key[:90]}")


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time on the card (ms) and what sets it."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def card() -> str:
    """Phase 1: print the nvidia-smi name/power-limit line; returns
    torch's name of card 0."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = smi.stdout.strip().splitlines()
    log(lines[0] if lines else "nvidia-smi printed nothing")
    name = torch.cuda.get_device_name(0)
    log(f"[card] torch device: {name}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return name


def build_kernels() -> None:
    """Phase 2: one nvcc per kernel source, in parallel."""
    logs = _build.build()
    log(f"[build] {len(_build.SOURCES)} kernels ready (built now: "
        f"{sorted(logs)})")
    for kname, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {kname}: {line.strip()}")


def _cases_to(dev, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


def parity_edges(dev, prng: np.random.Generator) -> dict:
    """Phase 4a: each kernel against its plain version at edge shapes;
    returns the largest error per kernel."""
    errs = {k: 0.0 for k in COUNTERS}
    adc_cases = [  # (name, b, c, m, k, code dtype, dup ids, masked row)
        ("c_ragged", 2, 8192 + 300, 96, 256, np.uint8, False, None),
        ("c_below_tile", 3, 5, 8, 128, np.uint8, False, 1),
        ("dup_masked_i32", 2, 1000, 8, 512, np.int32, True, 0),
        ("dup_masked_u8", 4, 700, 16, 256, np.uint8, True, 3),
        ("scalar_rows_m1", 2, 333, 1, 64, np.uint8, False, None),
        ("all_masked", 2, 100, 4, 64, np.uint8, False, "all"),
    ]
    for cname, b, c, m, k, dtype, dup, mask in adc_cases:
        lut, plane = _cases_to(dev, prng.normal(size=(b, m, k)).astype(
            np.float32), prng.integers(0, k, (900, m)).astype(dtype))
        ids = prng.integers(-2, 902, (b, c)).astype(np.int32)  # clipped
        if dup:
            ids = np.concatenate([ids[:, : (c + 1) // 2]] * 2, -1)[:, :c]
        live = prng.random((b, c)) < 0.8
        if mask == "all":
            live[:] = False
        elif mask is not None:
            live[mask] = False
        ids, live = _cases_to(dev, ids, live)
        errs["pq_adc_fused"] = max(errs["pq_adc_fused"], check_adc(
            adc_ops.pq_adc_fused(lut, plane, ids, live),
            adc_ref.pq_adc_fused(lut, plane, ids, live), cname))
    # rows not 16-byte aligned take the scalar path
    plane = _cases_to(dev, prng.integers(0, 256, 900 * 96 + 3).astype(
        np.uint8))[0][3:].view(900, 96)
    lut, ids = _cases_to(dev, prng.normal(size=(2, 96, 256)).astype(
        np.float32), prng.integers(0, 900, (2, 500)).astype(np.int32))
    live = torch.ones((2, 500), dtype=torch.bool, device=dev)
    errs["pq_adc_fused"] = max(errs["pq_adc_fused"], check_adc(
        adc_ops.pq_adc_fused(lut, plane, ids, live),
        adc_ref.pq_adc_fused(lut, plane, ids, live), "unaligned_rows"))

    topk_cases = [  # (name, n, l, h, k, duplicated centroid rows)
        ("ties", 33, 300, 32, 12, True),
        ("small", 5, 37, 16, 4, False),
        ("k_equals_l", 3, 2, 16, 2, True),
        ("ragged_tiles", 17, 129, 40, 8, True),
        ("k_max", 2, 10_000, 768, at_ops.MAX_K, False),
    ]
    for cname, n, l, h, k, ties in topk_cases:
        x = prng.normal(size=(n, h))
        x = (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(
            np.float32)
        emb = prng.normal(size=(l, h)).astype(np.float32)
        if ties:
            emb = np.concatenate([emb[: (l + 1) // 2]] * 2)[:l]
        x, emb = _cases_to(dev, x, emb)
        errs["topk_scores"] = max(errs["topk_scores"], check_topk(
            at_ops.topk_scores(x, emb, k), at_ref.topk_scores(x, emb, k),
            x @ emb.T, cname))

    sq8_cases = [  # (name, b, c, h, dup ids, masked row); a tile is 512
        ("c_below_tile", 3, 5, 768, False, 1),
        ("c_ragged", 2, 3 * 512 + 77, 768, False, None),
        ("c_one_short", 2, 511, 768, True, None),
        ("dup_masked_h16", 4, 700, 16, True, 3),
        ("h40_scalar", 2, 333, 40, False, 0),
        ("all_masked", 2, 100, 768, False, "all"),
    ]
    n_rows = 900
    for cname, b, c, h, dup, mask in sq8_cases:
        q, plane = _cases_to(dev, prng.normal(size=(b, h)).astype(
            np.float32), prng.integers(0, 256, (n_rows, h)).astype(np.uint8))
        ids = prng.integers(-2, n_rows + 2, (b, c)).astype(np.int32)
        if dup:
            ids = np.concatenate([ids[:, : (c + 1) // 2]] * 2, -1)[:, :c]
        live = prng.random((b, c)) < 0.8
        if mask == "all":
            live[:] = False
        elif mask is not None:
            live[mask] = False
        ids, live = _cases_to(dev, ids, live)
        errs["sq8_dot_fused"] = max(errs["sq8_dot_fused"], check_masked(
            sq8_ops.sq8_dot_fused(q, plane, ids, live),
            sq8_ref.sq8_dot_fused(q, plane, ids, live), SQ8_EDGE_RTOL,
            SQ8_EDGE_ATOL, "sq8_dot_fused", cname))
    # a plane view 3 bytes into its buffer: rows are not 16-byte aligned
    plane = _cases_to(dev, prng.integers(0, 256, n_rows * 768 + 3).astype(
        np.uint8))[0][3:].view(n_rows, 768)
    q, ids = _cases_to(dev, prng.normal(size=(2, 768)).astype(np.float32),
                       prng.integers(0, n_rows, (2, 700)).astype(np.int32))
    live = torch.ones((2, 700), dtype=torch.bool, device=dev)
    errs["sq8_dot_fused"] = max(errs["sq8_dot_fused"], check_masked(
        sq8_ops.sq8_dot_fused(q, plane, ids, live),
        sq8_ref.sq8_dot_fused(q, plane, ids, live), SQ8_EDGE_RTOL,
        SQ8_EDGE_ATOL, "sq8_dot_fused", "unaligned_view"))
    log(f"[parity] edge shapes: pq_adc_fused {len(adc_cases) + 1} cases, "
        f"topk_scores {len(topk_cases)} cases, sq8_dot_fused "
        f"{len(sq8_cases) + 1} cases")
    return errs


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


def check_no_extra_memory(fn, out_bytes: int, what: str) -> int:
    """Run ``fn`` once; fail if it allocates more than its output (plus
    1 MB); returns the peak it added."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    if extra > out_bytes + (1 << 20):
        fail(f"{what} allocated {extra} B beyond its output")
    return extra


def parity_full_width(inp: dict, errs: dict) -> None:
    """Phase 4b: both kernels of the opq path at its full width (the
    plain ADC on N_CHECK queries: it builds (B, C, m)), and no (B, C, m)
    allocation in the full-batch kernel call."""
    x, emb = inp["x"], inp["emb"]
    errs["topk_scores"] = max(errs["topk_scores"], check_topk(
        at_ops.topk_scores(x, emb, KC), at_ref.topk_scores(x, emb, KC),
        x @ emb.T, "full_width"))
    lut, plane, rows, live = (inp[k] for k in ("lut", "plane", "rows",
                                                "live"))
    q = slice(0, N_CHECK)
    errs["pq_adc_fused"] = max(errs["pq_adc_fused"], check_adc(
        adc_ops.pq_adc_fused(lut[q], plane, rows[q], live[q]),
        adc_ref.pq_adc_fused(lut[q], plane, rows[q], live[q]),
        "full_width"))
    extra = check_no_extra_memory(
        lambda: adc_ops.pq_adc_fused(lut, plane, rows, live),
        rows.numel() * 4, "pq_adc_fused")
    log(f"[parity] full width: pq_adc_fused at B={rows.shape[0]} peaks at "
        f"{extra / 1e6:.1f} MB for a {rows.numel() * 4 / 1e6:.1f} MB (B, C) "
        f"output (a (B, C, m) codes tensor would be "
        f"{rows.numel() * PQ_M / 1e9:.2f} GB); max abs err pq_adc_fused "
        f"{errs['pq_adc_fused']:.3g} (tol {ADC_TOL}), topk_scores "
        f"{errs['topk_scores']:.3g} (tol {TOPK_TOL})")


def parity_full_width_sq8(inp: dict, errs: dict) -> None:
    """Phase 9b: ``sq8_dot_fused`` at the refine path's full width on
    N_CHECK queries (the plain version builds (B, C, h) f32), held to
    rtol=atol=SQ8_TOL after the bias, and no (B, C, h) allocation in the
    full-batch kernel call."""
    q_scaled, plane, rows, live, bias = (
        inp[k] for k in ("q_scaled", "plane", "rows", "live", "bias"))
    q = slice(0, N_CHECK)
    errs["sq8_dot_fused"] = max(errs["sq8_dot_fused"], check_masked(
        sq8_ops.sq8_dot_fused(q_scaled[q], plane, rows[q], live[q])
        + bias[q, None],
        sq8_ref.sq8_dot_fused(q_scaled[q], plane, rows[q], live[q])
        + bias[q, None], SQ8_TOL, SQ8_TOL, "sq8_dot_fused", "full_width"))
    extra = check_no_extra_memory(
        lambda: sq8_ops.sq8_dot_fused(q_scaled, plane, rows, live),
        rows.numel() * 4, "sq8_dot_fused")
    log(f"[parity] full width: sq8_dot_fused at B={rows.shape[0]} peaks at "
        f"{extra / 1e6:.1f} MB for a {rows.numel() * 4 / 1e6:.1f} MB (B, C) "
        f"output (a (B, C, h) f32 rows tensor would be "
        f"{rows.numel() * HIDDEN * 4 / 1e9:.1f} GB); max abs err "
        f"{errs['sq8_dot_fused']:.3g} (edge tol rtol {SQ8_EDGE_RTOL} atol "
        f"{SQ8_EDGE_ATOL}; full width rtol=atol={SQ8_TOL})")


def serve_batches(index, dev, qe_all, qt_all, batches: int, kernels,
                  what: str):
    """A counted main-path run: every launch count is set to 0 just
    before the batches and read just after; each kernel in ``kernels``
    must have launched.  Returns (server, results, launches)."""
    server = serve.Server(index, serve.ServeConfig(
        kc=KC, k2=K2, top_r=TOP_R, max_batch=BATCH), device=dev)
    server.warmup(qe_all.shape[1], qt_all.shape[1])
    reset_counts()
    results, batch_s = [], []
    for i in range(batches):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        t0 = time.perf_counter()
        results.append(server.query(qe_all[sl], qt_all[sl]))
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    launches = read_counts()
    log(f"[serving] {what}: {server.n_served} queries in "
        f"{sum(batch_s):.3f} s ({server.n_served / sum(batch_s):.1f} q/s; "
        f"batch ms {[round(s * 1e3, 2) for s in batch_s]}); launches "
        f"{launches}")
    missing = [k for k in kernels if launches[k] < 1]
    if missing:
        fail(f"{what}: kernel(s) of the path never launched: {missing}")
    for res in results:
        if res.doc_ids.shape != (BATCH, TOP_R):
            fail(f"{what}: result shape {tuple(res.doc_ids.shape)}")
        if not torch.isfinite(res.scores).all():
            fail(f"{what}: non-finite result scores")
        if int(res.n_candidates.min()) < TOP_R:
            fail(f"{what}: a query evaluated fewer than R candidates")
    mean_cand = float(torch.cat([r.n_candidates for r in results])
                      .float().mean())
    log(f"[serving] {what}: mean unique live candidates {mean_cand:.0f} of "
        f"{hi.candidate_budget(index, KC, K2)} slots")
    return server, results, launches


def check_planted(results, qrels, what: str) -> None:
    ids = torch.cat([r.doc_ids for r in results]).cpu()
    r1 = metrics.recall_at_k(ids, qrels, 1)
    log(f"[serving] {what}: planted positives: recall@1 {r1}, MRR@10 "
        f"{metrics.mrr_at_k(ids, qrels, 10)}")
    if r1 != 1.0:
        fail(f"{what}: a query did not rank its planted positive first")


def check_cpu(cpu_index, qe8, qt8, inp: dict, first, tol: float) -> None:
    """Phase 6: the first N_CHECK queries against the CPU plain path
    over the same planes.  A query whose K^C-th and next cluster scores
    lie within TOPK_TOL may dispatch another set of clusters: it is
    listed, not checked.  One whose near-ties lie inside its top K^C
    dispatches the same set in a possibly other order: its cluster ids
    are compared as a set and its candidate plane (ordered by dispatch)
    is not, while n_candidates and the top-R are checked as for any
    other query."""
    t0 = time.perf_counter()
    ref = hi.search(cpu_index, qe8, qt8, kc=KC, k2=K2, top_r=TOP_R,
                    device="cpu")
    cpu_s = time.perf_counter() - t0
    full = torch.from_numpy(qe8) @ cpu_index.cluster_sel.embeddings.T
    top = torch.sort(full, dim=-1, descending=True).values[:, : KC + 1]
    gaps = top[:, :-1] - top[:, 1:]
    boundary = gaps[:, KC - 1] <= TOPK_TOL
    inner = (gaps[:, : KC - 1] <= TOPK_TOL).any(dim=1)
    with torch.inference_mode():
        cpu_cl, cpu_tm = qexec.dispatch(
            cpu_index.cluster_sel, cpu_index.term_sel,
            torch.from_numpy(qe8), torch.from_numpy(qt8).long(), KC, K2)
        cpu_cands = qexec.gather([hi.base_source(cpu_index)], cpu_cl,
                                 cpu_tm).cands
    skipped, as_sets = [], []
    for b in range(N_CHECK):
        if bool(boundary[b]):
            skipped.append(b)
            continue
        got_cl = inp["cl_ids"][b].cpu()
        if bool(inner[b]):
            as_sets.append(b)
            if not torch.equal(torch.sort(got_cl).values,
                               torch.sort(cpu_cl[b]).values):
                fail(f"query {b}: dispatched clusters differ from the CPU "
                     f"path")
        else:
            if not torch.equal(got_cl, cpu_cl[b]):
                fail(f"query {b}: dispatch ids differ from the CPU path")
            if not torch.equal(inp["cands"][b].cpu(), cpu_cands[b]):
                fail(f"query {b}: candidate plane differs from the CPU path")
        if int(first.n_candidates[b]) != int(ref.n_candidates[b]):
            fail(f"query {b}: n_candidates differs from the CPU path")
        if not topk_match(ref.doc_ids[b].numpy(), ref.scores[b].numpy(),
                          first.doc_ids[b].cpu().numpy(),
                          first.scores[b].cpu().numpy(), tol):
            fail(f"query {b}: top-R differs from the CPU path")
    log(f"[check] {cpu_index.codec}: {N_CHECK - len(skipped)} of {N_CHECK} "
        f"queries match the CPU plain path (CPU search {cpu_s:.1f} s); "
        f"near-ties inside the top K^C (clusters compared as a set): "
        f"{as_sets}; near-ties at the K^C boundary, skipped: {skipped}")


def time_kernels(inp: dict) -> dict:
    """Phase 7: kernel, plain and library times at the opq path's
    shapes, beside each kernel's bound for this run's data."""
    timer = Timer()
    x, emb = inp["x"], inp["emb"]
    lut, plane, rows, live = (inp[k] for k in ("lut", "plane", "rows",
                                                "live"))
    n, h = x.shape
    l = emb.shape[0]
    b, c = rows.shape
    live_rows = torch.unique(rows[live]).numel()
    n_live = int(live.sum())
    adc_bytes = b * c * (4 + 1 + 4) + lut.numel() * 4 + live_rows * PQ_M
    topk_flops = 2 * n * l * h
    topk_bytes = 4 * (n * h + l * h) + 8 * n * KC

    def plain_adc():          # in 32-query chunks: it builds (B, C, m)
        for s in range(0, b, 32):
            adc_ref.pq_adc_fused(lut[s:s + 32], plane, rows[s:s + 32],
                                 live[s:s + 32])

    adc_bound = bound(n_live * PQ_M, adc_bytes)
    topk_bound = bound(topk_flops, topk_bytes)
    log(f"[times] pq_adc_fused at B={b}, C={c}: {n_live} live slots over "
        f"{live_rows} distinct rows, {adc_bytes / 1e6:.1f} MB to move; "
        f"topk_scores at N={n}, L={l}, h={h}, k={KC}: "
        f"{topk_flops / 1e9:.3f} GFLOP; library_ms of topk_scores is "
        f"torch.topk(x @ emb.T, k), two calls")
    return {
        "pq_adc_fused": dict(
            ms=timer.ms(lambda: adc_ops.pq_adc_fused(lut, plane, rows,
                                                     live), reps=10),
            plain_ms=timer.ms(plain_adc, reps=3, warm=1),
            library_ms=None, bound_ms=adc_bound[0],
            bound_by=adc_bound[1]),
        "topk_scores": dict(
            ms=timer.ms(lambda: at_ops.topk_scores(x, emb, KC), reps=20),
            plain_ms=timer.ms(lambda: at_ref.topk_scores(x, emb, KC),
                              reps=20),
            library_ms=timer.ms(lambda: torch.topk(x @ emb.T, KC),
                                reps=20),
            bound_ms=topk_bound[0], bound_by=topk_bound[1]),
    }


def time_sq8(inp: dict) -> dict:
    """Phase 9d: ``sq8_dot_fused`` and its plain version at the refine
    path's shapes, beside its bound for this run's data.  No one
    PyTorch call computes a gathered dot, so library_ms is null."""
    timer = Timer()
    q_scaled, plane, rows, live = (inp[k] for k in ("q_scaled", "plane",
                                                    "rows", "live"))
    b, c = rows.shape
    h = plane.shape[1]
    live_rows = torch.unique(rows[live]).numel()
    n_live = int(live.sum())
    nbytes = b * c * (4 + 1 + 4) + q_scaled.numel() * 4 + live_rows * h
    sq8_bound = bound(2 * n_live * h, nbytes)

    def plain():              # in 16-query chunks: it builds (B, C, h)
        for s in range(0, b, 16):
            sq8_ref.sq8_dot_fused(q_scaled[s:s + 16], plane,
                                  rows[s:s + 16], live[s:s + 16])

    log(f"[times] sq8_dot_fused at B={b}, C={c}, h={h}: {n_live} live "
        f"slots over {live_rows} distinct rows, {nbytes / 1e6:.1f} MB to "
        f"move, {2 * n_live * h / 1e9:.2f} GFLOP; library_ms null (no one "
        f"PyTorch call computes a gathered dot)")
    return {"sq8_dot_fused": dict(
        ms=timer.ms(lambda: sq8_ops.sq8_dot_fused(q_scaled, plane, rows,
                                                  live), reps=10),
        plain_ms=timer.ms(plain, reps=3, warm=1), library_ms=None,
        bound_ms=sq8_bound[0], bound_by=sq8_bound[1])}


def build_on_card(dev, seed: int) -> dict:
    """Phase 10: the port's build on the card at N = BUILD_DOCS (full
    widths), three codecs over one KMeans, each served and scored.  Each
    build is a counted run that must launch ``assign_argmax`` exactly
    BUILD_ASSIGN_LAUNCHES times.  Returns what phase 12 reuses: the
    corpus, its planes on the card, the KMeans selector and φ(D), the
    ``refine:sq8:4`` quality and the builds' ``assign_argmax`` launches."""
    with phase("build: synthetic corpus on the host"):
        corpus = synthetic.generate(seed, n_docs=BUILD_DOCS,
                                    n_queries=BUILD_QUERIES, hidden=HIDDEN,
                                    vocab_size=VOCAB, query_len=QUERY_LEN,
                                    make_model_b=False)
        emb = torch.from_numpy(corpus.doc_emb).to(dev)
        tokens = torch.from_numpy(corpus.doc_tokens).to(dev).long()
        qe, qt = corpus.query_emb, corpus.query_tokens
    with phase("build: brute-force flat.search"):
        _, oracle = flat_codec.search(torch.from_numpy(qe).to(dev), emb,
                                      k=TOP_R)
        torch.cuda.synchronize()
        log(f"[build] brute force over {BUILD_DOCS} docs: R@100 "
            f"{metrics.recall_at_k(oracle.cpu(), corpus.qrels, 100):.4f}, "
            f"MRR@10 {metrics.mrr_at_k(oracle.cpu(), corpus.qrels, 10):.4f}")
    kernels = {REFINE_CODEC: ("sq8_dot_fused", "topk_scores"),
               "opq": ("pq_adc_fused", "topk_scores"),
               "flat": ("topk_scores",)}
    recall, mrr, base, assign_launches = {}, {}, None, 0
    for spec in (REFINE_CODEC, "opq", "flat"):
        with phase(f"build: {spec} index"):
            timings = {}
            reuse = ({} if base is None else
                     dict(cluster_sel=base.cluster_sel,
                          doc_assign=base.doc_assign))
            reset_counts()
            index = hi.build(seed, emb, tokens, VOCAB, n_clusters=N_CLUSTERS,
                             k1_terms=K1_TERMS, codec=spec, pq_m=PQ_M,
                             pq_k=PQ_K, cluster_capacity=CLUSTER_CAP,
                             term_capacity=TERM_CAP,
                             kmeans_iters=BUILD_ITERS, device=dev,
                             timings=timings, **reuse)
            torch.cuda.synchronize()
            launches = read_counts()
            log(f"[build] {spec} stage seconds: "
                + ", ".join(f"{k} {v:.2f}" for k, v in timings.items())
                + f"; launches {launches}")
            before = {k: v for k, v in CUBLAS_ROUTE_STAGES.items()
                      if k in timings and timings[k] > 1.0}
            if before:
                log(f"[build] {spec} with assign_argmax beside the cuBLAS + "
                    f"argmax route: " + ", ".join(
                        f"{k} {timings[k]:.2f} s (cuBLAS + argmax: {v} s)"
                        for k, v in before.items()))
            if launches["assign_argmax"] != BUILD_ASSIGN_LAUNCHES[spec]:
                fail(f"{spec} build launched assign_argmax "
                     f"{launches['assign_argmax']} times, expected "
                     f"{BUILD_ASSIGN_LAUNCHES[spec]}")
            assign_launches += launches["assign_argmax"]
        with phase(f"build: serve {spec}"):
            _, results, launches = serve_batches(
                index, dev, qe, qt, BUILD_QUERIES // BATCH, kernels[spec],
                f"built {spec}")
            ids = torch.cat([r.doc_ids for r in results]).cpu()
            recall[spec] = metrics.recall_at_k(ids, corpus.qrels, 100)
            mrr[spec] = metrics.mrr_at_k(ids, corpus.qrels, 10)
            log(f"[build] {spec}: R@100 {recall[spec]:.4f}, MRR@10 "
                f"{mrr[spec]:.4f}, candidate "
                f"cost {hi.candidate_cost(index, KC, K2, TOP_R)}, launches "
                f"{launches}")
        base = index if base is None else base
    gap = recall["flat"] - recall[REFINE_CODEC]
    log(f"[build] R@100 gap flat - {REFINE_CODEC}: {gap:.4f} (fails above "
        f"{REFINE_RECALL_GAP}; the DESIGN.md §7 contract is "
        f"{DESIGN_RECALL_GAP})")
    if gap > REFINE_RECALL_GAP:
        fail(f"{REFINE_CODEC} R@100 {recall[REFINE_CODEC]} is more than "
             f"{REFINE_RECALL_GAP} below flat's {recall['flat']}")
    return dict(corpus=corpus, emb=emb, tokens=tokens,
                cluster_sel=base.cluster_sel, doc_assign=base.doc_assign,
                recall=recall[REFINE_CODEC], mrr=mrr[REFINE_CODEC],
                assign_launches=assign_launches)


# --------------------------------------------------------------------------
# phases 11-13: flash_attention, assign_argmax and the HI²_sup path
# --------------------------------------------------------------------------

def _bshd(gen, dev, b, s, h, d, dtype):
    """A (B, H, S, d) view of (B, S, H, d) memory, as the attention
    layer's projections hand the kernel."""
    return torch.randn((b, s, h, d), generator=gen, device=dev).to(
        dtype).transpose(1, 2)


def check_flash(q, k, v, causal, window, what: str) -> float:
    """Kernel against the plain version: out within FLASH_TOL of its
    dtype, lse within LSE_TOL of the plain scores' logsumexp, dead rows
    (no visible key) zeros with lse NEG_INF.  Returns the out error."""
    out, lse = fa_ops.flash_attention(q, k, v, causal, window)
    want, wlse = fa_ref.flash_attention(q, k, v, causal, window)
    tol = FLASH_TOL[q.dtype]
    if not torch.allclose(out.float(), want.float(), rtol=tol, atol=tol):
        fail(f"flash_attention {what}: out differs beyond {tol} (max "
             f"{float((out.float() - want.float()).abs().max()):.3g})")
    if not torch.allclose(lse, wlse, rtol=LSE_TOL, atol=LSE_TOL):
        fail(f"flash_attention {what}: lse differs beyond {LSE_TOL}")
    dead = wlse == fa_ref.NEG_INF
    if not torch.equal(lse == fa_ref.NEG_INF, dead) or bool(
            (out[dead] != 0).any()):
        fail(f"flash_attention {what}: fully-masked rows are not zeros "
             f"with lse -1e30")
    return float((out.float() - want.float()).abs().max())


def llama_qkv(gen, dev):
    b, s_len, hq, hkv, d = LLAMA_ATTN
    return (_bshd(gen, dev, b, s_len, hq, d, torch.bfloat16),
            *(_bshd(gen, dev, b, s_len, hkv, d, torch.bfloat16)
              for _ in range(2)))


def flash_parity(dev, seed: int) -> float:
    """Phase 11a: ``flash_attention`` at edge cases and at llama3-8b's
    attention shape; returns the largest out error."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    heads = [(4, 4), (4, 2), (8, 1), (32, 8)]
    lengths = [(1, 200), (63, 63), (200, 384), (384, 63), (384, 384)]
    masks = [(False, 0), (True, 0), (False, 32), (True, 32)]
    err, n_cases, n_dead = {torch.float32: 0.0, torch.bfloat16: 0.0}, 0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (16, 64, 128):
            for causal, window in masks:
                hq, hkv = heads[n_cases % len(heads)]
                sq, sk = lengths[n_cases % len(lengths)]
                q = _bshd(gen, dev, 2, sq, hq, d, dtype)
                k, v = (_bshd(gen, dev, 2, sk, hkv, d, dtype)
                        for _ in range(2))
                what = (f"{dtype} d={d} causal={causal} window={window} "
                        f"heads=({hq},{hkv}) sq={sq} sk={sk}")
                err[dtype] = max(err[dtype], check_flash(q, k, v, causal,
                                                         window, what))
                n_cases += 1
    # non-causal windows with Sq != Sk: rows with no visible key
    for sq, sk in ((384, 63), (200, 1)):
        q = _bshd(gen, dev, 2, sq, 4, 64, torch.float32)
        k, v = (_bshd(gen, dev, 2, sk, 2, 64, torch.float32)
                for _ in range(2))
        err[torch.float32] = max(err[torch.float32], check_flash(
            q, k, v, False, 32, f"dead rows sq={sq} sk={sk}"))
        n_dead += int((fa_ref.flash_attention(q, k, v, False, 32)[1]
                       == fa_ref.NEG_INF).sum())
    if not n_dead:
        fail("flash_attention: the dead-row cases masked no row")
    # full size: llama3-8b's attention, one batch
    q, k, v = llama_qkv(gen, dev)
    err[torch.bfloat16] = max(err[torch.bfloat16], check_flash(
        q, k, v, True, 0, f"llama3-8b {LLAMA_ATTN} bf16 causal"))
    log(f"[flash] {n_cases} edge cases + 2 dead-row cases ({n_dead} dead "
        f"rows) + llama3-8b full size: max abs out err f32 "
        f"{err[torch.float32]:.3g} (tol {FLASH_TOL[torch.float32]}), bf16 "
        f"{err[torch.bfloat16]:.3g} (tol {FLASH_TOL[torch.bfloat16]}); lse "
        f"within {LSE_TOL}")
    return max(err.values())


def check_assign(x, c, what: str, ties: bool = False) -> tuple[float, int]:
    """Kernel against the plain version: scores within ASSIGN_TOL; ids
    identical except where the plain scores of the two ids lie within
    ASSIGN_TOL (listed by count); on constructed ties (every centroid j
    of the upper half a copy of j - half) the lower twin always wins.
    Returns (max score error, near-tie rows)."""
    gs, gi = at_ops.assign_argmax(x, c)
    ws, wi = at_ref.assign_argmax(x, c)
    if not torch.allclose(gs, ws, rtol=ASSIGN_TOL, atol=ASSIGN_TOL):
        fail(f"assign_argmax {what}: scores differ beyond {ASSIGN_TOL}")
    diff = gi != wi
    near = 0
    if diff.any():
        cb = c if c.dim() == 3 else c[None]
        xb = x if x.dim() == 3 else x[None]
        gib = gi if gi.dim() == 2 else gi[None]
        own = (torch.einsum("mnh,mnh->mn", xb,
                            torch.gather(cb, 1, gib.long()[..., None].expand(
                                -1, -1, cb.shape[2])))
               - 0.5 * torch.gather((cb * cb).sum(-1), 1, gib.long()))
        gap = (own.reshape(ws.shape) - ws).abs()[diff]
        if (gap > ASSIGN_TOL + ASSIGN_TOL * ws.abs()[diff]).any():
            fail(f"assign_argmax {what}: ids differ beyond near-ties")
        near = int(diff.sum())
    if ties and bool((gi >= (c.shape[-2] + 1) // 2).any()):
        fail(f"assign_argmax {what}: a constructed tie went to the higher "
             f"index")
    return float((gs - ws).abs().max()), near


def assign_parity(dev, seed: int, emb, centroids) -> float:
    """Phase 11b: ``assign_argmax`` at ragged N and L, h 8 / 40 / 768,
    the batched PQ axis, constructed ties, and the build's full width on
    65,536 corpus points against phase 10's centroids."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    err, near, n_cases = 0.0, {}, 0
    for n in ASSIGN_SIZES:
        for l in ASSIGN_SIZES:
            h = (8, 40, 768)[n_cases % 3]
            x = torch.randn((n, h), generator=gen, device=dev)
            c = torch.randn((l, h), generator=gen, device=dev)
            e, nt = check_assign(x, c, f"n={n} l={l} h={h}")
            err, near[f"{n}x{l}x{h}"] = max(err, e), nt
            n_cases += 1
    big = ASSIGN_SIZES[-1]
    for m, n, l, h in ((PQ_M, big, PQ_K, HIDDEN // PQ_M),
                       (1, big, big, HIDDEN)):
        x = torch.randn((n, m, h), generator=gen, device=dev).transpose(0, 1)
        half = torch.randn((m, (l + 1) // 2, h), generator=gen, device=dev)
        c = torch.cat([half, half], dim=1)[:, :l].contiguous()
        e, nt = check_assign(x, c, f"ties m={m} n={n} l={l} h={h}",
                             ties=True)
        err, near[f"ties {m}x{n}x{l}x{h}"] = max(err, e), nt
    e, nt = check_assign(emb[:ASSIGN_BLOCK], centroids, "build width")
    err, near[f"build width {ASSIGN_BLOCK}x{centroids.shape[0]}"] = (
        max(err, e), nt)
    log(f"[assign] {n_cases} ragged cases + 2 tie cases + build width: max "
        f"abs score err {err:.3g} (tol {ASSIGN_TOL}); ids differing at "
        f"near-ties (plain scores within {ASSIGN_TOL}): "
        f"{ {k: v for k, v in near.items() if v} }")
    return err


def sup_params(rng: np.random.Generator, centroids: np.ndarray) -> dict:
    """DistillParams leaves in the reference's layout: the term-scorer
    encoder and MLP drawn at the init scales of ``layers.dense_init``
    (N(0, 1/d_in)), ``embedding_init`` (N(0, 0.02²)) and
    ``term_selector.init_mlp``; the cluster embeddings given."""
    d, f, L = HIDDEN, 4 * HIDDEN, ENC_LAYERS

    def normal(shape, scale):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(scale))

    leaves = {
        ".cluster_embeddings": centroids,
        ".term_mlp.w1": normal((d, d), d ** -0.5),
        ".term_mlp.b1": np.zeros(d, np.float32),
        ".term_mlp.w2": normal((d, 1), d ** -0.5),
        ".term_mlp.b2": np.zeros(1, np.float32),
        ".encoder['embed']['table']": normal((VOCAB, d), 0.02),
        ".encoder['final_norm']['scale']": np.ones(d, np.float32),
        ".encoder['unembed']['w']": normal((d, VOCAB), d ** -0.5),
        ".encoder['layers']['attn_norm']['scale']": np.ones((L, d),
                                                            np.float32),
        ".encoder['layers']['mlp_norm']['scale']": np.ones((L, d),
                                                           np.float32),
        ".encoder['layers']['mlp']['w_gate']['w']": normal((L, d, f),
                                                           d ** -0.5),
        ".encoder['layers']['mlp']['w_up']['w']": normal((L, d, f),
                                                         d ** -0.5),
        ".encoder['layers']['mlp']['w_down']['w']": normal((L, f, d),
                                                           f ** -0.5),
    }
    for w in ("wq", "wk", "wv", "wo"):
        leaves[f".encoder['layers']['attn']['{w}']['w']"] = normal(
            (L, d, d), d ** -0.5)
    return leaves


def check_sup_scores(sel, params, enc_cfg, tokens) -> None:
    """The first N_SUP_CHECK documents' position scores against the CPU
    plain path, and their top-K₁ᵀ term lists, equal except documents
    whose CPU scores hold a near-tie within SUP_TOL (listed)."""
    first = sel.position_scores(tokens[:ENCODE_BATCH])[:N_SUP_CHECK].cpu()
    cpu_tokens = tokens[:N_SUP_CHECK].cpu()
    t0 = time.perf_counter()
    cpu = train.SupSelectors(params, enc_cfg, encode_batch=N_SUP_CHECK,
                             device="cpu").position_scores(cpu_tokens)
    cpu_s = time.perf_counter() - t0
    if not torch.allclose(first, cpu, rtol=SUP_TOL, atol=SUP_TOL):
        fail(f"HI²_sup position scores differ from the CPU beyond "
             f"{SUP_TOL} (max {float((first - cpu).abs().max()):.3g})")
    ids, _ = ts_mod.doc_terms(cpu_tokens, first, K1_TERMS)
    wids, wsc = ts_mod.doc_terms(cpu_tokens, cpu, K1_TERMS + 1)
    gaps = (wsc[:, :-1] - wsc[:, 1:]).abs()
    near = torch.nonzero((gaps <= SUP_TOL).any(dim=1)).flatten().tolist()
    same = (ids == wids[:, :K1_TERMS]).all(dim=1)
    bad = [d for d in torch.nonzero(~same).flatten().tolist()
           if d not in near]
    if bad:
        fail(f"HI²_sup term lists differ from the CPU on docs {bad[:10]}")
    log(f"[sup] {N_SUP_CHECK} docs: position scores match the CPU plain "
        f"path (max abs err {float((first - cpu).abs().max()):.3g}, tol "
        f"{SUP_TOL}; CPU encoder {cpu_s:.1f} s); term lists equal except "
        f"near-tie docs {near} (of which differing: "
        f"{[d for d in near if not bool(same[d])]})")


def sup_path(dev, seed: int, built: dict) -> tuple[dict, dict]:
    """Phase 12: the HI²_sup indexing path at the paper's BERT slot over
    phase 10's corpus and cluster embeddings.  Returns (the counted
    run's launches, what phase 13 times: one chunk's q, k, v)."""
    with phase("12a sup: parameters"):
        enc_cfg = tfm.TransformerConfig(
            n_layers=ENC_LAYERS, d_model=HIDDEN, n_heads=ENC_HEADS,
            n_kv_heads=ENC_HEADS, d_ff=4 * HIDDEN, vocab_size=VOCAB,
            causal=False, compute_dtype=torch.float32, remat=False)
        leaves = sup_params(np.random.default_rng(seed),
                            built["cluster_sel"].embeddings.cpu().numpy())
        n_params = sum(a.size for p, a in leaves.items()
                       if p.startswith(".encoder"))
        params = ckpt.distill_params_from_numpy(leaves, enc_cfg, device=dev)
        del leaves
        sel = train.SupSelectors(params, enc_cfg, encode_batch=ENCODE_BATCH,
                                 device=dev)
        log(f"[sup] encoder {ENC_LAYERS} layers x d {HIDDEN}, {ENC_HEADS} "
            f"heads, d_ff {4 * HIDDEN}, V {VOCAB}: {n_params / 1e6:.1f} M "
            f"parameters")
    with phase("12b sup: scores against the CPU"):
        check_sup_scores(sel, params, enc_cfg, built["tokens"])
    corpus = built["corpus"]
    with phase("12c sup: build_sup_index (counted)"):
        timings = {}
        reset_counts()
        index = train.build_sup_index(
            types.SimpleNamespace(doc_emb=built["emb"],
                                  doc_tokens=built["tokens"],
                                  vocab_size=VOCAB),
            params, enc_cfg, built["doc_assign"], k1_terms=K1_TERMS,
            codec=REFINE_CODEC, cluster_capacity=CLUSTER_CAP,
            term_capacity=TERM_CAP, encode_batch=ENCODE_BATCH, device=dev,
            timings=timings)
        torch.cuda.synchronize()
        launches = read_counts()
        chunks = -(-BUILD_DOCS // ENCODE_BATCH)
        n_tokens = BUILD_DOCS * corpus.doc_tokens.shape[1]
        log(f"[sup] build_sup_index stage seconds: "
            + ", ".join(f"{k} {v:.2f}" for k, v in timings.items())
            + f"; launches {launches}; the encoder over {n_tokens} tokens: "
            f"{n_tokens / timings['position_scores'] / 1e6:.2f} M tokens/s")
        want = {"flash_attention": ENC_LAYERS * chunks, "assign_argmax": 0}
        for kname, n in want.items():
            if launches[kname] != n:
                fail(f"HI²_sup build launched {kname} {launches[kname]} "
                     f"times, expected {n}")
    with phase("12d sup: serving"):
        qe, qt = corpus.query_emb, corpus.query_tokens
        _, results, serve_launches = serve_batches(
            index, dev, qe, qt, BUILD_QUERIES // BATCH,
            ("sq8_dot_fused", "topk_scores"), f"HI²_sup {REFINE_CODEC}")
        ids = torch.cat([r.doc_ids for r in results]).cpu()
        r100 = metrics.recall_at_k(ids, corpus.qrels, 100)
        m10 = metrics.mrr_at_k(ids, corpus.qrels, 10)
        log(f"[sup] HI²_sup {REFINE_CODEC}: R@100 {r100:.4f}, MRR@10 "
            f"{m10:.4f} beside phase 10's HI²_unsup {REFINE_CODEC}: R@100 "
            f"{built['recall']:.4f}, MRR@10 {built['mrr']:.4f} (random "
            f"encoder: this checks the path, not quality)")
    with phase("12e sup: check against the CPU"):
        qe0 = torch.from_numpy(qe[:BATCH]).to(dev)
        qt0 = torch.from_numpy(qt[:BATCH]).to(dev).long()
        inp = main_path_inputs(index, qe0, qt0)
        check_cpu(index.to("cpu"), qe[:N_CHECK], qt[:N_CHECK], inp,
                  results[0], SQ8_TOL)
    gen = torch.Generator(device=dev).manual_seed(seed)
    s_len = corpus.doc_tokens.shape[1]
    d_head = HIDDEN // ENC_HEADS
    shapes = dict(q=_bshd(gen, dev, ENCODE_BATCH, s_len, ENC_HEADS, d_head,
                          torch.float32))
    shapes["k"], shapes["v"] = (_bshd(gen, dev, ENCODE_BATCH, s_len,
                                      ENC_HEADS, d_head, torch.float32)
                                for _ in range(2))
    return launches, shapes


def time_new_kernels(flash_in: dict, emb, centroids) -> dict:
    """Phase 13: ``flash_attention`` at one encoder chunk's shape and
    ``assign_argmax`` at the build's KMeans and PQ shapes: kernel, plain
    and library times beside each bound.  The plain versions and the
    library's assignment build an (n, L) plane, so they run in blocks of
    ASSIGN_BLOCK points (the whole plane at N = 1,048,576 is 42 GB)."""
    timer = Timer()
    q, k, v = flash_in["q"], flash_in["k"], flash_in["v"]
    b, hq, s_len, d = q.shape
    fa_flops = 4.0 * b * hq * s_len * s_len * d
    fa_bytes = 4.0 * (4 * b * hq * s_len * d + b * hq * s_len)
    fa_bound = bound(fa_flops, fa_bytes)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flash = dict(
        ms=timer.ms(lambda: fa_ops.flash_attention(q, k, v, False, 0),
                    reps=10),
        plain_ms=timer.ms(lambda: fa_ref.flash_attention(q, k, v, False, 0),
                          reps=5),
        library_ms=timer.ms(lambda: sdpa(q, k, v), reps=10),
        bound_ms=fa_bound[0], bound_by=fa_bound[1])
    log(f"[times] flash_attention at B={b}, H={hq}, S={s_len}, d={d} f32 "
        f"(one encoder chunk): {fa_flops / 1e9:.1f} GFLOP, "
        f"{fa_bytes / 1e9:.2f} GB; kernel {flash['ms']:.3f} ms, plain "
        f"{flash['plain_ms']:.3f} ms, library (scaled_dot_product_attention)"
        f" {flash['library_ms']:.3f} ms, bound {fa_bound[0]:.3f} ms "
        f"({fa_bound[1]})")
    gen = torch.Generator(device=q.device).manual_seed(1)
    lq, lk, lv = llama_qkv(gen, q.device)
    lb, ls, lhq, lhkv, ld = LLAMA_ATTN
    l_bound = bound(4.0 * lb * lhq * ls * ls * ld / 2,    # causal: half
                    2.0 * lb * ls * ld * (2 * lhq + 2 * lhkv))
    l_ms = timer.ms(lambda: fa_ops.flash_attention(lq, lk, lv, True, 0),
                    reps=10)
    l_lib = timer.ms(lambda: sdpa(lq, lk, lv, is_causal=True,
                                  enable_gqa=True), reps=10)
    log(f"[times] flash_attention at llama3-8b's shape {LLAMA_ATTN} (B, S, "
        f"Hq, Hkv, d; bf16, causal): kernel {l_ms:.3f} ms, library "
        f"{l_lib:.3f} ms, bound at the fp32 FMA rate {l_bound[0]:.3f} ms "
        f"({l_bound[1]}; the kernel widens bf16 to fp32 FMAs)")

    def blocked(fn, x, c):
        def run():
            for i in range(0, x.shape[-2], ASSIGN_BLOCK):
                fn(x[..., i:i + ASSIGN_BLOCK, :], c)
        return run

    def library(xb, c):
        return torch.argmax(xb @ c.transpose(-1, -2)
                            - 0.5 * (c * c).sum(-1)[..., None, :], dim=-1)

    n, h = emb.shape
    l = centroids.shape[0]
    as_flops = 2.0 * n * l * h
    as_bytes = 4.0 * (n * h + l * h + 2 * n)
    as_bound = bound(as_flops, as_bytes)
    assign = dict(
        ms=timer.ms(lambda: at_ops.assign_argmax(emb, centroids), reps=3,
                    warm=1),
        plain_ms=timer.ms(blocked(at_ref.assign_argmax, emb, centroids),
                          reps=2, warm=1),
        library_ms=timer.ms(blocked(library, emb, centroids), reps=2,
                            warm=1),
        bound_ms=as_bound[0], bound_by=as_bound[1])
    log(f"[times] assign_argmax at the KMeans shape N={n}, L={l}, h={h}: "
        f"{as_flops / 1e12:.2f} TFLOP; kernel {assign['ms']:.1f} ms, plain "
        f"{assign['plain_ms']:.1f} ms, library (torch.argmax(x @ c.T - "
        f"½‖c‖²) in {ASSIGN_BLOCK}-point blocks) {assign['library_ms']:.1f} "
        f"ms, bound {as_bound[0]:.1f} ms ({as_bound[1]})")
    m, dsub = PQ_M, h // PQ_M
    frags = emb.reshape(n, m, dsub).transpose(0, 1)
    gen = torch.Generator(device=emb.device).manual_seed(2)
    cw = torch.randn((m, PQ_K, dsub), generator=gen, device=emb.device)
    pq_bound = bound(2.0 * m * n * PQ_K * dsub,
                     4.0 * (n * h + m * PQ_K * dsub + 2 * m * n))
    pq_ms = timer.ms(lambda: at_ops.assign_argmax(frags, cw), reps=5)
    pq_lib = timer.ms(blocked(library, frags, cw), reps=3, warm=1)
    log(f"[times] assign_argmax at the PQ shape m={m}, N={n}, k={PQ_K}, "
        f"d_sub={dsub} (strided view): kernel {pq_ms:.1f} ms, library "
        f"(blocked) {pq_lib:.1f} ms, bound {pq_bound[0]:.2f} ms "
        f"({pq_bound[1]})")
    return {"flash_attention": flash, "assign_argmax": assign}


SOURCES = {   # kernel → (CUDA source, the TPU kernel's pallas_call)
    "pq_adc_fused": ("src/repro_torch/kernels/pq_adc/csrc/pq_adc_fused.cu",
                     "src/repro/kernels/pq_adc/kernel.py:163"),
    "topk_scores": ("src/repro_torch/kernels/assign_topk/csrc/"
                    "topk_scores.cu",
                    "src/repro/kernels/assign_topk/kernel.py:124"),
    "sq8_dot_fused": ("src/repro_torch/kernels/sq8_dot/csrc/"
                      "sq8_dot_fused.cu",
                      "src/repro/kernels/sq8_dot/kernel.py:79"),
    "assign_argmax": ("src/repro_torch/kernels/assign_topk/csrc/"
                      "assign_argmax.cu",
                      "src/repro/kernels/assign_topk/kernel.py:156"),
    "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/"
                        "flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:117"),
}


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------

def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=4,
                    help="256-query batches served in each counted run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs an NVIDIA card")
    t_start = time.perf_counter()
    with phase("1 card"):
        name = card()
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    with phase("2 build kernels"):
        build_kernels()

    with phase("3 index (opq)"):
        rng = np.random.default_rng(args.seed)
        leaves = synth_leaves(rng)
        qe_all, qt_all = synth_queries(rng, BATCH * args.batches)
        qrels = plant_positives(leaves, qe_all)
        index = ckpt.index_from_numpy(leaves, "opq", device=dev)
        torch.cuda.synchronize()
        log(f"[index] {sum(a.nbytes for a in leaves.values()) / 1e9:.3f} "
            f"GB on the card; budget {hi.candidate_budget(index, KC, K2)} "
            f"slots/query")
    with phase("4 parity"):
        errs = parity_edges(dev, np.random.default_rng(args.seed + 1))
        qe0 = torch.from_numpy(qe_all[:BATCH]).to(dev)
        qt0 = torch.from_numpy(qt_all[:BATCH]).to(dev).long()
        inp = main_path_inputs(index, qe0, qt0)
        parity_full_width(inp, errs)
    with phase("5 serving (opq)"):
        server, results, opq_launches = serve_batches(
            index, dev, qe_all, qt_all, args.batches,
            ("pq_adc_fused", "topk_scores"), "serve_msmarco (opq)")
        check_planted(results, qrels, "opq")
    with phase("6 check (opq)"):
        check_cpu(ckpt.index_from_numpy(leaves, "opq", device="cpu"),
                  qe_all[:N_CHECK], qt_all[:N_CHECK], inp, results[0],
                  ADC_TOL)
    with phase("7 times (opq)"):
        times = time_kernels(inp)
    with phase("8 profile (opq)"):
        profile_batch(server, qe_all[:BATCH], qt_all[:BATCH])
    del server, results, leaves, inp

    with phase("9a refine index (refine:sq8:4)"):
        rindex, rqrels = refine_index(index, dev, args.seed, qe_all)
        del index
        torch.cuda.synchronize()
        log(f"[refine] codes {tuple(rindex.doc_planes['codes'].shape)} "
            f"uint8 + refine_emb fp16: "
            f"{sum(p.nbytes for p in rindex.doc_planes.values()) / 1e9:.2f}"
            f" GB on the card; candidate cost "
            f"{hi.candidate_cost(rindex, KC, K2, TOP_R)}")
    with phase("9b parity (sq8_dot_fused, full width)"):
        rinp = main_path_inputs(rindex, qe0, qt0)
        parity_full_width_sq8(rinp, errs)
    with phase("9c serving (refine:sq8:4)"):
        server, results, refine_launches = serve_batches(
            rindex, dev, qe_all, qt_all, args.batches,
            ("sq8_dot_fused", "topk_scores"),
            "serve_msmarco_refine_sq8 (refine:sq8:4)")
        check_planted(results, rqrels, REFINE_CODEC)
    with phase("9d check (refine:sq8:4)"):
        cpu_index = rindex.to("cpu")
        check_cpu(cpu_index, qe_all[:N_CHECK], qt_all[:N_CHECK], rinp,
                  results[0], SQ8_TOL)
        del cpu_index
    with phase("9e times (sq8_dot_fused)"):
        times.update(time_sq8(rinp))
    with phase("9f profile (refine:sq8:4)"):
        profile_batch(server, qe_all[:BATCH], qt_all[:BATCH])
    del server, results, rindex, rinp
    torch.cuda.empty_cache()

    with phase("10 build on the card"):
        built = build_on_card(dev, args.seed)
    with phase("11a parity (flash_attention)"):
        errs["flash_attention"] = flash_parity(dev, args.seed + 2)
    with phase("11b parity (assign_argmax)"):
        errs["assign_argmax"] = assign_parity(
            dev, args.seed + 3, built["emb"], built["cluster_sel"].embeddings)
    with phase("12 HI²_sup path"):
        sup_launches, flash_in = sup_path(dev, args.seed, built)
    with phase("13 times (flash_attention, assign_argmax)"):
        times.update(time_new_kernels(flash_in, built["emb"],
                                      built["cluster_sel"].embeddings))

    launches = dict(opq_launches,
                    sq8_dot_fused=refine_launches["sq8_dot_fused"],
                    assign_argmax=built["assign_launches"],
                    flash_attention=sup_launches["flash_attention"])
    kernels = [dict(name=k, route="cuda", source=SOURCES[k][0],
                    replaces=SOURCES[k][1], launches=launches[k],
                    max_abs_err=errs[k], **times[k])
               for k in SOURCES]
    log(f"[seconds] total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

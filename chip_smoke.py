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
              ``--seed``, with a (V, Ct) f32 BM25 impact plane, and
              moved to the card;
  4. parity   each kernel against its plain PyTorch version on the
              card at edge shapes (for ``topk_scores`` also h = 37 and a
              view one element off 16-byte alignment, which take its
              element-wise copies), and the two kernels of the ``opq``
              path at its full width;
  5. serving  ``Server(ServeConfig(kc=30, k2=32, top_r=100,
              max_batch=256))`` answers ``--batches`` batches of 256
              queries with every launch count reset just before; each
              kernel of the path must have launched, and each query must
              rank first the positive planted for it (recall@1 = 1);
  5b. unfused ``pq_adc`` over phase 4's candidates gathered into
              (B, C, m) codes, uint8 and int32: against its plain
              version, bitwise equal to ``pq_adc_fused`` on live lanes,
              and timed beside its bound;
  6. check    the first 8 queries against the same search on the CPU
              (the plain path) over the same planes;
  7. times    each kernel, its plain version and the library yardstick
              with CUDA events, beside the kernel's bound (and, for
              ``topk_scores``, its share of that bound);
  8. profile  device time by kernel over one served batch
              (torch.profiler) and the device's busy share;
  8b-d. fused the same server with ``fusion_weight=0.5`` (hybrid
              dense∥sparse, DESIGN.md §13) answers ``--batches`` batches;
              weight 1.0 ids bitwise equal to phase 5's, weight 0.0
              equal to a host BM25 oracle, weight 0.5 against the CPU
              plain path on 8 queries; one profiled fused batch;
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
              launch ``assign_argmax`` the expected number of times.
              The ``opq`` build carries the BM25 impact plane of its
              corpus (``sparse=True``) and is also served fused;
 11a. flash   ``flash_attention`` against its plain version at edge cases
              (f32 / bf16, d 16-128, causal, windows, GQA, ragged and
              fully-masked rows, strided inputs; out and lse), inputs one
              element off 16-byte alignment (the element-wise load
              instance), 828 items (more than one wave of resident
              blocks, ragged in Sq), one full encoder chunk in f32, and
              llama3-8b's attention shape;
 11b. assign  ``assign_argmax`` against its plain version at ragged N / L,
              h 8 / 40 / 768, h 37 and a misaligned view (the 4-byte
              copies), PQ's strided views at d_sub 4 / 8 / 12 (the narrow
              instances), the batched PQ axis, constructed ties, and the
              build's full width on 65,536 corpus points, printing the
              largest absolute and relative score errors;
 12. sup      the HI²_sup indexing path: the term-scorer encoder at the
              paper's BERT slot (768-d, 12 heads, 2 layers, V = 30,528;
              random weights from ``--seed`` carried across in the
              reference's leaf layout) and phase 10's cluster embeddings;
              position scores of 1,024 docs against the CPU plain path;
              ``build_sup_index(codec="refine:sq8:4")`` over all N as a
              counted run (one ``flash_attention`` launch per layer per
              4,096-doc chunk); 4 x 256 queries served and 8 checked
              against the CPU; R@100 / MRR@10 beside phase 10's;
 13. times    ``flash_attention`` (at the encoder chunk's and llama3-8b's
              shapes, with its share of the bound; at llama3-8b against
              both its own fp32 FMA path and the card's bf16 tensor-core
              peak) and ``assign_argmax`` at the build's KMeans and PQ
              shapes, beside their bounds, plain versions and library
              yardsticks;
 14. bench    the port's ``kernel_bench`` at its full shapes with
              ``--check`` semantics, as a counted run; its report is
              printed as a JSON line;
 15. mutable  the mutable index (DESIGN.md §8) over phase 10's corpus at
              full widths: a base over its first 983,040 documents and a
              65,536-slot delta (28-slot delta lists), the last 65,536
              streamed in at fills 0.25, 0.5 and 1.0.  15a ``opq`` with
              the impact plane: serves 4 x 256 queries dense and fused at
              fill 0 and after each ``add_docs`` (each a counted run:
              ``topk_scores`` once a batch, ``pq_adc_fused`` twice, base
              and delta; each ``add_docs`` one ``assign_argmax``); deletes
              the top 10 of the last dense batch and a quarter of the
              streamed ids, which no later result may hold; 8 queries
              against the CPU plain path over the same base, delta and
              tombstones; a profiled dense and fused batch; ``compact()``
              against ``hi.build`` over the survivors with the same seed,
              leaf for leaf and on the first batch bit for bit.  15b
              ``refine:sq8:4``: the same stream, deletes and CPU check
              (``sq8_dot_fused`` twice a batch, the two-family refine);

then prints the ``kernels`` JSON line and, last, the ``ok`` line.  Each
kernel's ``launches`` is read from the counted run of the path that runs
it: ``pq_adc_fused`` and ``topk_scores`` from phase 5, ``sq8_dot_fused``
from 9c, ``assign_argmax`` from phase 10's builds, ``flash_attention``
from phase 12, ``pq_adc`` from phase 14; phase 15's counted runs are
checked in the phase and printed.  It imports only the port, never jax
or the reference package, and exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import sys
import time
import types

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.benchmarks import kernel_bench  # noqa: E402
from repro_torch.benchmarks.synth_msmarco import (  # noqa: E402
    BATCH, CLUSTER_CAP, HIDDEN, K1_TERMS, K2, KC, N_CLUSTERS, N_DOCS, PQ_K,
    PQ_M, QUERY_LEN, REFINE_CODEC, SMOKE_BATCHES, TERM_CAP, TOP_R, VOCAB,
    main_path_inputs, planted_docs, refine_index, synth_leaves,
    synth_queries)
from repro_torch.benchmarks.timing import Timer  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.core import exec as qexec  # noqa: E402
from repro_torch.core import hybrid_index as hi  # noqa: E402
from repro_torch.core import inverted_lists  # noqa: E402
from repro_torch.core import metrics  # noqa: E402
from repro_torch.core import segments  # noqa: E402
from repro_torch.core import term_selector as ts_mod  # noqa: E402
from repro_torch.core.codecs import flat as flat_codec  # noqa: E402
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
# the mutable index (phase 15): a base over the first MUT_BASE documents
# of phase 10's corpus, the last MUT_STREAM streamed in at MUT_FILLS of
# the delta; its lists then hold 4·⌈65,536/10,000⌉ = 28 cluster and
# 4·⌈65,536·3/30,528⌉ = 28 term slots (the reference's default formula)
MUT_STREAM = 65_536
MUT_BASE = BUILD_DOCS - MUT_STREAM
MUT_FILLS = (0.25, 0.5, 1.0)
MUT_DELTA_CAP = 28
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
PEAK_BF16_FLOPS = 989e12             # bf16 on the tensor cores, dense
PEAK_BYTES = 3.35e12                 # HBM3

ADC_TOL = 1e-4                       # rtol = atol: m-reduction order
TOPK_TOL = 1e-5                      # rtol = atol: dot-product order
SQ8_EDGE_RTOL, SQ8_EDGE_ATOL = 1e-4, 1e-2   # the JAX kernel test's own
SQ8_TOL = 1e-4                       # rtol = atol after the bias
N_CHECK = 8                          # queries held against the CPU path
FUSION_WEIGHT = 0.5                  # the fused serving phases' RRF weight

#: kernel → (its wrapper module, the name of its launch count there)
COUNTERS = {"pq_adc_fused": (adc_ops, "launches"),
            "pq_adc": (adc_ops, "unfused_launches"),
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
# phase 3: the synthetic serve_msmarco index (its leaves, queries and the
# phase-9 planes are synth_msmarco's, shared with kernel_variants.py)
# --------------------------------------------------------------------------

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

    topk_cases = [  # (name, n, l, h, k, duplicated centroid rows,
        #                elements off 16-byte alignment)
        ("ties", 33, 300, 32, 12, True, 0),
        ("small", 5, 37, 16, 4, False, 0),
        ("k_equals_l", 3, 2, 16, 2, True, 0),
        ("ragged_tiles", 17, 129, 40, 8, True, 0),
        ("k_max", 2, 10_000, 768, at_ops.MAX_K, False, 0),
        # the element-wise copies: h % 4 != 0, and x off alignment
        ("h37_elementwise", 40, 1000, 37, 30, False, 0),
        ("misaligned_view", 64, 3000, 768, 30, False, 1),
    ]
    for cname, n, l, h, k, ties, offset in topk_cases:
        x = prng.normal(size=(n, h))
        x = (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(
            np.float32)
        emb = prng.normal(size=(l, h)).astype(np.float32)
        if ties:
            emb = np.concatenate([emb[: (l + 1) // 2]] * 2)[:l]
        x, emb = _cases_to(dev, np.concatenate(
            [np.zeros(offset, np.float32), x.ravel()]), emb)
        x = x[offset:].view(n, h)
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
    unfused_cases = [  # (name, b, c, m, k, code dtype, unaligned view)
        ("c_one", 2, 1, 96, 256, np.uint8, False),
        ("m_one", 3, 700, 1, 64, np.uint8, False),
        ("odd_k", 2, 999, 12, 77, np.int32, False),
        ("c_ragged_i32", 2, 8192 + 300, 96, 256, np.int32, False),
        ("unaligned_view", 2, 500, 96, 256, np.uint8, True),
    ]
    for cname, b, c, m, k, dtype, unaligned in unfused_cases:
        lut, flat = _cases_to(dev, prng.normal(size=(b, m, k)).astype(
            np.float32), prng.integers(0, k, b * c * m + 3).astype(dtype))
        codes = (flat[3:] if unaligned else flat[:-3]).view(b, c, m)
        got, want = adc_ops.pq_adc(lut, codes), adc_ref.pq_adc(lut, codes)
        errs["pq_adc"] = max(errs["pq_adc"], check_masked(
            got, want, ADC_TOL, ADC_TOL, "pq_adc", cname))
    log(f"[parity] edge shapes: pq_adc_fused {len(adc_cases) + 1} cases, "
        f"pq_adc {len(unfused_cases)} cases, topk_scores {len(topk_cases)} "
        f"cases, sq8_dot_fused {len(sq8_cases) + 1} cases")
    return errs


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
                  what: str, fusion_weight=None):
    """A counted main-path run: every launch count is set to 0 just
    before the batches and read just after; each kernel in ``kernels``
    must have launched.  ``fusion_weight`` serves hybrid search.
    Returns (server, results, launches)."""
    server = serve.Server(index, serve.ServeConfig(
        kc=KC, k2=K2, top_r=TOP_R, max_batch=BATCH,
        fusion_weight=fusion_weight), device=dev)
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
    log(f"[serving] {what}: mean unique live candidates {mean_cand:.0f} "
        f"({'dense + sparse matches; ' if fusion_weight is not None else ''}"
        f"{hi.candidate_budget(index, KC, K2)} dense slots)")
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


def bm25_oracle(leaves: dict, term_ids: np.ndarray) -> np.ndarray:
    """Pure sparse top-R on the host: each query's stored impacts summed
    per document over its probed term lists in probed order (float32 adds
    in slot order, as the fixed-shape path adds them), ranked by (score
    desc, id asc), zero-score documents excluded."""
    entries, weights = leaves[".term_lists.entries"], leaves[".sparse_weights"]
    out = np.full((len(term_ids), TOP_R), inverted_lists.PAD_DOC, np.int64)
    for b, row in enumerate(term_ids):
        ids = entries[row[row >= 0]].reshape(-1)
        w = weights[row[row >= 0]].reshape(-1)
        acc = np.zeros(N_DOCS, np.float32)
        np.add.at(acc, ids[ids >= 0], w[ids >= 0])
        live = np.flatnonzero(acc > 0.0)
        order = live[np.lexsort((live, -acc[live]))][:TOP_R]
        out[b, :order.size] = order
    return out


def check_fused(server, cpu_index, leaves, qe_all, qt_all, dense) -> None:
    """Phase 8c: the fused server's three contracts.  Weight 1.0: every
    batch's ids bitwise equal to phase 5's dense-only results.  Weight
    0.0: the first N_CHECK queries' ids equal to the host BM25 oracle.
    Weight FUSION_WEIGHT against the CPU plain path on N_CHECK queries:
    the sparse top-R and its count bitwise equal to the CPU's, the fused
    top-R bitwise equal to the CPU's fusion of the card's dense and
    sparse lists (the dense half is held to the CPU by phase 6), and
    every query whose dense ids equal the CPU's dense ids has the CPU's
    fused result exactly (the others, dense near-ties, are listed)."""
    server.set_fusion(1.0)
    for i, want in enumerate(dense):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        if not torch.equal(server.query(qe_all[sl], qt_all[sl]).doc_ids,
                           want.doc_ids):
            fail(f"fused weight 1.0 batch {i}: ids differ from dense-only")
    qe8, qt8 = qe_all[:N_CHECK], qt_all[:N_CHECK]
    term_ids = ts_mod.query_terms(cpu_index.term_sel,
                                  torch.from_numpy(qt8).long(), K2)
    server.set_fusion(0.0)
    got0 = server.query(qe8, qt8).doc_ids.cpu().numpy()
    t0 = time.perf_counter()
    oracle = bm25_oracle(leaves, term_ids.numpy())
    oracle_s = time.perf_counter() - t0
    if not np.array_equal(got0, oracle):
        fail("fused weight 0.0 differs from the BM25 oracle on queries "
             f"{np.flatnonzero((got0 != oracle).any(axis=1)).tolist()}")
    server.set_fusion(FUSION_WEIGHT)
    fus = qexec.FusionSpec(weight=FUSION_WEIGHT)
    got = server.query(qe8, qt8)
    dev = server.device
    with torch.inference_mode():
        _, dev_terms = qexec.dispatch(
            server.index.cluster_sel, server.index.term_sel,
            torch.from_numpy(qe8).to(dev), torch.from_numpy(qt8).to(dev)
            .long(), KC, K2)
        card_sp = qexec.sparse_topk([hi.base_source(server.index)],
                                    dev_terms, TOP_R, None)
        cpu_sp = qexec.sparse_topk([hi.base_source(cpu_index)], term_ids,
                                   TOP_R, None)
    if not torch.equal(dev_terms.cpu(), term_ids):
        fail("fused: dispatched term ids differ from the CPU's")
    for g, w, what in zip(card_sp, cpu_sp, ("scores", "ids", "counts")):
        if not torch.equal(g.cpu(), w):
            fail(f"fused: sparse top-R {what} differ from the CPU's")
    d_ids = dense[0].doc_ids[:N_CHECK].cpu()
    d_s = torch.where(d_ids >= 0, dense[0].scores[:N_CHECK].cpu(),
                      -torch.inf)
    want_s, want_ids = qexec.fuse(d_s, d_ids, *cpu_sp[:2], fus, TOP_R)
    valid = torch.isfinite(want_s)
    if not (torch.equal(got.doc_ids.cpu(), torch.where(
            valid, want_ids, inverted_lists.PAD_DOC).int())
            and torch.equal(got.scores.cpu(),
                            torch.where(valid, want_s, 0.0))):
        fail("fused: top-R differs from the CPU fusion of the card's lists")
    if not torch.equal(got.n_candidates.cpu(),
                       dense[0].n_candidates[:N_CHECK].cpu() + cpu_sp[2]):
        fail("fused: n_candidates is not dense + sparse matches")
    t0 = time.perf_counter()
    cpu = hi.search(cpu_index, qe8, qt8, kc=KC, k2=K2, top_r=TOP_R,
                    fusion=fus, device="cpu")
    cpu_dense = hi.search(cpu_index, qe8, qt8, kc=KC, k2=K2, top_r=TOP_R,
                          device="cpu")
    cpu_s = time.perf_counter() - t0
    near = []
    for b in range(N_CHECK):
        if not torch.equal(d_ids[b], cpu_dense.doc_ids[b]):
            near.append(b)
            continue
        if not (torch.equal(got.doc_ids[b].cpu(), cpu.doc_ids[b])
                and torch.equal(got.scores[b].cpu(), cpu.scores[b])
                and int(got.n_candidates[b]) == int(cpu.n_candidates[b])):
            fail(f"fused query {b}: differs from the CPU plain path")
    log(f"[fused] weight 1.0: {len(dense)} batches bitwise equal to "
        f"dense-only; weight 0.0: {N_CHECK} queries equal to the BM25 "
        f"oracle (host oracle {oracle_s:.1f} s); weight {FUSION_WEIGHT}: "
        f"sparse top-R bitwise equal to the CPU's, fusion of the card's "
        f"lists bitwise equal to the CPU's, {N_CHECK - len(near)} of "
        f"{N_CHECK} queries equal to the CPU plain path (CPU searches "
        f"{cpu_s:.1f} s); dense near-tie queries checked through the "
        f"decomposition only: {near}; mean sparse matches "
        f"{float(cpu_sp[2].float().mean()):.0f} of {K2 * TERM_CAP} slots")


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
    topk = dict(
        ms=timer.ms(lambda: at_ops.topk_scores(x, emb, KC), reps=20),
        plain_ms=timer.ms(lambda: at_ref.topk_scores(x, emb, KC), reps=20),
        library_ms=timer.ms(lambda: torch.topk(x @ emb.T, KC), reps=20),
        bound_ms=topk_bound[0], bound_by=topk_bound[1])
    topk["bound_share"] = topk_bound[0] / topk["ms"]
    log(f"[times] topk_scores: kernel {topk['ms']:.4f} ms, plain "
        f"{topk['plain_ms']:.4f} ms, library {topk['library_ms']:.4f} ms, "
        f"bound {topk_bound[0]:.4f} ms ({topk_bound[1]}), bound / kernel "
        f"{topk['bound_share']:.1%}")
    _, plan = adc_ops.choose(_build.library("pq_adc_fused"), lut, plane)
    grid = adc_ops.grid_size(b * c, plan)
    staged = adc_ops.lut_stagings(b, c, grid) * lut[0].numel() * 4
    adc = dict(
        ms=timer.ms(lambda: adc_ops.pq_adc_fused(lut, plane, rows, live),
                    reps=10),
        plain_ms=timer.ms(plain_adc, reps=3, warm=1), library_ms=None,
        bound_ms=adc_bound[0], bound_by=adc_bound[1])
    adc["bound_share"] = adc_bound[0] / adc["ms"]
    log(f"[times] pq_adc_fused: kernel {adc['ms']:.4f} ms, plain "
        f"{adc['plain_ms']:.4f} ms, bound {adc_bound[0]:.4f} ms "
        f"({adc_bound[1]}), bound / kernel {adc['bound_share']:.1%}; "
        f"{adc_ops.INSTANCES[plan.instance]} instance, {grid} blocks "
        f"staging {staged / 1e6:.1f} MB of LUTs (a copy per 8,192 slots "
        f"would stage {b * -(-c // 8192) * lut[0].numel() * 4 / 1e6:.1f} "
        f"MB)")
    return {"pq_adc_fused": adc, "topk_scores": topk}


def time_sq8(inp: dict) -> dict:
    """Phase 9e: ``sq8_dot_fused`` and its plain version at the refine
    path's shapes, beside its bound for this run's data (each distinct
    live row read once) and the traffic of reading each live lane's row,
    as the per-lane kernel before the grouped one did.  No one PyTorch
    call computes a gathered dot, so library_ms is null."""
    timer = Timer()
    q_scaled, plane, rows, live = (inp[k] for k in ("q_scaled", "plane",
                                                    "rows", "live"))
    b, c = rows.shape
    h = plane.shape[1]
    live_rows = torch.unique(rows[live]).numel()
    n_live = int(live.sum())
    fixed = b * c * (4 + 1 + 4) + q_scaled.numel() * 4
    nbytes = fixed + live_rows * h
    per_lane = fixed + n_live * h
    sq8_bound = bound(2 * n_live * h, nbytes)
    tl = sq8_ops.tiles(_build.library("sq8_dot_fused"))
    skey, _ = sq8_ops.schedule(rows, live, plane.shape[0], tl.tile_slots)
    groups = int(sq8_ops.lead_flags(skey, tl.group_max).sum())

    def plain():              # in 16-query chunks: it builds (B, C, h)
        for s in range(0, b, 16):
            sq8_ref.sq8_dot_fused(q_scaled[s:s + 16], plane,
                                  rows[s:s + 16], live[s:s + 16])

    log(f"[times] sq8_dot_fused at B={b}, C={c}, h={h}: {n_live} live "
        f"slots over {live_rows} distinct rows, {nbytes / 1e6:.1f} MB to "
        f"move, {2 * n_live * h / 1e9:.2f} GFLOP; each live lane reading "
        f"its row would move {per_lane / 1e6:.1f} MB "
        f"({1e3 * per_lane / PEAK_BYTES:.3f} ms at {PEAK_BYTES / 1e12} "
        f"TB/s); {skey.numel()} items of {tl.tile_slots} slots in {groups} "
        f"groups of at most {tl.group_max} (mean "
        f"{skey.numel() / groups:.2f}); library_ms null (no one PyTorch "
        f"call computes a gathered dot)")
    out = dict(
        ms=timer.ms(lambda: sq8_ops.sq8_dot_fused(q_scaled, plane, rows,
                                                  live), reps=10),
        plain_ms=timer.ms(plain, reps=3, warm=1), library_ms=None,
        bound_ms=sq8_bound[0], bound_by=sq8_bound[1])
    out["bound_share"] = sq8_bound[0] / out["ms"]
    log(f"[times] sq8_dot_fused: kernel {out['ms']:.4f} ms, plain "
        f"{out['plain_ms']:.4f} ms, bound {sq8_bound[0]:.4f} ms "
        f"({sq8_bound[1]}), bound / kernel {out['bound_share']:.1%}")
    return {"sq8_dot_fused": out}


def unfused_at_width(inp: dict, errs: dict) -> dict:
    """Phase 5b: ``pq_adc`` over the opq path's candidates gathered into a
    (B, C, m) codes tensor, as uint8 and as int32: within ADC_TOL of the
    plain version on N_CHECK queries, bitwise equal to ``pq_adc_fused``
    on every live lane of the full batch, and timed beside its bound
    (the bytes of the codes read once, the LUT, the scores written).
    No one PyTorch call computes a LUT gather-sum, so library_ms is
    null."""
    timer = Timer()
    lut, plane, rows, live = (inp[k] for k in ("lut", "plane", "rows",
                                                "live"))
    b, c = rows.shape
    fused = adc_ops.pq_adc_fused(lut, plane, rows, live)
    q = slice(0, N_CHECK)
    out, gb = {}, {}
    for name, dtype in (("u8", torch.uint8), ("i32", torch.int32)):
        codes = plane[rows.long()].to(dtype)
        got = adc_ops.pq_adc(lut, codes)
        if not torch.equal(got[live], fused[live]):
            n_diff = int((got[live] != fused[live]).sum())
            fail(f"pq_adc ({name} codes) differs from pq_adc_fused on "
                 f"{n_diff} live lanes")
        errs["pq_adc"] = max(errs["pq_adc"], check_masked(
            got[q], adc_ref.pq_adc(lut[q], codes[q]), ADC_TOL, ADC_TOL,
            "pq_adc", f"full width {name}"))
        nbytes = codes.numel() * codes.element_size() + lut.numel() * 4 \
            + b * c * 4
        gb[name] = nbytes / 1e9
        t_bound = bound(b * c * PQ_M, nbytes)

        def plain(codes=codes):       # in 32-query chunks: it gathers
            for s in range(0, b, 32):  # (B, C, m) int64 indices
                adc_ref.pq_adc(lut[s:s + 32], codes[s:s + 32])

        out[name] = dict(
            ms=timer.ms(lambda codes=codes: adc_ops.pq_adc(lut, codes),
                        reps=10),
            plain_ms=timer.ms(plain, reps=3, warm=1), library_ms=None,
            bound_ms=t_bound[0], bound_by=t_bound[1])
        out[name]["bound_share"] = t_bound[0] / out[name]["ms"]
        del codes, got
    fused_ms = timer.ms(lambda: adc_ops.pq_adc_fused(lut, plane, rows, live),
                        reps=10)
    log(f"[times] pq_adc at B={b}, C={c}, m={PQ_M}, k={PQ_K}: uint8 codes "
        f"{gb['u8']:.3f} GB to move: kernel {out['u8']['ms']:.3f} ms, plain "
        f"{out['u8']['plain_ms']:.3f} ms, bound {out['u8']['bound_ms']:.3f} "
        f"ms ({out['u8']['bound_by']}), bound / kernel "
        f"{out['u8']['bound_share']:.1%}; int32 codes {gb['i32']:.3f} GB: "
        f"kernel {out['i32']['ms']:.3f} ms, plain "
        f"{out['i32']['plain_ms']:.3f} ms, bound {out['i32']['bound_ms']:.3f}"
        f" ms, bound / kernel {out['i32']['bound_share']:.1%}; "
        f"pq_adc_fused on the same slots {fused_ms:.3f} ms; "
        f"bitwise equal to pq_adc_fused on all {int(live.sum())} live lanes "
        f"(uint8 and int32); max abs err vs plain {errs['pq_adc']:.3g} "
        f"(tol {ADC_TOL})")
    return {"pq_adc": out["u8"]}


def build_on_card(dev, seed: int) -> dict:
    """Phase 10: the port's build on the card at N = BUILD_DOCS (full
    widths), three codecs over one KMeans, each served and scored.  Each
    build is a counted run that must launch ``assign_argmax`` exactly
    BUILD_ASSIGN_LAUNCHES times.  The ``opq`` build carries the BM25
    impact plane (``sparse=True``) and is served fused too.  Returns what phase 12 reuses: the
    corpus, its planes on the card, the KMeans selector and φ(D), the
    ``refine:sq8:4`` quality and each build's ``assign_argmax``
    launches."""
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
    recall, mrr, base, assign_launches = {}, {}, None, {}
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
                             timings=timings, sparse=spec == "opq",
                             **reuse)
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
            assign_launches[spec] = launches["assign_argmax"]
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
        if index.sparse_weights is not None:
            with phase(f"build: serve {spec} fused"):
                _, results, launches = serve_batches(
                    index, dev, qe, qt, BUILD_QUERIES // BATCH,
                    kernels[spec], f"built {spec} fused (weight "
                    f"{FUSION_WEIGHT})", fusion_weight=FUSION_WEIGHT)
                ids = torch.cat([r.doc_ids for r in results]).cpu()
                log(f"[build] {spec} on real BM25 impacts "
                    f"{tuple(index.sparse_weights.shape)}: dense-only R@100 "
                    f"{recall[spec]:.4f}, MRR@10 {mrr[spec]:.4f}; fused at "
                    f"weight {FUSION_WEIGHT} R@100 "
                    f"{metrics.recall_at_k(ids, corpus.qrels, 100):.4f}, "
                    f"MRR@10 {metrics.mrr_at_k(ids, corpus.qrels, 10):.4f}")
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

def _bshd(gen, dev, b, s, h, d, dtype, offset: int = 0):
    """A (B, H, S, d) view of (B, S, H, d) memory, as the attention
    layer's projections hand the kernel, starting ``offset`` elements
    into its storage (1: not 16-byte aligned)."""
    n = b * s * h * d
    flat = torch.randn(n + offset, generator=gen, device=dev).to(dtype)
    return flat[offset:].view(b, s, h, d).transpose(1, 2)


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
    # the element-wise load instance: every input one element off 16 bytes
    for dtype in (torch.float32, torch.bfloat16):
        q = _bshd(gen, dev, 2, 100, 4, 64, dtype, offset=1)
        k, v = (_bshd(gen, dev, 2, 90, 2, 64, dtype, offset=1)
                for _ in range(2))
        if fa_ops.vector_loads(q, k, v):
            fail("flash_attention: the misaligned case is 16-byte aligned")
        err[dtype] = max(err[dtype], check_flash(
            q, k, v, True, 0, f"{dtype} misaligned view"))
    # 23 x 12 x 3 = 828 items, more than the 132 x 4 blocks resident at
    # once, with a ragged last q tile
    q, k, v = (_bshd(gen, dev, 23, 130, ENC_HEADS, 64, torch.float32)
               for _ in range(3))
    err[torch.float32] = max(err[torch.float32], check_flash(
        q, k, v, False, 0, "828 items (more than one wave)"))
    # full size: one HI²_sup encoder chunk in f32
    d_head = HIDDEN // ENC_HEADS
    q, k, v = (_bshd(gen, dev, ENCODE_BATCH, 64, ENC_HEADS, d_head,
                     torch.float32) for _ in range(3))
    err[torch.float32] = max(err[torch.float32], check_flash(
        q, k, v, False, 0, f"encoder chunk ({ENCODE_BATCH}, {ENC_HEADS}, "
        f"64, {d_head}) f32"))
    del q, k, v
    # full size: llama3-8b's attention, one batch
    q, k, v = llama_qkv(gen, dev)
    err[torch.bfloat16] = max(err[torch.bfloat16], check_flash(
        q, k, v, True, 0, f"llama3-8b {LLAMA_ATTN} bf16 causal"))
    log(f"[flash] {n_cases} edge cases + 2 dead-row cases ({n_dead} dead "
        f"rows) + 2 misaligned views + 828 items + the encoder "
        f"chunk + llama3-8b full size: max abs out err f32 "
        f"{err[torch.float32]:.3g} (tol {FLASH_TOL[torch.float32]}), bf16 "
        f"{err[torch.bfloat16]:.3g} (tol {FLASH_TOL[torch.bfloat16]}); lse "
        f"within {LSE_TOL}")
    return max(err.values())


def check_assign(x, c, what: str, ties: bool = False
                 ) -> tuple[float, float, int]:
    """Kernel against the plain version: scores within ASSIGN_TOL; ids
    identical except where the plain scores of the two ids lie within
    ASSIGN_TOL (listed by count); on constructed ties (every centroid j
    of the upper half a copy of j - half) the lower twin always wins.
    Returns (max abs and max relative score error, near-tie rows)."""
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
    err = (gs - ws).abs()
    return (float(err.max()), float((err / ws.abs().clamp_min(1e-30)).max()),
            near)


def assign_parity(dev, seed: int, emb, centroids) -> float:
    """Phase 11b: ``assign_argmax`` at ragged N and L, h 8 / 40 / 768,
    h 37 and a view one element off 16-byte alignment (the 4-byte
    copies), PQ's strided (m, n, d_sub) views at d_sub 4 / 8 / 12 (the
    narrow instances), the batched PQ axis, constructed ties, and the
    build's full width on 65,536 corpus points against phase 10's
    centroids."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    err, rel, near, n_cases = 0.0, 0.0, {}, 0

    def held(key, x, c, ties=False):
        nonlocal err, rel
        e, r, near[key] = check_assign(x, c, key, ties)
        err, rel = max(err, e), max(rel, r)

    for n in ASSIGN_SIZES:
        for l in ASSIGN_SIZES:
            h = (8, 40, 768)[n_cases % 3]
            held(f"{n}x{l}x{h}", torch.randn((n, h), generator=gen,
                                            device=dev),
                 torch.randn((l, h), generator=gen, device=dev))
            n_cases += 1
    big = ASSIGN_SIZES[-1]
    held("h37", torch.randn((1000, 37), generator=gen, device=dev),
         torch.randn((300, 37), generator=gen, device=dev))
    flat = torch.randn(777 * HIDDEN + 1, generator=gen, device=dev)
    held("misaligned view", flat[1:].view(777, HIDDEN),
         torch.randn((500, HIDDEN), generator=gen, device=dev))
    for dsub in (4, 8, 12):
        m = HIDDEN // dsub
        held(f"pq view d_sub {dsub}",
             torch.randn((big, HIDDEN), generator=gen, device=dev).view(
                 big, m, dsub).transpose(0, 1),
             torch.randn((m, PQ_K, dsub), generator=gen, device=dev))
    for m, n, l, h in ((PQ_M, big, PQ_K, HIDDEN // PQ_M),
                       (1, big, big, HIDDEN)):
        x = torch.randn((n, m, h), generator=gen, device=dev).transpose(0, 1)
        half = torch.randn((m, (l + 1) // 2, h), generator=gen, device=dev)
        c = torch.cat([half, half], dim=1)[:, :l].contiguous()
        held(f"ties {m}x{n}x{l}x{h}", x, c, ties=True)
    held(f"build width {ASSIGN_BLOCK}x{centroids.shape[0]}",
         emb[:ASSIGN_BLOCK], centroids)
    log(f"[assign] {n_cases} ragged cases + h 37 + misaligned view + 3 PQ "
        f"views + 2 tie cases + build width: max abs score err {err:.3g}, "
        f"max relative {rel:.3g} (allclose with rtol = atol = "
        f"{ASSIGN_TOL}); ids differing at near-ties (plain scores within "
        f"{ASSIGN_TOL}): { {k: v for k, v in near.items() if v} }")
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
    and library times beside each bound (the PQ shape's under the
    ``assign_argmax`` entry's ``pq_shape``).  The plain versions and the
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
    flash["bound_share"] = fa_bound[0] / flash["ms"]
    log(f"[times] flash_attention at B={b}, H={hq}, S={s_len}, d={d} f32 "
        f"(one encoder chunk): {fa_flops / 1e9:.1f} GFLOP, "
        f"{fa_bytes / 1e9:.2f} GB; kernel {flash['ms']:.3f} ms, plain "
        f"{flash['plain_ms']:.3f} ms, library (scaled_dot_product_attention)"
        f" {flash['library_ms']:.3f} ms, bound {fa_bound[0]:.3f} ms "
        f"({fa_bound[1]}), bound / kernel {flash['bound_share']:.1%}")
    gen = torch.Generator(device=q.device).manual_seed(1)
    lq, lk, lv = llama_qkv(gen, q.device)
    lb, ls, lhq, lhkv, ld = LLAMA_ATTN
    l_flops = 4.0 * lb * lhq * ls * ls * ld / 2           # causal: half
    l_bytes = 2.0 * lb * ls * ld * (2 * lhq + 2 * lhkv)
    l_bound = bound(l_flops, l_bytes)
    l_card = max(l_flops / PEAK_BF16_FLOPS, l_bytes / PEAK_BYTES) * 1e3
    l_ms = timer.ms(lambda: fa_ops.flash_attention(lq, lk, lv, True, 0),
                    reps=10)
    l_lib = timer.ms(lambda: sdpa(lq, lk, lv, is_causal=True,
                                  enable_gqa=True), reps=10)
    log(f"[times] flash_attention at llama3-8b's shape {LLAMA_ATTN} (B, S, "
        f"Hq, Hkv, d; bf16, causal): kernel {l_ms:.3f} ms, library "
        f"{l_lib:.3f} ms, bound at the fp32 FMA rate {l_bound[0]:.3f} ms "
        f"({l_bound[1]}; the kernel widens bf16 to fp32 FMAs), bound / "
        f"kernel {l_bound[0] / l_ms:.1%} against that fp32 path; against the "
        f"card's bf16 tensor-core peak the bound is {l_card:.3f} ms, "
        f"{l_card / l_ms:.1%} of the kernel")

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
    assign["pq_shape"] = pq = dict(
        ms=timer.ms(lambda: at_ops.assign_argmax(frags, cw), reps=5),
        plain_ms=timer.ms(blocked(at_ref.assign_argmax, frags, cw), reps=2,
                          warm=1),
        library_ms=timer.ms(blocked(library, frags, cw), reps=3, warm=1),
        bound_ms=pq_bound[0], bound_by=pq_bound[1])
    log(f"[times] assign_argmax at the PQ shape m={m}, N={n}, k={PQ_K}, "
        f"d_sub={dsub} (strided view): kernel {pq['ms']:.2f} ms, plain "
        f"{pq['plain_ms']:.2f} ms, library (blocked) {pq['library_ms']:.2f}"
        f" ms, bound {pq_bound[0]:.2f} ms ({pq_bound[1]})")
    return {"flash_attention": flash, "assign_argmax": assign}


# --------------------------------------------------------------------------
# phase 15: the mutable index (base + delta segment + tombstones)
# --------------------------------------------------------------------------

def serve_mutable(mut, dev, qe_all, qt_all, batches: int, score_kernel: str,
                  what: str, fusion_weight=None):
    """A counted run over a MutableServer: every count set to 0 just
    before the batches and read just after; ``topk_scores`` must launch
    once a batch and ``score_kernel`` twice (the base and the delta
    source).  Returns (server, results, launches, q/s)."""
    server = serve.make_mutable_server(mut, serve.ServeConfig(
        kc=KC, k2=K2, top_r=TOP_R, max_batch=BATCH, mutable=True,
        fusion_weight=fusion_weight), device=dev)
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
    qps = server.n_served / sum(batch_s)
    log(f"[mutable] {what}: {server.n_served} queries in {sum(batch_s):.3f}"
        f" s ({qps:.1f} q/s; batch ms {[round(s * 1e3, 2) for s in batch_s]}"
        f"); launches {launches}")
    want = {"topk_scores": batches, score_kernel: 2 * batches}
    for kname, n in want.items():
        if launches[kname] != n:
            fail(f"{what}: {kname} launched {launches[kname]} times, "
                 f"expected {n}")
    for res in results:
        if res.doc_ids.shape != (BATCH, TOP_R):
            fail(f"{what}: result shape {tuple(res.doc_ids.shape)}")
        if not torch.isfinite(res.scores).all():
            fail(f"{what}: non-finite result scores")
    return server, results, launches, qps


def mutable_on_cpu(mut):
    """The same base, delta planes, eviction scores and tombstones as a
    mutable index on the CPU (the plain path)."""
    tree = dict(mut.state_tree(), base=mut.base.to("cpu"))
    return segments.MutableHybridIndex.from_state(tree, mut.state_extra(),
                                                  seed=mut.seed)


def check_mutable_cpu(mut, qe8, qt8, first, tol: float, what: str) -> None:
    """The first N_CHECK queries of a served batch against the CPU plain
    path over the same base, delta and tombstones: n_candidates exact,
    top-R within ``tol`` (phase 6's rule).  A query whose K^C-th and
    next cluster scores lie within TOPK_TOL may dispatch other clusters:
    it is listed, not checked."""
    t0 = time.perf_counter()
    cpu = mutable_on_cpu(mut)
    ref = cpu.search(qe8, qt8, kc=KC, k2=K2, top_r=TOP_R)
    cpu_s = time.perf_counter() - t0
    full = torch.from_numpy(qe8) @ cpu.base.cluster_sel.embeddings.T
    top = torch.sort(full, dim=-1, descending=True).values[:, : KC + 1]
    boundary = (top[:, KC - 1] - top[:, KC]) <= TOPK_TOL
    skipped = [b for b in range(N_CHECK) if bool(boundary[b])]
    for b in range(N_CHECK):
        if b in skipped:
            continue
        if int(first.n_candidates[b]) != int(ref.n_candidates[b]):
            fail(f"{what} query {b}: n_candidates differs from the CPU")
        if not topk_match(ref.doc_ids[b].numpy(), ref.scores[b].numpy(),
                          first.doc_ids[b].cpu().numpy(),
                          first.scores[b].cpu().numpy(), tol):
            fail(f"{what} query {b}: top-R differs from the CPU path")
    log(f"[mutable] {what}: {N_CHECK - len(skipped)} of {N_CHECK} queries "
        f"match the CPU plain path over the same base, delta and "
        f"tombstones (state copied and searched on the CPU in {cpu_s:.1f} "
        f"s); near-ties at the K^C boundary, skipped: {skipped}")


def mutable_stream(mut, dev, corpus, batches: int, score_kernel: str,
                   spec: str, fused: bool) -> tuple:
    """Stream the corpus's last MUT_STREAM documents in MUT_FILLS steps,
    each ``add_docs`` a counted run (one ``assign_argmax`` launch: the
    codec encode, for ``opq``), serving dense (and fused) batches before
    the first step and after each.  Returns (the streamed ids, the last
    dense batch's results)."""
    qe, qt = corpus.query_emb, corpus.query_tokens
    stream_emb = corpus.doc_emb[MUT_BASE:MUT_BASE + MUT_STREAM]
    stream_tok = corpus.doc_tokens[MUT_BASE:MUT_BASE + MUT_STREAM]
    added, done, last = [], 0, None
    want_assign = 1 if spec == "opq" else 0
    for frac in (0.0,) + MUT_FILLS:
        upto = int(frac * MUT_STREAM)
        if upto > done:
            timings = {}
            reset_counts()
            t0 = time.perf_counter()
            added.append(mut.add_docs(stream_emb[done:upto],
                                      stream_tok[done:upto],
                                      timings=timings))
            add_s = time.perf_counter() - t0
            launches = read_counts()
            log(f"[mutable] {spec} add_docs of {upto - done} docs: "
                f"{add_s:.2f} s (device part {timings['device']:.2f} s, "
                f"host list inserts {timings['inserts']:.2f} s); "
                f"launches {launches}; dropped postings so far "
                f"{mut.dropped_postings}")
            if launches["assign_argmax"] != want_assign:
                fail(f"{spec} add_docs launched assign_argmax "
                     f"{launches['assign_argmax']} times, expected "
                     f"{want_assign}")
            done = upto
        modes = ((None, "dense"), (FUSION_WEIGHT, "fused")) if fused else (
            (None, "dense"),)
        for weight, name in modes:
            _, results, _, qps = serve_mutable(
                mut, dev, qe, qt, batches, score_kernel,
                f"{spec} fill {frac} {name}", fusion_weight=weight)
            ids = torch.cat([r.doc_ids for r in results]).cpu()
            log(f"[mutable] {spec} fill {frac} ({mut.delta_count} delta "
                f"docs) {name}: R@100 "
                f"{metrics.recall_at_k(ids, corpus.qrels[:len(ids)], 100):.4f}"
                f", {qps:.1f} q/s")
            if weight is None:
                last = results
    return np.concatenate(added), last


def mutable_delete(mut, dev, corpus, batches: int, score_kernel: str,
                   spec: str, added, last, fused: bool):
    """Delete every id in the top 10 of the last dense batch (base and
    delta alike) plus a quarter of the streamed ids, then serve again:
    no deleted id may appear in any result.  Returns the first dense
    batch after the deletes."""
    top10 = last[-1].doc_ids[:, :10].cpu().numpy().ravel()
    doomed = np.unique(np.concatenate([top10[top10 >= 0],
                                       added[: MUT_STREAM // 4]]))
    t0 = time.perf_counter()
    mut.delete_docs(doomed)
    log(f"[mutable] {spec} delete_docs of {doomed.size} ids "
        f"({int((doomed < mut.n_base).sum())} base, "
        f"{int((doomed >= mut.n_base).sum())} delta): "
        f"{time.perf_counter() - t0:.3f} s; tombstone ratio "
        f"{mut.tombstone_ratio:.4f}")
    qe, qt = corpus.query_emb, corpus.query_tokens
    first = None
    for weight in ((None, FUSION_WEIGHT) if fused else (None,)):
        _, results, _, _ = serve_mutable(
            mut, dev, qe, qt, batches, score_kernel,
            f"{spec} after deletes {'dense' if weight is None else 'fused'}",
            fusion_weight=weight)
        ids = torch.cat([r.doc_ids for r in results]).cpu().numpy()
        if np.isin(ids, doomed).any():
            fail(f"{spec}: a deleted id appeared in a result")
        first = results[0] if first is None else first
    log(f"[mutable] {spec}: no deleted id in any result")
    return first


def mutable_phase(dev, built: dict, seed: int, batches: int) -> None:
    """Phase 15: the mutable index on the card at full widths over phase
    10's corpus: 15a ``opq`` with the impact plane (create, stream, serve
    dense and fused at each fill, delete, check against the CPU,
    compact against a rebuild), 15b ``refine:sq8:4`` (create, stream,
    delete, check against the CPU)."""
    corpus = built["corpus"]
    kw = dict(n_clusters=N_CLUSTERS, k1_terms=K1_TERMS, pq_m=PQ_M,
              pq_k=PQ_K, cluster_capacity=CLUSTER_CAP,
              term_capacity=TERM_CAP, kmeans_iters=BUILD_ITERS)
    for spec, kernel, fused in (("opq", "pq_adc_fused", True),
                                (REFINE_CODEC, "sq8_dot_fused", False)):
        tag = "15a" if spec == "opq" else "15b"
        with phase(f"{tag} mutable {spec}: create"):
            mut = segments.MutableHybridIndex.create(
                seed, corpus.doc_emb[:MUT_BASE],
                corpus.doc_tokens[:MUT_BASE], VOCAB,
                delta_capacity=MUT_STREAM, codec=spec, sparse=fused,
                device=dev, **kw)
            caps = (mut.delta_cluster_capacity, mut.delta_term_capacity)
            log(f"[mutable] {spec}: base {mut.n_base} docs, delta "
                f"{MUT_STREAM} slots, delta list capacities {caps}; "
                f"candidate budget {mut.candidate_budget(KC, K2)} slots "
                f"({hi.candidate_budget(mut.base, KC, K2)} in the base)")
            if caps != (MUT_DELTA_CAP, MUT_DELTA_CAP):
                fail(f"{spec}: delta capacities {caps}, expected "
                     f"{MUT_DELTA_CAP}")
        with phase(f"{tag} mutable {spec}: stream and serve (counted)"):
            added, last = mutable_stream(mut, dev, corpus, batches, kernel,
                                         spec, fused)
        with phase(f"{tag} mutable {spec}: delete and serve"):
            first = mutable_delete(mut, dev, corpus, batches, kernel, spec,
                                   added, last, fused)
        if fused:
            with phase(f"{tag} mutable {spec}: profile"):
                for weight in (None, FUSION_WEIGHT):
                    server = serve.make_mutable_server(
                        mut, serve.ServeConfig(
                            kc=KC, k2=K2, top_r=TOP_R, max_batch=BATCH,
                            mutable=True, fusion_weight=weight), device=dev)
                    log(f"[mutable] profiled batch, fusion weight {weight}")
                    profile_batch(server, corpus.query_emb[:BATCH],
                                  corpus.query_tokens[:BATCH])
        with phase(f"{tag} mutable {spec}: check against the CPU"):
            check_mutable_cpu(mut, corpus.query_emb[:N_CHECK],
                              corpus.query_tokens[:N_CHECK], first,
                              ADC_TOL if spec == "opq" else SQ8_TOL, spec)
        if spec == "opq":
            compact_vs_rebuild(mut, dev, corpus, kw)
        del mut
        torch.cuda.empty_cache()


def compact_vs_rebuild(mut, dev, corpus, kw: dict) -> None:
    """15a: ``compact()`` and a fresh ``hi.build`` over
    ``surviving_corpus()`` with the same seed agree bit for bit, leaf for
    leaf and in ids, scores and n_candidates on the first batch."""
    with phase("15a mutable opq: compact"):
        t0 = time.perf_counter()
        compacted = mut.compact()
        torch.cuda.synchronize()
        log(f"[mutable] compact to {compacted.n_base} docs: "
            f"{time.perf_counter() - t0:.2f} s")
    with phase("15a mutable opq: rebuild and compare"):
        emb, tok = mut.surviving_corpus()
        t0 = time.perf_counter()
        rebuilt = hi.build(mut.seed, emb, tok, VOCAB, codec="opq",
                           sparse=True, device=dev, **kw)
        torch.cuda.synchronize()
        log(f"[mutable] hi.build over the {emb.shape[0]} survivors: "
            f"{time.perf_counter() - t0:.2f} s")
        la, lb = hi.index_leaves(compacted.base), hi.index_leaves(rebuilt)
        if [p for p, _ in la] != [p for p, _ in lb]:
            fail("compact: leaf paths differ from the rebuild's")
        differ = [p for (p, x), (_, y) in zip(la, lb)
                  if x.dtype != y.dtype or not torch.equal(x, y)]
        if differ:
            fail(f"compact: leaves differ from the rebuild: {differ}")
        qe = corpus.query_emb[:BATCH]
        qt = corpus.query_tokens[:BATCH]
        a = compacted.search(qe, qt, kc=KC, k2=K2, top_r=TOP_R)
        b = hi.search(rebuilt, qe, qt, kc=KC, k2=K2, top_r=TOP_R,
                      device=dev)
        for name, x, y in (("ids", a.doc_ids, b.doc_ids),
                           ("scores", a.scores, b.scores),
                           ("n_candidates", a.n_candidates,
                            b.n_candidates)):
            if not torch.equal(x, y):
                fail(f"compact: {name} of the first batch differ from the "
                     f"rebuild's")
        old_to_new = np.full(mut.n_docs, -2, np.int64)
        old_to_new[mut.survivors()] = np.arange(compacted.n_base)
        all_qe, all_qt = corpus.query_emb, corpus.query_tokens
        ids = torch.cat([compacted.search(all_qe[i:i + BATCH],
                                          all_qt[i:i + BATCH], kc=KC, k2=K2,
                                          top_r=TOP_R).doc_ids.cpu()
                         for i in range(0, len(all_qe), BATCH)])
        log(f"[mutable] compact equals the rebuild: {len(la)} of {len(la)} "
            f"leaves bit for bit; first batch ids, scores and n_candidates "
            f"equal; compacted R@100 "
            f"{metrics.recall_at_k(ids, old_to_new[corpus.qrels], 100):.4f}")


def run_kernel_bench() -> dict:
    """Phase 14: the port's ``kernel_bench`` at its full shapes with
    ``--check`` semantics, as a counted run: the main path of ``pq_adc``
    (its unfused section), which must launch every kernel it compares.
    Returns the launches."""
    reset_counts()
    report = kernel_bench.run(kernel_bench.parse_args(["--check"]))
    torch.cuda.synchronize()
    launches = read_counts()
    log(json.dumps(report, sort_keys=True))
    log(f"[kernel_bench] launches {launches}")
    if report["backend"] != "cuda" or report["interpret_mode"]:
        fail("kernel_bench did not run the kernels on the card")
    if report["check_failures"]:
        fail(f"kernel_bench: {report['check_failures']}")
    missing = [k for k in ("pq_adc", "pq_adc_fused", "sq8_dot_fused",
                           "topk_scores") if launches[k] < 1]
    if missing:
        fail(f"kernel_bench never launched {missing}")
    return launches


SOURCES = {   # kernel → (CUDA source, the TPU kernel's pallas_call)
    "pq_adc_fused": ("src/repro_torch/kernels/pq_adc/csrc/pq_adc_fused.cu",
                     "src/repro/kernels/pq_adc/kernel.py:163"),
    "pq_adc": ("src/repro_torch/kernels/pq_adc/csrc/pq_adc.cu",
               "src/repro/kernels/pq_adc/kernel.py:58"),
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
    ap.add_argument("--batches", type=int, default=SMOKE_BATCHES,
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
    with phase("5b pq_adc (unfused) at full width"):
        times = unfused_at_width(inp, errs)
    with phase("6 check (opq)"):
        cpu_index = ckpt.index_from_numpy(leaves, "opq", device="cpu")
        check_cpu(cpu_index, qe_all[:N_CHECK], qt_all[:N_CHECK], inp,
                  results[0], ADC_TOL)
    with phase("7 times (opq)"):
        times.update(time_kernels(inp))
    with phase("8 profile (opq)"):
        profile_batch(server, qe_all[:BATCH], qt_all[:BATCH])
    with phase(f"8b serving (opq, fused at {FUSION_WEIGHT})"):
        fserver, _, _ = serve_batches(
            index, dev, qe_all, qt_all, args.batches,
            ("pq_adc_fused", "topk_scores"),
            f"serve_msmarco fused (opq, weight {FUSION_WEIGHT})",
            fusion_weight=FUSION_WEIGHT)
    with phase("8c check (fused)"):
        check_fused(fserver, cpu_index, leaves, qe_all, qt_all, results)
    with phase("8d profile (fused)"):
        fserver.set_fusion(FUSION_WEIGHT)
        profile_batch(fserver, qe_all[:BATCH], qt_all[:BATCH])
    del server, fserver, results, leaves, inp, cpu_index

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
    with phase("14 kernel_bench (counted)"):
        bench_launches = run_kernel_bench()
    with phase("15 mutable index"):
        mutable_phase(dev, built, args.seed, BUILD_QUERIES // BATCH)

    launches = dict(opq_launches,
                    sq8_dot_fused=refine_launches["sq8_dot_fused"],
                    assign_argmax=sum(built["assign_launches"].values()),
                    flash_attention=sup_launches["flash_attention"],
                    pq_adc=bench_launches["pq_adc"])
    # the PQ shape's launches: the opq build's (OPQ training and encode)
    times["assign_argmax"]["pq_shape"]["launches"] = (
        built["assign_launches"]["opq"])
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

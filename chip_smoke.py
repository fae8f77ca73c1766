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
              ``refine:sq8:4`` must stay within 0.01 R@100 of ``flat``;

then prints the ``kernels`` JSON line and, last, the ``ok`` line.  It
imports only the port, never jax or the reference package, and exits
non-zero without a card.
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

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.core import exec as qexec  # noqa: E402
from repro_torch.core import hybrid_index as hi  # noqa: E402
from repro_torch.core import inverted_lists  # noqa: E402
from repro_torch.core import metrics  # noqa: E402
from repro_torch.core.codecs import flat as flat_codec  # noqa: E402
from repro_torch.core.codecs import pq as pq_codec  # noqa: E402
from repro_torch.core.codecs import sq8 as sq8_codec  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.assign_topk import ops as at_ops  # noqa: E402
from repro_torch.kernels.assign_topk import ref as at_ref  # noqa: E402
from repro_torch.kernels.pq_adc import ops as adc_ops  # noqa: E402
from repro_torch.kernels.pq_adc import ref as adc_ref  # noqa: E402
from repro_torch.kernels.sq8_dot import ops as sq8_ops  # noqa: E402
from repro_torch.kernels.sq8_dot import ref as sq8_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

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

# H100 SXM published peaks (NVIDIA H100 datasheet)
PEAK_FP32_FLOPS = 67e12              # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12                 # HBM3

ADC_TOL = 1e-4                       # rtol = atol: m-reduction order
TOPK_TOL = 1e-5                      # rtol = atol: dot-product order
SQ8_EDGE_RTOL, SQ8_EDGE_ATOL = 1e-4, 1e-2   # the JAX kernel test's own
SQ8_TOL = 1e-4                       # rtol = atol after the bias
N_CHECK = 8                          # queries held against the CPU path

#: kernel → its wrapper module (each holds the ``launches`` count)
COUNTERS = {"pq_adc_fused": adc_ops, "topk_scores": at_ops,
            "sq8_dot_fused": sq8_ops}


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
    for mod in COUNTERS.values():
        mod.launches = 0


def read_counts() -> dict:
    return {k: mod.launches for k, mod in COUNTERS.items()}


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
    over the same planes; near-tie queries are listed, not checked."""
    t0 = time.perf_counter()
    ref = hi.search(cpu_index, qe8, qt8, kc=KC, k2=K2, top_r=TOP_R,
                    device="cpu")
    cpu_s = time.perf_counter() - t0
    full = torch.from_numpy(qe8) @ cpu_index.cluster_sel.embeddings.T
    top = torch.sort(full, dim=-1, descending=True).values[:, : KC + 1]
    near_tie = ((top[:, :-1] - top[:, 1:]) <= TOPK_TOL).any(dim=1)
    with torch.inference_mode():
        cpu_cl, cpu_tm = qexec.dispatch(
            cpu_index.cluster_sel, cpu_index.term_sel,
            torch.from_numpy(qe8), torch.from_numpy(qt8).long(), KC, K2)
        cpu_cands = qexec.gather([hi.base_source(cpu_index)], cpu_cl,
                                 cpu_tm).cands
    skipped = []
    for b in range(N_CHECK):
        if bool(near_tie[b]):
            skipped.append(b)
            continue
        if not torch.equal(inp["cl_ids"][b].cpu(), cpu_cl[b]):
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
        f"near-tie queries skipped: {skipped}")


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


def build_on_card(dev, seed: int) -> None:
    """Phase 10: the port's build on the card at N = BUILD_DOCS (full
    widths), three codecs over one KMeans, each served and scored."""
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
    recall, base = {}, None
    for spec in (REFINE_CODEC, "opq", "flat"):
        with phase(f"build: {spec} index"):
            timings = {}
            reuse = ({} if base is None else
                     dict(cluster_sel=base.cluster_sel,
                          doc_assign=base.doc_assign))
            index = hi.build(seed, emb, tokens, VOCAB, n_clusters=N_CLUSTERS,
                             k1_terms=K1_TERMS, codec=spec, pq_m=PQ_M,
                             pq_k=PQ_K, cluster_capacity=CLUSTER_CAP,
                             term_capacity=TERM_CAP,
                             kmeans_iters=BUILD_ITERS, device=dev,
                             timings=timings, **reuse)
            log(f"[build] {spec} stage seconds: "
                + ", ".join(f"{k} {v:.2f}" for k, v in timings.items()))
        with phase(f"build: serve {spec}"):
            _, results, launches = serve_batches(
                index, dev, qe, qt, BUILD_QUERIES // BATCH, kernels[spec],
                f"built {spec}")
            ids = torch.cat([r.doc_ids for r in results]).cpu()
            recall[spec] = metrics.recall_at_k(ids, corpus.qrels, 100)
            log(f"[build] {spec}: R@100 {recall[spec]:.4f}, MRR@10 "
                f"{metrics.mrr_at_k(ids, corpus.qrels, 10):.4f}, candidate "
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


SOURCES = {   # kernel → (CUDA source, the TPU kernel's pallas_call)
    "pq_adc_fused": ("src/repro_torch/kernels/pq_adc/csrc/pq_adc_fused.cu",
                     "src/repro/kernels/pq_adc/kernel.py:163"),
    "topk_scores": ("src/repro_torch/kernels/assign_topk/csrc/"
                    "topk_scores.cu",
                    "src/repro/kernels/assign_topk/kernel.py:124"),
    "sq8_dot_fused": ("src/repro_torch/kernels/sq8_dot/csrc/"
                      "sq8_dot_fused.cu",
                      "src/repro/kernels/sq8_dot/kernel.py:79"),
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
        build_on_card(dev, args.seed)

    launches = dict(opq_launches, sq8_dot_fused=refine_launches[
        "sq8_dot_fused"])
    kernels = [dict(name=k, route="cuda", source=SOURCES[k][0],
                    replaces=SOURCES[k][1], launches=launches[k],
                    max_abs_err=errs[k], **times[k])
               for k in ("pq_adc_fused", "topk_scores", "sq8_dot_fused")]
    log(f"[seconds] total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

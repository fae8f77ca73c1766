#!/usr/bin/env python3
"""On-card smoke of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py [--seed 0] [--batches 4]

Phases, in order; any failure raises, so the script exits non-zero and
never prints the final line:

  1. card     the ``nvidia-smi`` name/power-limit line and torch's name;
  2. build    every CUDA kernel from this checkout's sources (one nvcc
              per source, in parallel) into ``build/kernels/``;
  3. index    the ``serve_msmarco`` shape (configs/hi2_synth.py:
              8,841,984 docs, h=768, L=10,000, V=30,528, capacities
              1,024, OPQ m=96 k=256) synthesized on the host from
              ``--seed`` and moved to the card;
  4. parity   each kernel against its plain PyTorch version on the
              card, at edge shapes and at the main path's full width;
  5. serving  ``Server(ServeConfig(kc=30, k2=32, top_r=100,
              max_batch=256))`` answers ``--batches`` batches of 256
              queries with every launch count reset just before; each
              kernel must have launched, and each query must rank first
              the positive planted for it (recall@1 = 1);
  6. check    the first 8 queries against the same search on the CPU
              (the plain path) over the same planes;
  7. times    each kernel, its plain version and the library yardstick
              with CUDA events, beside the kernel's bound;
  8. profile  device time by kernel over one served batch
              (torch.profiler) and the device's busy share;

then prints the ``kernels`` JSON line and, last, the ``ok`` line.  It
imports only the port, never jax or the reference package, and exits
non-zero without a card.
"""
from __future__ import annotations

import argparse
import json
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
from repro_torch.core.codecs import pq as pq_codec  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.assign_topk import ops as at_ops  # noqa: E402
from repro_torch.kernels.assign_topk import ref as at_ref  # noqa: E402
from repro_torch.kernels.pq_adc import ops as adc_ops  # noqa: E402
from repro_torch.kernels.pq_adc import ref as adc_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

# the serve_msmarco serving shape (configs/hi2_synth.py::HI2ServeShape)
N_DOCS, HIDDEN, N_CLUSTERS, VOCAB = 8_841_984, 768, 10_000, 30_528
CLUSTER_CAP = TERM_CAP = 1_024
PQ_M, PQ_K = 96, 256
KC, K2, TOP_R = 30, 32, 100
BATCH, QUERY_LEN = 256, 32
K1_TERMS = 3                         # indexed terms per document

# H100 SXM published peaks (NVIDIA H100 datasheet)
PEAK_FP32_FLOPS = 67e12              # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12                 # HBM3

ADC_TOL = 1e-4                       # rtol = atol: m-reduction order
TOPK_TOL = 1e-5                      # rtol = atol: dot-product order
N_CHECK = 8                          # queries held against the CPU path


def log(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


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
    taken: dict = {}
    qrels = np.empty(len(qe), np.int64)
    for i, c in enumerate(best):
        taken[c] = taken.get(c, -1) + 1
        qrels[i] = leaves[".cluster_lists.entries"][c, taken[c]]
    if (qrels < 0).any():
        fail("a best cluster has too few members to plant a positive")
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
# comparisons
# --------------------------------------------------------------------------

def check_adc(got, want, what: str) -> float:
    """-inf lanes identical, finite scores within ADC_TOL; returns the
    largest absolute error."""
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        fail(f"pq_adc_fused {what}: -inf lanes differ from the plain version")
    fin = torch.isfinite(want)
    if not torch.allclose(got[fin], want[fin], rtol=ADC_TOL, atol=ADC_TOL):
        fail(f"pq_adc_fused {what}: scores differ beyond {ADC_TOL}")
    return float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0


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
    serving path finds both kernels' inputs cold)."""

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


def profile_batch(server, qe, qt, top: int = 10) -> None:
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
    log(f"[profile] one batch: wall {wall_us / 1e3:.3f} ms (profiled), "
        f"device busy {busy_us / 1e3:.3f} ms ({busy_us / wall_us:.1%}); "
        f"top {top} by device time:")
    for us, count, key in rows[:top]:
        log(f"[profile]   {us / 1e3:8.3f} ms  {us / busy_us:6.1%}  "
            f"x{count:<4d} {key[:90]}")


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
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {len(_build.SOURCES)} kernels ready in "
        f"{time.perf_counter() - t0:.1f} s (built now: {sorted(logs)})")
    for kname, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {kname}: {line.strip()}")


def parity_edges(dev, prng: np.random.Generator) -> dict:
    """Phase 4a: each kernel against its plain version at the edge
    shapes of the CPU tests; returns the largest error per kernel."""
    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    errs = {"pq_adc_fused": 0.0, "topk_scores": 0.0}
    adc_cases = [  # (name, b, c, m, k, code dtype, dup ids, masked row)
        ("c_ragged", 2, 8192 + 300, 96, 256, np.uint8, False, None),
        ("c_below_tile", 3, 5, 8, 128, np.uint8, False, 1),
        ("dup_masked_i32", 2, 1000, 8, 512, np.int32, True, 0),
        ("dup_masked_u8", 4, 700, 16, 256, np.uint8, True, 3),
        ("scalar_rows_m1", 2, 333, 1, 64, np.uint8, False, None),
        ("all_masked", 2, 100, 4, 64, np.uint8, False, "all"),
    ]
    for cname, b, c, m, k, dtype, dup, mask in adc_cases:
        lut = cuda(prng.normal(size=(b, m, k)).astype(np.float32))
        plane = cuda(prng.integers(0, k, (900, m)).astype(dtype))
        ids = prng.integers(-2, 902, (b, c)).astype(np.int32)  # clipped
        if dup:
            ids = np.concatenate([ids[:, : (c + 1) // 2]] * 2, -1)[:, :c]
        live = prng.random((b, c)) < 0.8
        if mask == "all":
            live[:] = False
        elif mask is not None:
            live[mask] = False
        ids, live = cuda(ids), cuda(live)
        errs["pq_adc_fused"] = max(errs["pq_adc_fused"], check_adc(
            adc_ops.pq_adc_fused(lut, plane, ids, live),
            adc_ref.pq_adc_fused(lut, plane, ids, live), cname))
    # rows not 16-byte aligned take the scalar path
    plane = cuda(prng.integers(0, 256, 900 * 96 + 3).astype(
        np.uint8))[3:].view(900, 96)
    lut = cuda(prng.normal(size=(2, 96, 256)).astype(np.float32))
    ids = cuda(prng.integers(0, 900, (2, 500)).astype(np.int32))
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
        x = cuda((x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(
            np.float32))
        emb = prng.normal(size=(l, h)).astype(np.float32)
        if ties:
            emb = np.concatenate([emb[: (l + 1) // 2]] * 2)[:l]
        emb = cuda(emb)
        errs["topk_scores"] = max(errs["topk_scores"], check_topk(
            at_ops.topk_scores(x, emb, k), at_ref.topk_scores(x, emb, k),
            x @ emb.T, cname))
    log(f"[parity] edge shapes: pq_adc_fused {len(adc_cases) + 1} cases, "
        f"topk_scores {len(topk_cases)} cases")
    return errs


def main_path_inputs(index, qe0, qt0) -> dict:
    """What the main path hands each kernel for one full batch: the
    dispatch inputs, and the score stage's LUT, rows and live mask."""
    with torch.inference_mode():
        cl_ids, tm_ids = qexec.dispatch(index.cluster_sel, index.term_sel,
                                        qe0, qt0, KC, K2)
        frontier = qexec.gather([hi.base_source(index)], cl_ids, tm_ids)
        return dict(
            x=qe0, emb=index.cluster_sel.embeddings, cl_ids=cl_ids,
            cands=frontier.cands, rows=frontier.local[0].contiguous(),
            live=qexec.dedup(frontier).contiguous(),
            lut=pq_codec.opq_adc_lut(index.codec_params, qe0).contiguous(),
            plane=index.doc_planes["codes"])


def parity_full_width(inp: dict, errs: dict) -> None:
    """Phase 4b: both kernels at the main path's full width (the plain
    ADC on N_CHECK queries: it builds (B, C, m)), and no (B, C, m)
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = adc_ops.pq_adc_fused(lut, plane, rows, live)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    if extra > out.numel() * 4 + (1 << 20):
        fail(f"pq_adc_fused allocated {extra} B beyond its output")
    log(f"[parity] full width: pq_adc_fused at B={rows.shape[0]} peaks at "
        f"{extra / 1e6:.1f} MB for a {out.numel() * 4 / 1e6:.1f} MB (B, C) "
        f"output (a (B, C, m) codes tensor would be "
        f"{rows.numel() * PQ_M / 1e9:.2f} GB); max abs err pq_adc_fused "
        f"{errs['pq_adc_fused']:.3g} (tol {ADC_TOL}), topk_scores "
        f"{errs['topk_scores']:.3g} (tol {TOPK_TOL})")


def serve_batches(index, dev, qe_all, qt_all, batches: int):
    """Phase 5: the counted main-path run; returns (server, results,
    launches)."""
    server = serve.Server(index, serve.ServeConfig(
        kc=KC, k2=K2, top_r=TOP_R, max_batch=BATCH), device=dev)
    server.warmup(HIDDEN, QUERY_LEN)
    adc_ops.launches = at_ops.launches = 0
    results, batch_s = [], []
    for i in range(batches):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        t0 = time.perf_counter()
        results.append(server.query(qe_all[sl], qt_all[sl]))
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    launches = {"pq_adc_fused": adc_ops.launches,
                "topk_scores": at_ops.launches}
    log(f"[serving] {server.n_served} queries in {sum(batch_s):.3f} s "
        f"({server.n_served / sum(batch_s):.1f} q/s; batch ms "
        f"{[round(s * 1e3, 2) for s in batch_s]}); launches {launches}")
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path never launched: {launches}")
    for res in results:
        if res.doc_ids.shape != (BATCH, TOP_R):
            fail(f"result shape {tuple(res.doc_ids.shape)}")
        if not torch.isfinite(res.scores).all():
            fail("non-finite result scores")
        if int(res.n_candidates.min()) < TOP_R:
            fail("a query evaluated fewer than R candidates")
    mean_cand = float(torch.cat([r.n_candidates for r in results])
                      .float().mean())
    log(f"[serving] mean unique live candidates {mean_cand:.0f} of "
        f"{hi.candidate_budget(index, KC, K2)} slots")
    return server, results, launches


def check_cpu(leaves: dict, qe8, qt8, inp: dict, first) -> None:
    """Phase 6: the first N_CHECK queries against the CPU plain path
    over the same planes; near-tie queries are listed, not checked."""
    cpu_index = ckpt.index_from_numpy(leaves, "opq", device="cpu")
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
                          first.scores[b].cpu().numpy(), ADC_TOL):
            fail(f"query {b}: top-R differs from the CPU path")
    log(f"[check] {N_CHECK - len(skipped)} of {N_CHECK} queries match the "
        f"CPU plain path (CPU search {cpu_s:.1f} s); near-tie queries "
        f"skipped: {skipped}")


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time on the card (ms) and what sets it."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def time_kernels(inp: dict) -> dict:
    """Phase 7: kernel, plain and library times at the main path's
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


SOURCES = {   # kernel → (CUDA source, the TPU kernel's pallas_call)
    "pq_adc_fused": ("src/repro_torch/kernels/pq_adc/csrc/pq_adc_fused.cu",
                     "src/repro/kernels/pq_adc/kernel.py:163"),
    "topk_scores": ("src/repro_torch/kernels/assign_topk/csrc/"
                    "topk_scores.cu",
                    "src/repro/kernels/assign_topk/kernel.py:124"),
}


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------

def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=4,
                    help="256-query batches served in the counted run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs an NVIDIA card")

    name = card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build_kernels()

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    leaves = synth_leaves(rng)
    qe_all, qt_all = synth_queries(rng, BATCH * args.batches)
    qrels = plant_positives(leaves, qe_all)
    t1 = time.perf_counter()
    index = ckpt.index_from_numpy(leaves, "opq", device=dev)
    torch.cuda.synchronize()
    resident = sum(a.nbytes for a in leaves.values())
    log(f"[index] synthesized in {t1 - t0:.1f} s, {resident / 1e9:.3f} GB "
        f"moved to the card in {time.perf_counter() - t1:.1f} s; "
        f"budget {hi.candidate_budget(index, KC, K2)} slots/query")

    errs = parity_edges(dev, np.random.default_rng(args.seed + 1))
    inp = main_path_inputs(index,
                           torch.from_numpy(qe_all[:BATCH]).to(dev),
                           torch.from_numpy(qt_all[:BATCH]).to(dev).long())
    parity_full_width(inp, errs)

    server, results, launches = serve_batches(index, dev, qe_all, qt_all,
                                              args.batches)
    ids = torch.cat([r.doc_ids for r in results]).cpu()
    r1, mrr = metrics.recall_at_k(ids, qrels, 1), metrics.mrr_at_k(ids,
                                                                   qrels, 10)
    log(f"[serving] planted positives: recall@1 {r1}, MRR@10 {mrr}")
    if r1 != 1.0:
        fail("a query did not rank its planted positive first")
    check_cpu(leaves, qe_all[:N_CHECK], qt_all[:N_CHECK], inp, results[0])
    times = time_kernels(inp)
    profile_batch(server, qe_all[:BATCH], qt_all[:BATCH])

    kernels = [dict(name=k, route="cuda", source=SOURCES[k][0],
                    replaces=SOURCES[k][1], launches=launches[k],
                    max_abs_err=errs[k], **times[k])
               for k in ("pq_adc_fused", "topk_scores")]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

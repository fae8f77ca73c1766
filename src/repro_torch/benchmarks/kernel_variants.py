"""A kernel change against its parent, in one process on one card.

    git show HEAD:src/repro_torch/kernels/assign_topk/csrc/topk_scores.cu \\
        > build/topk_parent.cu
    python -m repro_torch.benchmarks.kernel_variants --kernel topk_scores \\
        --parent build/topk_parent.cu [--gemm-only] [--variant kHC=16]
    git show HEAD:src/repro_torch/kernels/assign_topk/csrc/\\
assign_argmax.cu > build/assign_parent.cu
    python -m repro_torch.benchmarks.kernel_variants \\
        --kernel assign_argmax --parent build/assign_parent.cu --reps 5 \\
        [--variant kHC=32]
    git show HEAD:src/repro_torch/kernels/flash_attention/csrc/\\
flash_attention.cu > build/flash_parent.cu
    python -m repro_torch.benchmarks.kernel_variants \\
        --kernel flash_attention --parent build/flash_parent.cu \\
        [--variant kQRows=64,kWarps=4] [--sass DIR]

    git show HEAD:src/repro_torch/kernels/sq8_dot/csrc/\\
sq8_dot_fused.cu > build/sq8_parent.cu
    python -m repro_torch.benchmarks.kernel_variants \\
        --kernel sq8_dot_fused --parent build/sq8_parent.cu \\
        [--variant kGroupMax=4,kMinBlocks=1] [--sass DIR]
    git show HEAD:src/repro_torch/kernels/pq_adc/csrc/\\
pq_adc_fused.cu > build/adc_parent.cu
    python -m repro_torch.benchmarks.kernel_variants \\
        --kernel pq_adc_fused --parent build/adc_parent.cu \\
        [--variant kStages=3] [--seed S] [--sass DIR]

``HEAD`` is the parent while the change is not yet committed (after
committing it, ``HEAD~1``).  Builds the parent's source and this
checkout's with nvcc, in parallel, and prints each instance's ``ptxas``
registers and spills.  Both kernels are called through their wrapper's
own argument builders (``ops.kernel_args``).  Times are CUDA-event
medians of queued launches (all enqueued before one synchronize, so host
time is not counted; :class:`~repro_torch.benchmarks.timing.Timer`), the
50 MB L2 flushed before every launch, taken in the order parent, change,
change, parent, beside the library call that computes the same function
and the bound (the larger of bytes at 3.35 TB/s and FLOPs at 67
TFLOP/s, 989 for bf16 flash_attention).  The last line is a JSON object
of the times (ms).  Needs a card.

``topk_scores``: at the served dispatch shape (N 256, L 10,000, h 768,
k 30) and at the edge and adversarial shapes of :data:`TOPK_SHAPES`
(scores rising with the id, all scores equal, k 128 of L 129, the
runtime's buckets 1 and 8), every build must equal the parent bit for
bit and agree with the plain version within ``TOPK_TOL``; a
disagreement fails the run after the times.  The served shape and
bucket 8 (N 8: one query tile, 40 slices) are timed, beside
``torch.topk(x @ emb.T, k)`` and its two halves: ``x @ emb.T`` alone
(``library_matmul``, the GEMM half's yardstick) and ``torch.topk`` on the
precomputed plane (``library_topk``, the selection's).  Each build
launches at its own wrapper's slice count (a parent library without
``topk_scores_tiles`` has 16-query, 64-centroid tiles, sliced as its
wrapper sliced them).  ``--variant kHC=16,kMinBlocks=2`` adds a copy of
this checkout's source with those ``constexpr int`` tile constants set;
``--gemm-only`` adds a copy of every build with its per-tile selection
cut out (timed, not checked), which splits its time into GEMM and
selection: the text between the source's :data:`SELECTION_MARKS`, or in
a source without them (before the marks) the ``warp_merge`` call that
:data:`MERGE` finds, whose tile store and barrier stay.

``assign_argmax``: at the build's KMeans shape (N 1,048,576, L 10,000,
h 768), at its PQ shape (m 96, N 1,048,576, k 256, d_sub 8 as the
strided view of an (N, 768) matrix) and at the edge shapes of
:data:`ASSIGN_SHAPES`, every build must equal the parent bit for bit
(scores and ids; the change's 4-byte copies too) and agree with the
plain version under :func:`assign_agrees`; the two build shapes are
timed beside the library call, ``torch.argmax(x @ c.T − ½‖c‖²)`` in
65,536-point blocks.  A parent whose C entry takes no ½‖c‖² scratch
(before the scratch) is called without it and without ``vec``.
``--variant`` as for ``topk_scores``.

``flash_attention``: at the HI²_sup encoder chunk's shape (B 4,096, H
12, S 64, d 64 f32, non-causal), at the bf16 causal LM shapes of
:data:`FLASH_LM_SHAPES` (llama3-8b, internlm2-1.8b and olmoe-1b-7b
train_4k, stablelm-3b at d 80, Mixtral's window 4,096) and at SASRec's
(B 262,144, S 50, d 50 f32, causal; the change alone): every build in
both load instances against the plain version (f32 out within 1e-4,
bf16 within 2e-2, lse within 1e-4, dead rows zeros with lse -1e30; the
LM shapes one batch row at a time), timed beside
``scaled_dot_product_attention`` (Mixtral's window as a boolean mask)
and the bound, at 989 TFLOP/s for bf16.  Before that, every f32
instance (d 16, 32, 64, 128; the 16-byte and element-wise loads;
causal, ragged S), which the FMA kernel runs, must give the parent's
out and lse bit for bit, and every bf16 instance (d 16, 32, 64, 80,
128, the tensor-core kernel) of each build of this checkout must agree
with the plain version (a non-causal window with dead rows too): its
products sum in another order than the parent's and P is rounded to
bf16.  A failure fails the run after the times.  ``--variant`` as for
``topk_scores`` (``kQRows=64,kWarps=4``, ``kStages=3``); ``--sass`` as
for ``sq8_dot_fused`` (``HMMA`` counts the tensor-core products,
``LDSM`` the ldmatrix reads).  A parent whose C entry lacks the ``vec``
flag (before the element-wise instance) is called without it.

``sq8_dot_fused``: at the ``serve_msmarco_refine_sq8`` candidate plane of
``chip_smoke.py``'s phase 9 from the same ``--seed`` (B 256, C 63,488, h
768; :mod:`repro_torch.benchmarks.synth_msmarco`), at a no-reuse shape
(the same plane and live lanes, ids drawn at random) and at the edge
shapes of :data:`SQ8_SHAPES`: every build in each row-load instance must
equal the parent bit for bit (the parent's scalar instance read through
a misaligned copy of the plane) and agree with the plain version within
``SQ8_TOL``.  Prints the live slots, distinct rows, the bytes if each
live lane reads its row (the parent's traffic), the schedule's groups
and mean group size and the rows a group's slots hold; times the two
full shapes (the change's schedule included) beside the bound, and both
builds' scalar instances on a misaligned copy of the plane.  A parent
whose C entry is ``sq8_dot_fused`` (before the grouped schedule) is
called without a schedule and picks its own instance.
``--sass DIR`` writes each build's SASS there and prints its counts of
conversion, load, FMA and shuffle instructions.

``pq_adc_fused``: at the ``serve_msmarco`` opq candidate plane of
``chip_smoke.py``'s phase 5 from the same ``--seed`` (B 256, C 63,488,
m 96, k 256; :mod:`repro_torch.benchmarks.synth_msmarco`), at a
no-reuse shape (the same LUT, plane and live lanes, ids drawn at
random), at ``kernel_bench``'s full ``pq_adc`` shape (B 64, m 8, k 256,
N 100,000, C 2,048) and at the edge shapes of :data:`ADC_SHAPES`: every
build in each instance the plane allows (the change's scalar one
forced, the parent's reached through a misaligned copy of the plane)
must equal the parent bit for bit, ``-inf`` lanes included, and agree
with the plain version within ``ADC_TOL``; at the served plane the
change must also equal this checkout's unfused ``pq_adc`` on live lanes
bit for bit.  Prints live lanes, distinct rows, the row bytes requested
and the LUT bytes each build stages; times the three full shapes beside
the bound (phase 7's: ids, live flags, scores, LUT and each distinct
live row once), both builds' scalar instances, and at the
``kernel_bench`` shape its unfused path (gather, ``pq_adc``, mask), and
each build's device time alone (``*_device``: torch.profiler's kernel
time, which no host time enters).  A
parent whose C entries are ``pq_adc_fused_u8``/``_i32`` (before the
persistent kernel) is called through them.  ``--cut`` adds two copies of
this checkout's source, timed and not checked: ``cut_memory`` without
its lookups (the gathers alone) and ``cut_lookups`` without its row
copies (the lookups alone).  ``--sass`` as for ``sq8_dot_fused``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

from repro_torch.benchmarks import synth_msmarco as sm
from repro_torch.benchmarks.timing import Timer
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.kernels import _build
from repro_torch.kernels.assign_topk import ops as at_ops
from repro_torch.kernels.assign_topk import ref as at_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.pq_adc import ops as adc_ops
from repro_torch.kernels.pq_adc import ref as adc_ref
from repro_torch.kernels.sq8_dot import ops as sq8_ops
from repro_torch.kernels.sq8_dot import ref as sq8_ref

ROOT = pathlib.Path(__file__).resolve().parents[3]
OUT_DIR = ROOT / "build" / "kernel_variants"
PEAK_FP32_FLOPS, PEAK_BYTES = 67e12, 3.35e12
PEAK_BF16_FLOPS = 989e12     # bf16 on the tensor cores, dense
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # out, rtol = atol
LSE_TOL = 1e-4
#: name: (b, s, hq, hkv, d, window) of flash_attention's bf16 causal LM
#: shapes: each train_4k shape at the largest batch its step fits on one
#: card, llama3-8b's attention and Mixtral's window
FLASH_LM_SHAPES = {
    "llama3_8b": (1, 4096, 32, 8, 128, 0),
    "internlm2_1_8b_train_4k": (10, 4096, 16, 8, 128, 0),
    "olmoe_1b_7b_train_4k": (10, 4096, 16, 16, 128, 0),
    "stablelm_3b_train_4k": (12, 4096, 32, 32, 80, 0),
    "mixtral_8x22b_window": (1, 8192, 48, 8, 128, 4096),
}
TOPK_TOL = 1e-5          # rtol = atol: the h products' summation order
ASSIGN_TOL = 1e-5        # rtol = atol: the same
ASSIGN_BLOCK = 65_536    # points per block of a plain or library plane
#: name: (m, n, l, h, duplicated centroid rows, elements off alignment,
#: x the (n, m·h) matrix's strided (m, n, h) view); the first two timed
ASSIGN_SHAPES = {
    "kmeans": (1, 1_048_576, 10_000, 768, False, 0, False),
    "pq": (96, 1_048_576, 256, 8, False, 0, True),
    "ragged": (1, 513, 7, 40, False, 0, False),
    "one_point": (1, 1, 10_000, 768, False, 0, False),
    "ties": (1, 300, 1030, 64, True, 0, False),
    "pq_batch": (96, 700, 256, 8, True, 0, False),
    "h37_elementwise": (1, 1000, 300, 37, False, 0, False),
    "misaligned_view": (1, 777, 500, 768, False, 1, False),
    "pq_dsub4": (192, 3000, 256, 4, False, 0, True),
    "pq_dsub12": (64, 3000, 256, 12, True, 0, True),
    "n_ragged_wide": (1, 32 * 128 + 37, 1000, 96, False, 0, False),
    "n_ragged_pq": (96, 3 * 2048 + 77, 256, 8, False, 0, True),
}
#: tiles of a topk_scores.cu that does not export them, and the blocks
#: an SM its wrapper sized the slices for
PARENT_TILES = at_ops.Tiles(queries_per_block=16, centroid_tile=64,
                            blocks_per_sm=4)
#: name: (n, l, h, k, centroid layout (:func:`topk_inputs`), elements
#: off alignment); "served" and "bucket8" are timed
TOPK_SHAPES = {
    "served": (256, 10_000, 768, 30, "random", 0),
    "h37_elementwise": (40, 1000, 37, 30, "random", 0),
    "misaligned_view": (64, 3000, 768, 30, "random", 1),
    "n33_ragged": (33, 2000, 768, 30, "random", 0),
    "ties_k128": (20, 1000, 64, 128, "ties", 0),
    "ragged_tiles": (17, 129, 40, 8, "ties", 0),
    "ascending": (64, 3000, 768, 30, "ascending", 0),
    "all_equal": (40, 1000, 64, 30, "equal", 0),
    "k128_l129": (5, 129, 40, 128, "random", 0),
    "bucket1": (1, 10_000, 768, 30, "random", 0),
    "bucket8": (8, 10_000, 768, 30, "random", 0),
}
TOPK_TIMED = ("served", "bucket8")
SQ8_TOL = (1e-4, 1e-2)   # rtol, atol: the JAX kernel test's own
SQ8_PLAIN_CHUNK = 16     # queries a plain call: it builds (B, C, h) f32
SQ8_ROWS = 700           # plane rows of the edge shapes
#: name: (b, c, h, duplicated ids, masked row, byte offset of the plane,
#: id layout (:func:`sq8_layout`)), as tests/test_torch_cuda.py::SQ8_CASES
SQ8_SHAPES = {
    "c_below_tile": (3, 5, 768, False, 1, 0, "random"),
    "c_ragged": (2, 3 * 512 + 77, 768, True, None, 0, "random"),
    "h16_masked": (4, 700, 16, False, 3, 0, "random"),
    "h40_scalar": (2, 333, 40, True, 0, 0, "random"),
    "unaligned_view": (2, 600, 768, False, None, 3, "random"),
    "all_masked": (2, 100, 64, False, "all", 0, "random"),
    "shared_lists": (20, 3 * 1024, 768, False, None, 0, "lists"),
    "same_key_differs": (12, 2 * 512 + 40, 768, False, None, 0,
                         "same_key_differs"),
    "dedup_across_lists": (6, 2 * 1024, 64, False, None, 0, "dedup"),
    "served_ragged": (12, 2 * 1024 + 300, 768, False, None, 0, "lists"),
    "shared_lists_h40": (10, 2 * 1024, 40, False, 2, 0, "lists"),
}
ADC_TOL = 1e-4           # rtol = atol: the plain version's summation order
ADC_ROWS = 700           # plane rows of the edge shapes
ADC_PLAIN_CHUNK = 32     # queries a plain call: it builds (B, C, m)
#: kernel_bench's full pq_adc shape: b, m, k, n, c
ADC_BENCH = (64, 8, 256, 100_000, 2048)
#: name: (b, c, m, k, code dtype, duplicated ids, masked row, byte offset
#: of the plane, id layout (:func:`sq8_layout`)); the first four are
#: tests/test_torch_cuda.py::ADC_CASES' first four
ADC_SHAPES = {
    "c_ragged": (2, 8192 + 77, 96, 256, "uint8", False, None, 0, "random"),
    "c_below_tile": (3, 5, 8, 128, "uint8", False, 1, 0, "random"),
    "int32_dup_masked": (2, 600, 8, 512, "int32", True, 0, 0, "random"),
    "scalar_rows": (2, 333, 3, 64, "uint8", True, 1, 0, "random"),
    "served_lists": (24, 3 * 1024 + 100, 96, 256, "uint8", False, None, 0,
                     "lists"),
    "one_slot_dead": (1, 1, 96, 256, "uint8", False, "all", 0, "random"),
    "m_one": (3, 700, 1, 64, "uint8", False, None, 0, "random"),
    "int32_k300": (4, 3000, 96, 300, "int32", True, 2, 0, "random"),
    "b_above_wave": (600, 200, 96, 256, "uint8", False, 7, 0, "lists"),
    "misaligned_u8": (3, 2000, 96, 256, "uint8", False, None, 1, "random"),
    "misaligned_i32": (2, 900, 8, 512, "int32", False, None, 4, "random"),
    "lut_fills_smem": (2, 500, 96, 600, "int32", False, 1, 0, "random"),
}
#: SASS opcodes counted per kernel function by --sass
SASS_OPS = ("I2F", "PRMT", "FADD", "FFMA", "LDS", "LDG", "STS", "STG",
            "SHFL", "VIMNMX", "LEA", "HMMA", "LDSM")
# the per-tile selection of topk_scores.cu, between these two comments,
# and what --gemm-only puts in its place: a use of every accumulator, so
# the product is not optimized away
SELECTION_MARKS = ("// <per-tile selection>", "// </per-tile selection>")
SELECTION_STAND_IN = """{
      float z = 0.f;
#pragma unroll
      for (int i = 0; i < kTQ; ++i)
#pragma unroll
        for (int r = 0; r < kTC; ++r) z += acc[i][r];
      if (z != z) sm.is_last = 1;
    }"""
# a source without the marks (a parent from before them): its per-tile
# merge call, and its stand-in, which still reads the stored tile row
MERGE = re.compile(r"warp_merge\(sm\.ls\[q\], sm\.li\[q\], cnt\[u\], n, k, "
                   r"lane,.*?\}\);", re.S)
MERGE_STAND_IN = "if (row[lane] != row[lane]) cnt[u] = 0;"
#: --cut's copies of pq_adc_fused.cu: "memory" scores a slot from its staged
#: row's first word without looking anything up; "lookups" copies no row
#: (the lookups read whatever the ring holds).  Timed, not checked.
ADC_CUTS = {
    "memory": (re.compile(r"adc_vec<T, kK>\(s_lut, row, m, k\)"),
               "__uint_as_float(row[0].x & 0x3fffffu)"),
    "lookups": (re.compile(r"cp_async16\(stage \+ r \* pitch \+ 16 \* q,"
                           r"\s*plane_b \+ rid \* row_bytes \+ 16 \* q\);"),
                "(void)rid;"),
}


def takes_vec(source: str) -> bool:
    """Whether a ``flash_attention.cu``'s C entry takes the ``vec`` flag
    (sources from before the element-wise load instance do not)."""
    entry = re.search(r"int flash_attention_fwd\(([^)]*)\)", source)
    if entry is None:
        raise ValueError("no flash_attention_fwd C entry in the source")
    return re.search(r"\bint vec\b", entry.group(1)) is not None


def variant_source(source: str, consts: dict[str, str] | None = None,
                   gemm_only: bool = False) -> str:
    """A ``topk_scores.cu`` with each ``constexpr int NAME = ...;`` of
    ``consts`` set to its value and, with ``gemm_only``, the per-tile
    selection cut out: the text between :data:`SELECTION_MARKS` or, in a
    source without them, the merge call :data:`MERGE` finds.  ValueError
    where a part is not found exactly once."""
    for name, value in (consts or {}).items():
        source, n = re.subn(
            rf"^(constexpr int {re.escape(name)} = )[^;]+;",
            rf"\g<1>{value};", source, flags=re.M)
        if n != 1:
            raise ValueError(f"constant {name!r}: found {n} definitions, "
                             f"want 1")
    if gemm_only:
        begin, end = SELECTION_MARKS
        if begin in source or end in source:
            counts = (source.count(begin), source.count(end))
            head, _, rest = source.partition(begin)
            if counts != (1, 1) or end not in rest:
                raise ValueError(f"per-tile selection marks: found "
                                 f"{counts[0]} begin and {counts[1]} end "
                                 f"(end after begin: {end in rest}), want "
                                 f"one pair in order")
            source = (head + SELECTION_STAND_IN
                      + rest.partition(end)[2])
        else:
            source, n = MERGE.subn(MERGE_STAND_IN, source)
            if n != 1:
                raise ValueError(f"per-tile merge: found {n} matches, "
                                 f"want 1")
    return source


def takes_scratch(source: str) -> bool:
    """Whether an ``assign_argmax.cu``'s C entry takes the ½‖c‖² scratch
    (and ``vec``); sources from before the scratch take neither."""
    entry = re.search(r"int assign_argmax_launch\(([^)]*)\)", source)
    if entry is None:
        raise ValueError("no assign_argmax_launch C entry in the source")
    return re.search(r"\bhalf\b", entry.group(1)) is not None


def parse_consts(spec: str) -> dict[str, str]:
    """``"kHC=16,kMinBlocks=2"`` → ``{"kHC": "16", "kMinBlocks": "2"}``."""
    pairs = [item.partition("=") for item in spec.split(",")]
    if not all(eq and name.isidentifier() and value.strip()
               for name, eq, value in pairs):
        raise argparse.ArgumentTypeError(
            f"want NAME=VALUE[,NAME=VALUE], got {spec!r}")
    return {name: value.strip() for name, _, value in pairs}


def exports_tiles(lib) -> bool:
    """Whether a ``topk_scores`` library exports ``topk_scores_tiles``."""
    try:
        lib.topk_scores_tiles
    except AttributeError:
        return False
    return True


def topk_tiles(lib) -> at_ops.Tiles:
    """The library's tiles, or :data:`PARENT_TILES` where it has no
    ``topk_scores_tiles``."""
    return at_ops.tiles(lib) if exports_tiles(lib) else PARENT_TILES


def topk_slices(lib, tl: at_ops.Tiles, n: int, l: int, sms: int) -> int:
    """The slice count ``lib``'s own wrapper launches at (n, l); for a
    library without ``topk_scores_tiles``, its wrapper's rule: enough
    blocks for 4 an SM, at most one slice per 64-centroid tile."""
    if exports_tiles(lib):
        return at_ops.n_slices(n, l, sms, tl)
    want = -(-tl.blocks_per_sm * sms // -(-n // tl.queries_per_block))
    return max(1, min(want, -(-l // tl.centroid_tile)))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", required=True,
                    choices=("assign_argmax", "flash_attention",
                             "pq_adc_fused", "sq8_dot_fused", "topk_scores"))
    ap.add_argument("--parent", required=True, type=pathlib.Path,
                    help="the parent's source of the kernel")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variant", action="append", default=[],
                    type=parse_consts, metavar="NAME=VALUE[,NAME=VALUE]",
                    help="also build this checkout's source with these "
                         "constexpr int tile constants (every kernel)")
    ap.add_argument("--gemm-only", action="store_true",
                    help="also build every source without its per-tile "
                         "merge (topk_scores)")
    ap.add_argument("--seed", type=int, default=0,
                    help="chip_smoke.py's seed of the served plane "
                         "(sq8_dot_fused, pq_adc_fused)")
    ap.add_argument("--cut", action="store_true",
                    help="also time this checkout's source without its "
                         "lookups and without its row copies, unchecked "
                         "(pq_adc_fused)")
    ap.add_argument("--sass", type=pathlib.Path, default=None,
                    metavar="DIR", help="write each build's SASS into DIR "
                    "and print its instruction counts (sq8_dot_fused, "
                    "pq_adc_fused, flash_attention)")
    return ap.parse_args(argv)


def build(sources: dict) -> dict:
    """{name: source path} → {name: loaded library}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
         str(OUT_DIR / f"{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"{name} failed to build:\n{log}")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {entry[-40:]}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
        libs[name].kernel_error_string.argtypes = [ctypes.c_int]
        libs[name].kernel_error_string.restype = ctypes.c_char_p
    return libs


def report_times(sname: str, bound: float, times: dict) -> None:
    print(f"[times] {sname}: bound {bound:.4f} ms; " + "; ".join(
        f"{n} {' / '.join(f'{t:.4f}' for t in ts)}"
        for n, ts in times.items()), flush=True)


# --------------------------------------------------------------------------
# flash_attention
# --------------------------------------------------------------------------

def call_flash(lib, with_vec: bool, q, k, v, causal: bool,
               vec: bool = True, window: int = 0):
    """One launch through ``ops``' calling convention; ``with_vec`` False
    drops the ``vec`` argument for a C entry that lacks it."""
    out, lse = fa_ops.outputs(q)
    args = fa_ops.kernel_args(q, k, v, out, lse, causal, window,
                              q.shape[-1] ** -0.5,
                              vec and fa_ops.vector_loads(q, k, v, out),
                              torch.cuda.current_stream().cuda_stream)
    argtypes = list(fa_ops.ARGTYPES)
    if not with_vec:
        del args[-2], argtypes[-2]
    fn = lib.flash_attention_fwd
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    _build.check(lib, fn(*args), "flash_attention")
    return out, lse


def flash_agrees(got, q, k, v, causal: bool, window: int,
                 batch_block: int = 0) -> tuple[bool, float]:
    """``chip_smoke.check_flash``'s rule: out within FLASH_TOL of its
    dtype and lse within LSE_TOL of the plain version (``batch_block`` >
    0: that many batch rows at a time, query rows in Q_CHUNK blocks),
    dead rows (no visible key) zeros with lse NEG_INF.  Returns (ok, max
    abs out error)."""
    out_all, lse_all = got
    step = batch_block or q.shape[0]
    tol, ok, err = FLASH_TOL[q.dtype], True, 0.0
    for i in range(0, q.shape[0], step):
        rows = slice(i, i + step)
        out, lse = out_all[rows], lse_all[rows]
        want, wlse = fa_ref.flash_attention(
            q[rows], k[rows], v[rows], causal, window,
            q_chunk=fa_ops.Q_CHUNK if batch_block else None)
        err = max(err, float((out.float() - want.float()).abs().max()))
        dead = wlse == fa_ref.NEG_INF
        ok &= (torch.allclose(out.float(), want.float(), rtol=tol, atol=tol)
               and torch.allclose(lse, wlse, rtol=LSE_TOL, atol=LSE_TOL)
               and torch.equal(lse == fa_ref.NEG_INF, dead)
               and not bool((out[dead] != 0).any()))
    return ok, err


def flash_shapes(gen):
    """(name, shape): the encoder chunk (f32), the LM shapes of
    :data:`FLASH_LM_SHAPES` (bf16, causal; checked one batch row at a
    time) and SASRec's bulk batch (f32, d 50; the change alone)."""
    def bshd(b, s, h, d, dtype):
        return torch.randn((b, s, h, d), generator=gen, device="cuda").to(
            dtype).transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def counted(qkv, causal, window=0):
        q, k = qkv[0], qkv[1]
        flops, nbytes = fa_ops.work(q.shape[0], q.shape[1], k.shape[1],
                                    q.shape[2], k.shape[2], q.shape[3],
                                    causal, window, q.element_size())
        return dict(qkv=qkv, causal=causal, window=window, flops=flops,
                    nbytes=nbytes)

    yield "encoder", dict(
        counted([bshd(4096, 64, 12, 64, torch.float32) for _ in range(3)],
                False),
        library=lambda q, k, v: sdpa(q, k, v))
    for name, (b, s_len, hq, hkv, d, w) in FLASH_LM_SHAPES.items():
        qkv = [bshd(b, s_len, hq, d, torch.bfloat16)] + [
            bshd(b, s_len, hkv, d, torch.bfloat16) for _ in range(2)]
        if w:       # SDPA takes the window as a boolean mask
            i = torch.arange(s_len, device="cuda")
            mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < w)
            library = (lambda m: lambda q, k, v: sdpa(
                q, k, v, attn_mask=m, enable_gqa=True))(mask)
        else:
            library = lambda q, k, v: sdpa(q, k, v, is_causal=True,
                                           enable_gqa=True)
        yield name, dict(counted(qkv, True, w), library=library,
                         batch_block=1)
        del qkv
    # SASRec's two blocks at serve_bulk (configs/sasrec.py): d = 50 runs
    # ragged in the f32 d = 64 instance
    b, s_len, d = 262_144, 50, 50
    yield "sasrec_bulk", dict(
        counted([bshd(b, s_len, 1, d, torch.float32) for _ in range(3)],
                True),
        library=lambda q, k, v: sdpa(q, k, v, is_causal=True),
        parent=False)


def flash_instances(gen, dtype):
    """(name, q, k, v, causal, window, offset) at every instance of
    ``dtype`` (d in its HEAD_DIMS), on ``gen``'s device, aligned and one
    element off 16 bytes, with a ragged Sq / Sk and a causal mask; for
    bf16 also a non-causal window with Sq > Sk, whose last rows see no
    key."""
    for d in fa_ops.HEAD_DIMS[dtype]:
        for offset in (0, 1):
            def bshd(b, s, h):
                n = b * s * h * d
                flat = torch.randn(n + offset, generator=gen,
                                   device=gen.device).to(dtype)
                return flat[offset:].view(b, s, h, d).transpose(1, 2)
            name = f"d{d} {str(dtype)[6:]} offset {offset}"
            yield name, bshd(3, 130, 4), bshd(3, 100, 2), \
                bshd(3, 100, 2), bool(offset), 0, offset
            if dtype == torch.bfloat16:
                yield f"{name} dead rows", bshd(2, 300, 4), \
                    bshd(2, 70, 1), bshd(2, 70, 1), False, 32, offset


def flash_bitwise(libs: dict, with_vec: dict, gen) -> list:
    """The change's out and lse against the parent's, bit for bit, at
    the f32 :func:`flash_instances` (the FMA kernel, unchanged) in every
    load instance the input allows; returns the names that differ."""
    failed = []
    for name, q, k, v, causal, _, offset in flash_instances(
            gen, torch.float32):
        for vec in ((False,) if offset else (True, False)):
            got = call_flash(libs["new"], True, q, k, v, causal, vec)
            want = call_flash(libs["parent"], with_vec["parent"], q, k, v,
                              causal, vec)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            print(f"[bitwise] {name} vec={vec}: "
                  f"{'equal' if same else 'DIFFERS'}", flush=True)
            if not same:
                failed.append(f"{name} vec={vec}")
    return failed


def flash_tolerance(libs: dict, gen) -> list:
    """Each build of this checkout (the parent excepted) against the
    plain version (:func:`flash_agrees`) at the bf16
    :func:`flash_instances` (the tensor-core kernel), in every load
    instance the input allows; returns the failures."""
    failed = []
    for name, q, k, v, causal, window, offset in flash_instances(
            gen, torch.bfloat16):
        for lname in (n for n in libs if n != "parent"):
            for vec in ((False,) if offset else (True, False)):
                ok, err = flash_agrees(
                    call_flash(libs[lname], True, q, k, v, causal, vec,
                               window), q, k, v, causal, window)
                print(f"[tolerance] {name} {lname} vec={vec}: max abs out "
                      f"err {err:.3g} {'ok' if ok else 'FAILED'}",
                      flush=True)
                if not ok:
                    failed.append(f"{name} {lname} vec={vec}")
    return failed


def flash_main(args) -> dict:
    src = _build.SOURCES["flash_attention"]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    sources = {"parent": args.parent, "new": src}
    for i, consts in enumerate(args.variant):
        sources[f"variant{i}"] = OUT_DIR / f"flash_variant{i}.cu"
        sources[f"variant{i}"].write_text(
            variant_source(src.read_text(), consts))
        print(f"[variant] variant{i}: {consts}")
    with_vec = {name: name != "parent" or takes_vec(args.parent.read_text())
                for name in sources}
    libs = build(sources)
    if args.sass:
        report_sass(libs, args.sass, "flash")
    timer = Timer(queued=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    differ = flash_bitwise(libs, with_vec, gen)
    failed = flash_tolerance(libs, gen)
    report = {"bitwise_differs": differ, "tolerance_failed": failed}
    for sname, sh in flash_shapes(gen):
        q, k, v = sh["qkv"]
        causal, window = sh["causal"], sh["window"]
        names = list(libs) if sh.get("parent", True) else [
            n for n in libs if n != "parent"]
        for name in names:
            for vec in (True, False)[:1 + with_vec[name]]:
                ok, err = flash_agrees(
                    call_flash(libs[name], with_vec[name], q, k, v, causal,
                               vec, window), q, k, v, causal, window,
                    sh.get("batch_block", 0))
                print(f"[check] {sname} {name} vec={vec}: max abs out err "
                      f"{err:.3g} {'ok' if ok else 'FAILED'}", flush=True)
                if not ok:
                    failed.append(f"{sname} {name} vec={vec}")
        times = {}

        def run(name, vec=True):
            return lambda: call_flash(libs[name], with_vec[name], q, k, v,
                                      causal, vec, window)
        order = (("parent", "new", "new", "parent") if "parent" in names
                 else ("new", "new"))
        for name in order + tuple(n for n in names if n.startswith("var")):
            times.setdefault(name, []).append(timer.ms(run(name),
                                                       args.reps))
        times["new_scalar"] = [timer.ms(run("new", False),
                                        max(args.reps // 2, 3))]
        times["library"] = [timer.ms(lambda: sh["library"](q, k, v),
                                     args.reps) for _ in range(2)]
        peak = (PEAK_BF16_FLOPS if q.dtype == torch.bfloat16
                else PEAK_FP32_FLOPS)
        bound = 1e3 * max(sh["flops"] / peak, sh["nbytes"] / PEAK_BYTES)
        report[sname] = dict(bound_ms=bound, **times)
        report_times(sname, bound, times)
        new_ms = sum(times["new"]) / len(times["new"])
        print(f"[share] {sname}: bound / new {bound / new_ms:.1%} "
              f"({'bf16 tensor-core' if peak == PEAK_BF16_FLOPS else 'fp32'}"
              f" peak {peak / 1e12:.0f} TFLOP/s)", flush=True)
        del q, k, v, sh
    if differ or failed:    # after the times, which still tell where
        print(json.dumps(report))          # time goes
        sys.exit(f"flash_attention: differs from the parent: "
                 f"{', '.join(differ) or 'none'}; disagrees with the plain "
                 f"version: {', '.join(failed) or 'none'}")
    return report


# --------------------------------------------------------------------------
# topk_scores
# --------------------------------------------------------------------------

def topk_inputs(gen, n, l, h, layout, offset):
    """Unit-norm queries and centroids on the card.  ``layout``:
    "random" Gaussian rows; "ties" duplicates the first half of them;
    "ascending" scales one Gaussian row by (j + 1) / L for centroid j,
    each query's sign set so that every score rises with the id (every
    candidate beats the running k-th); "equal" repeats one row (every
    score of a query equal, ids decide).  ``offset`` > 0 makes x a
    contiguous view that many elements past an aligned base."""
    flat = torch.randn(n * h + offset, generator=gen, device="cuda")
    x = flat[offset:].view(n, h)
    x /= x.norm(dim=1, keepdim=True)
    emb = torch.randn((l, h), generator=gen, device="cuda")
    if layout == "ties":
        emb = torch.cat([emb[: (l + 1) // 2]] * 2)[:l].contiguous()
    elif layout == "ascending":
        x *= torch.where(x @ emb[0] < 0, -1.0, 1.0)[:, None]
        ramp = torch.arange(1, l + 1, device="cuda") / l
        emb = (ramp[:, None] * emb[0]).contiguous()
    elif layout == "equal":
        emb = emb[:1].expand(l, h).contiguous()
    elif layout != "random":
        raise ValueError(f"unknown centroid layout {layout!r}")
    return x, emb


def call_topk(lib, tl: at_ops.Tiles, x, emb, k: int):
    """One launch through ``ops``' argument builders, at the slice count
    ``lib``'s own wrapper launches."""
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    slices = topk_slices(lib, tl, x.shape[0], emb.shape[0], sms)
    bufs = at_ops.buffers(x, k, tl, slices)
    at_ops.launch(lib, x, emb, k, slices, bufs)
    return bufs[0], bufs[1]


def topk_agrees(got, want, full) -> tuple[bool, float]:
    """Scores within TOPK_TOL of the plain version, ids equal except
    between plain scores within it, no id twice in a row."""
    (gs, gi), (ws, wi) = got, want
    ok = torch.allclose(gs, ws, rtol=TOPK_TOL, atol=TOPK_TOL)
    diff = gi != wi
    own = torch.gather(full, 1, gi.long())
    ok &= bool(((own - ws).abs()[diff]
                <= TOPK_TOL + TOPK_TOL * ws.abs()[diff]).all())
    ok &= all(len(set(row)) == len(row) for row in gi.tolist())
    return ok, float((gs - ws).abs().max())


def topk_main(args) -> dict:
    src = _build.SOURCES["topk_scores"]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    sources = {"parent": args.parent, "new": src}
    for i, consts in enumerate(args.variant):
        sources[f"variant{i}"] = OUT_DIR / f"variant{i}.cu"
        sources[f"variant{i}"].write_text(
            variant_source(src.read_text(), consts))
        print(f"[variant] variant{i}: {consts}")
    exact = list(sources)
    if args.gemm_only:
        for name in exact:
            try:
                text = variant_source(sources[name].read_text(),
                                      gemm_only=True)
            except ValueError as e:         # e.g. another merge call
                print(f"[gemm-only] {name}: left out ({e})")
                continue
            sources[f"{name}_gemm"] = OUT_DIR / f"{name}_gemm.cu"
            sources[f"{name}_gemm"].write_text(text)
    libs = build(sources)
    tl = {name: topk_tiles(lib) for name, lib in libs.items()}
    for name, t in tl.items():
        print(f"[tiles] {name}: {t}", flush=True)
    failed = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for sname, (n, l, h, k, layout, offset) in TOPK_SHAPES.items():
        x, emb = topk_inputs(gen, n, l, h, layout, offset)
        want = at_ref.topk_scores(x, emb, k)
        base = call_topk(libs["parent"], tl["parent"], x, emb, k)
        for name in exact:
            got = call_topk(libs[name], tl[name], x, emb, k)
            ok, err = topk_agrees(got, want, x @ emb.T)
            same = all(torch.equal(a, b) for a, b in zip(got, base))
            print(f"[check] {sname} {name}: max abs score err {err:.3g} "
                  f"{'ok' if ok else 'FAILED'}; bitwise equal to the "
                  f"parent: {same}", flush=True)
            if not ok or not same:
                failed.append(f"{name} at {sname}")
    sms = torch.cuda.get_device_properties("cuda").multi_processor_count
    timer = Timer(queued=True)
    report = {}
    for sname in TOPK_TIMED:
        n, l, h, k, layout, offset = TOPK_SHAPES[sname]
        x, emb = topk_inputs(gen, n, l, h, layout, offset)
        times = {}

        def run(name):
            """One launch, its buffers allocated before the timed window
            and its ticket counters zeroed inside it (as every call
            needs)."""
            slices = topk_slices(libs[name], tl[name], n, l, sms)
            print(f"[slices] {sname} {name}: {slices}", flush=True)
            bufs = at_ops.buffers(x, k, tl[name], slices)

            def launch():
                bufs[4].zero_()
                at_ops.launch(libs[name], x, emb, k, slices, bufs)
            return launch
        for name in ("parent", "new", "new", "parent"):
            times.setdefault(name, []).append(timer.ms(run(name), args.reps))
        for name in libs:
            if name not in times:
                times[name] = [timer.ms(run(name), args.reps)]
        plane = x @ emb.T
        times["library"] = [timer.ms(lambda: torch.topk(x @ emb.T, k),
                                     args.reps) for _ in range(2)]
        times["library_matmul"] = [timer.ms(lambda: x @ emb.T, args.reps)
                                   for _ in range(2)]
        times["library_topk"] = [timer.ms(lambda: torch.topk(plane, k),
                                          args.reps) for _ in range(2)]
        times["plain"] = [timer.ms(lambda: at_ref.topk_scores(x, emb, k),
                                   args.reps) for _ in range(2)]
        flops, nbytes = at_ops.work(n, l, h, k)
        bound = 1e3 * max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)
        report_times(sname, bound, times)
        report[sname] = dict(bound_ms=bound, **times)
    if failed:      # after the times, which still tell where time goes
        print(json.dumps(report))
        sys.exit(f"disagrees: {', '.join(failed)}")
    return report


# --------------------------------------------------------------------------
# assign_argmax
# --------------------------------------------------------------------------

def assign_inputs(gen, m, n, l, h, ties, offset, view):
    """Gaussian points and centroids on the card.  ``view``: x is the
    (m, n, h) view of an (n, m·h) matrix; else contiguous, ``offset``
    elements past an aligned base.  ``ties`` duplicates the first half of
    every batch entry's centroids."""
    flat = torch.randn(m * n * h + offset, generator=gen, device="cuda")
    if view:
        x = flat.view(n, m, h).transpose(0, 1)
    else:
        x = flat[offset:].view(m, n, h)
    c = torch.randn((m, l, h), generator=gen, device="cuda")
    if ties:
        c = torch.cat([c[:, : (l + 1) // 2]] * 2, dim=1)[:, :l].contiguous()
    return x, c


def call_assign(lib, scratch: bool, x, c, vec: bool | None = None,
                bufs: list | None = None):
    """One call through ``ops``' argument builders; ``scratch`` False
    drops the ½‖c‖² scratch and ``vec`` for a C entry without them.
    ``vec`` None takes the wrapper's choice."""
    bufs = at_ops.assign_buffers(x, c) if bufs is None else bufs
    vec = at_ops.assign_vector_loads(x, c) if vec is None else vec
    args = at_ops.assign_kernel_args(
        x, c, bufs, vec, torch.cuda.current_stream().cuda_stream)
    argtypes = list(at_ops.ASSIGN_ARGTYPES)
    if not scratch:
        del args[-2], argtypes[-2], args[4], argtypes[4]
    fn = lib.assign_argmax_launch
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    _build.check(lib, fn(*args), "assign_argmax")
    return bufs[0], bufs[1]


def blocked(fn, x, c):
    """``fn`` over ASSIGN_BLOCK-point blocks of x (m, n, h), results
    concatenated along n: the plain and library planes in pieces."""
    outs = [fn(x[:, i:i + ASSIGN_BLOCK], c)
            for i in range(0, x.shape[1], ASSIGN_BLOCK)]
    return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


def assign_library(x, c):
    """The library call the kernel is timed beside."""
    return torch.argmax(x @ c.transpose(-1, -2)
                        - 0.5 * (c * c).sum(-1)[..., None, :], dim=-1)


def assign_agrees(x, c, got, want, ties: bool
                  ) -> tuple[bool, float, float, int]:
    """``chip_smoke.check_assign``'s rule: scores within ASSIGN_TOL of
    the plain version; ids equal except where the plain score of the
    kernel's id lies within ASSIGN_TOL of the best (near-ties, counted);
    on constructed ties the lower twin.  Returns (ok, max abs and max
    relative score error, near-tie rows)."""
    (gs, gi), (ws, wi) = got, want
    ok = torch.allclose(gs, ws, rtol=ASSIGN_TOL, atol=ASSIGN_TOL)
    half = 0.5 * (c * c).sum(-1)
    near = 0
    for i in range(0, x.shape[1], ASSIGN_BLOCK):
        sl = slice(i, i + ASSIGN_BLOCK)
        ids = gi[:, sl].long()
        diff = ids != wi[:, sl]
        if not diff.any():
            continue
        rows = torch.gather(c, 1, ids[..., None].expand(-1, -1, c.shape[2]))
        own = (x[:, sl] * rows).sum(-1) - torch.gather(half, 1, ids)
        ref_s = ws[:, sl]
        ok &= bool(((own - ref_s).abs()[diff]
                    <= ASSIGN_TOL + ASSIGN_TOL * ref_s.abs()[diff]).all())
        near += int(diff.sum())
    if ties:
        ok &= bool((gi < (c.shape[1] + 1) // 2).all())
    err = (gs - ws).abs()
    return (ok, float(err.max()),
            float((err / ws.abs().clamp_min(1e-30)).max()), near)


def assign_main(args) -> dict:
    src = _build.SOURCES["assign_argmax"]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    sources = {"parent": args.parent, "new": src}
    for i, consts in enumerate(args.variant):
        sources[f"variant{i}"] = OUT_DIR / f"assign_variant{i}.cu"
        sources[f"variant{i}"].write_text(
            variant_source(src.read_text(), consts))
        print(f"[variant] variant{i}: {consts}")
    scratch = {name: takes_scratch(path.read_text())
               for name, path in sources.items()}
    libs = build(sources)
    failed, report = [], {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer(queued=True)
    for sname, (m, n, l, h, ties, offset, view) in ASSIGN_SHAPES.items():
        x, c = assign_inputs(gen, m, n, l, h, ties, offset, view)
        want = blocked(at_ref.assign_argmax, x, c)
        base = call_assign(libs["parent"], scratch["parent"], x, c)
        vec = at_ops.assign_vector_loads(x, c)
        for name, lib in libs.items():
            for v in ((vec, False) if vec and scratch[name] else (vec,)):
                got = call_assign(lib, scratch[name], x, c, v)
                ok, err, rel, near = assign_agrees(x, c, got, want, ties)
                same = all(torch.equal(a, b) for a, b in zip(got, base))
                inst = f"vec={v}" if scratch[name] else "own copies"
                print(f"[check] {sname} {name} {inst}: max abs score err "
                      f"{err:.3g}, max rel {rel:.3g}, near-tie ids {near} "
                      f"{'ok' if ok else 'FAILED'}; bitwise equal to the "
                      f"parent: {same}", flush=True)
                if not ok or not same:
                    failed.append(f"{name} {inst} at {sname}")
                del got
        del want, base
        if sname not in ("kmeans", "pq"):
            continue
        times = {}

        def run(name):
            bufs = at_ops.assign_buffers(x, c)
            return lambda: call_assign(libs[name], scratch[name], x, c,
                                       bufs=bufs)
        for name in ("parent", "new", "new", "parent"):
            times.setdefault(name, []).append(timer.ms(run(name), args.reps))
        for name in libs:
            if name not in times:
                times[name] = [timer.ms(run(name), args.reps)]
        times["library"] = [timer.ms(lambda: blocked(
            lambda xb, cb: (assign_library(xb, cb),), x, c), 2, warm=1)
            for _ in range(2)]
        times["plain"] = [timer.ms(lambda: blocked(at_ref.assign_argmax, x,
                                                   c), 2, warm=1)]
        bound = 1e3 * max(2.0 * m * n * l * h / PEAK_FP32_FLOPS,
                          4.0 * (m * n * h + m * l * h + 2 * m * n)
                          / PEAK_BYTES)
        report_times(sname, bound, times)
        report[sname] = dict(bound_ms=bound, **times)
        del x, c
        torch.cuda.empty_cache()
    if failed:      # after the times, which still tell where time goes
        print(json.dumps(report))
        sys.exit(f"disagrees: {', '.join(failed)}")
    return report


# --------------------------------------------------------------------------
# sq8_dot_fused
# --------------------------------------------------------------------------

def sq8_layout(rng: np.random.Generator, b: int, c: int, n_rows: int,
               layout: str, cap: int = 1024
               ) -> tuple[np.ndarray, np.ndarray]:
    """(B, C) int32 ids and bool live lanes of a candidate plane shaped
    like the served one.  ``lists`` and ``dedup``: each query holds
    ceil(C / cap) inverted lists of capacity ``cap`` (PAD tails clipped
    to row 0 and dead, as in the served plane; one list shorter than half
    its capacity) drawn without repeats from a small set (4 lists for
    ``lists``, 2 for ``dedup``), so many queries hold one list, in
    another order each; lanes die at random (5%; 50% for ``dedup``, so
    one row is live for one query and dead for another of the same
    group).  ``same_key_differs``: random ids with the same live row at
    every 512th slot, so every item (of 512 or 1,024 slots) has one key
    while the ids between differ."""
    if layout == "same_key_differs":
        ids = rng.integers(0, n_rows, (b, c))
        live = rng.random((b, c)) < 0.8
        ids[:, ::512], live[:, ::512] = 7, True
        return ids.astype(np.int32), live
    if layout not in ("lists", "dedup"):
        raise ValueError(f"unknown id layout {layout!r}")
    n_lists, kill = (4, 0.05) if layout == "lists" else (2, 0.5)
    per_query = -(-c // cap)
    n_lists = max(n_lists, per_query)
    entries = np.full((n_lists, cap), -1, np.int64)
    for i in range(n_lists):
        n = cap // 2 - 100 if i == 0 else rng.integers(cap // 2, cap + 1)
        entries[i, :n] = rng.integers(0, n_rows, n)
    picks = np.stack([rng.permutation(n_lists)[:per_query]
                      for _ in range(b)])
    plane = entries[picks].reshape(b, -1)[:, :c]
    live = (plane >= 0) & (rng.random((b, c)) >= kill)
    return np.maximum(plane, 0).astype(np.int32), live


def sq8_case(name: str, dev):
    """The inputs of edge shape ``name`` on ``dev``: q (b, h) f32, a
    (SQ8_ROWS, h) uint8 plane (a view ``offset`` bytes into its buffer),
    ids and live."""
    b, c, h, dup, mask, offset, layout = SQ8_SHAPES[name]
    rng = np.random.default_rng(len(name) + 100)
    q = torch.tensor(rng.normal(size=(b, h)), dtype=torch.float32,
                     device=dev)
    flat = torch.tensor(rng.integers(0, 256, SQ8_ROWS * h + offset),
                        dtype=torch.uint8, device=dev)
    plane = flat[offset:].view(SQ8_ROWS, h)
    if layout == "random":
        ids = rng.integers(-3, SQ8_ROWS + 3, (b, c)).astype(np.int32)
        if dup:
            ids = np.concatenate([ids[:, : (c + 1) // 2]] * 2, -1)[:, :c]
        live = rng.random((b, c)) < 0.8
    else:
        ids, live = sq8_layout(rng, b, c, SQ8_ROWS, layout)
    if mask == "all":
        live[:] = False
    elif mask is not None:
        live[mask] = False
    return (q, plane, torch.tensor(ids, device=dev),
            torch.tensor(live, device=dev))


def grouped_entry(source: str) -> bool:
    """Whether a ``sq8_dot_fused.cu``'s C entry is the grouped
    ``sq8_dot_fused_launch`` (else the per-lane ``sq8_dot_fused`` of the
    kernel before it)."""
    if re.search(r"int sq8_dot_fused_launch\(", source):
        return True
    if re.search(r"int sq8_dot_fused\(", source):
        return False
    raise ValueError("no sq8_dot_fused C entry in the source")


#: ctypes signature of the per-lane kernel's C entry ``sq8_dot_fused``
SQ8_PARENT_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong, ctypes.c_void_p])


def call_sq8(lib, grouped: bool, q, plane, ids, live,
             vec: bool | None = None):
    """One call of a build: a grouped one through ``ops.launch`` (its
    schedule included; ``vec`` None takes the wrapper's choice), a
    per-lane one through its own C entry (it picks its instance)."""
    if grouped:
        return sq8_ops.launch(lib, q, plane, ids, live, vec)
    out = torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
    fn = lib.sq8_dot_fused
    fn.argtypes, fn.restype = SQ8_PARENT_ARGTYPES, ctypes.c_int
    err = fn(q.data_ptr(), plane.data_ptr(), ids.data_ptr(), live.data_ptr(),
             out.data_ptr(), q.shape[0], ids.shape[1], q.shape[1],
             plane.shape[0], torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "sq8_dot_fused")
    return out


def misaligned_copy(plane: torch.Tensor, offset: int = 3) -> torch.Tensor:
    """``plane``'s rows in a view ``offset`` bytes (a whole number of
    codes) into a fresh buffer: every build reads it with its scalar
    instance."""
    per = offset // plane.element_size()
    flat = torch.empty(plane.numel() + per + 16, dtype=plane.dtype,
                       device=plane.device)
    view = flat[per:per + plane.numel()].view(plane.shape)
    view.copy_(plane)
    return view


def sq8_plain(q, plane, ids, live):
    """The plain version in SQ8_PLAIN_CHUNK-query pieces."""
    return torch.cat([sq8_ref.sq8_dot_fused(
        q[s:s + SQ8_PLAIN_CHUNK], plane, ids[s:s + SQ8_PLAIN_CHUNK],
        live[s:s + SQ8_PLAIN_CHUNK])
        for s in range(0, q.shape[0], SQ8_PLAIN_CHUNK)])


def sq8_agrees(got, want) -> tuple[bool, float]:
    """``-inf`` lanes identical, finite scores within SQ8_TOL."""
    fin = torch.isfinite(want)
    ok = torch.equal(torch.isneginf(got), torch.isneginf(want))
    rtol, atol = SQ8_TOL
    ok = ok and torch.allclose(got[fin], want[fin], rtol=rtol, atol=atol)
    err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0
    return ok, err


def sq8_check(libs: dict, grouped: dict, sname: str, q, plane, ids, live,
              failed: list) -> None:
    """Every build in each instance the plane allows against the plain
    version and bit for bit against the parent in the same instance."""
    want = sq8_plain(q, plane, ids, live)
    vec_ok = sq8_ops.sq8_vector_loads(plane)
    base = {False: call_sq8(libs["parent"], grouped["parent"], q,
                            misaligned_copy(plane), ids, live, False)}
    if vec_ok:
        base[True] = call_sq8(libs["parent"], grouped["parent"], q, plane,
                              ids, live, True)
    for name, lib in libs.items():
        for vec in ((True, False) if vec_ok else (False,)):
            if grouped[name]:
                got = call_sq8(lib, True, q, plane, ids, live, vec)
            elif vec:
                got = base[True]
            else:
                got = base[False]
            ok, err = sq8_agrees(got, want)
            same = torch.equal(got, base[vec])
            print(f"[check] {sname} {name} vec={vec}: max abs err {err:.3g} "
                  f"{'ok' if ok else 'FAILED'}; bitwise equal to the parent: "
                  f"{same}", flush=True)
            if not ok or not same:
                failed.append(f"{name} vec={vec} at {sname}")


def sq8_traffic(ids, live, n_rows: int, h: int, tl: sq8_ops.Tiles) -> dict:
    """What the plane asks of the card: live slots, distinct live rows,
    the schedule's items and groups, and the rows device memory serves
    when each group's repeats hit on chip (each distinct live row of a
    group's slot once)."""
    b, c = ids.shape
    dev, tile = ids.device, tl.tile_slots
    rows = ids.long().clamp(0, n_rows - 1)
    skey, order = sq8_ops.schedule(ids, live, n_rows, tile)
    lead = sq8_ops.lead_flags(skey, tl.group_max)
    n_items, groups = order.numel(), int(lead.sum())
    gid = torch.empty(n_items, dtype=torch.long, device=dev)
    gid[order.long()] = torch.cumsum(lead.long(), 0) - 1
    pos = torch.empty(n_items, dtype=torch.long, device=dev)
    pos[order.long()] = torch.arange(n_items, device=dev)
    col = torch.arange(c, device=dev)
    item = (torch.arange(b, device=dev)[:, None] * -(-c // tile)
            + col // tile)
    lane_key = (gid[item] * tile + col % tile)[live]
    lane_pos, lane_row = pos[item][live], rows[live]
    first = torch.full((groups * tile,), n_items, dtype=torch.long,
                       device=dev).scatter_reduce(0, lane_key, lane_pos,
                                                  "amin")
    is_first = lane_pos == first[lane_key]
    lead_row = torch.zeros(groups * tile, dtype=torch.long, device=dev)
    lead_row[lane_key[is_first]] = lane_row[is_first]
    reads = (torch.unique(lane_key).numel()
             + int((lane_row != lead_row[lane_key]).sum()))
    return dict(live=int(live.sum()), distinct=torch.unique(lane_row).numel(),
                items=n_items, groups=groups, reads=reads)


def sq8_full_shapes(seed: int, dev):
    """The phase-9 candidate plane of chip_smoke.py from ``seed`` (its
    first batch), then the same plane and live lanes with random ids."""
    rng = np.random.default_rng(seed)
    leaves = sm.synth_leaves(rng)
    qe, qt = sm.synth_queries(rng, sm.BATCH * sm.SMOKE_BATCHES)
    index = ckpt.index_from_numpy(leaves, "opq", device=dev)
    del leaves
    rindex, _ = sm.refine_index(index, dev, seed, qe)
    del index
    inp = sm.main_path_inputs(
        rindex, torch.from_numpy(qe[:sm.BATCH]).to(dev),
        torch.from_numpy(qt[:sm.BATCH]).to(dev).long())
    q, plane, ids, live = (inp[k] for k in ("q_scaled", "plane", "rows",
                                            "live"))
    del rindex, inp
    torch.cuda.empty_cache()
    yield "served", (q, plane, ids, live)
    gen = torch.Generator(device=dev).manual_seed(seed)
    yield "no_reuse", (q, plane, torch.randint(
        0, plane.shape[0], ids.shape, generator=gen, device=dev,
        dtype=torch.int32), live)


def sass_counts(lib_path: pathlib.Path, out: pathlib.Path) -> dict:
    """Write the library's SASS to ``out``; return {function: {opcode:
    count}} for :data:`SASS_OPS` (opcode prefixes: I2F counts I2F.U32 and
    the rest)."""
    tool = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    out.write_text(text)
    counts, fn = {}, None
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z0-9]+)", line)
        if ins and fn:
            for op in SASS_OPS:
                if ins.group(1) == op or ins.group(1).startswith(op):
                    counts[fn][op] += 1
    return counts


def report_sass(libs: dict, out_dir: pathlib.Path, prefix: str) -> None:
    """Write each build's SASS into ``out_dir`` and print its
    :data:`SASS_OPS` counts, function by function."""
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in libs:
        counts = sass_counts(OUT_DIR / f"{name}.so",
                             out_dir / f"{prefix}_{name}.sass")
        for fn, ops in counts.items():
            print(f"[sass] {name} {fn[-60:]}: " + ", ".join(
                f"{op} {n}" for op, n in ops.items()), flush=True)


def sq8_main(args) -> dict:
    src = _build.SOURCES["sq8_dot_fused"]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    sources = {"parent": args.parent, "new": src}
    for i, consts in enumerate(args.variant):
        sources[f"variant{i}"] = OUT_DIR / f"sq8_variant{i}.cu"
        sources[f"variant{i}"].write_text(
            variant_source(src.read_text(), consts))
        print(f"[variant] variant{i}: {consts}")
    grouped = {name: grouped_entry(path.read_text())
               for name, path in sources.items()}
    libs = build(sources)
    for name, lib in libs.items():
        if grouped[name]:
            print(f"[tiles] {name}: {sq8_ops.tiles(lib)}", flush=True)
    if args.sass:
        report_sass(libs, args.sass, "sq8")
    dev = torch.device("cuda", torch.cuda.current_device())
    failed, report = [], {}
    for sname in SQ8_SHAPES:
        sq8_check(libs, grouped, sname, *sq8_case(sname, dev), failed)
    timer = Timer(queued=True)
    tl = sq8_ops.tiles(libs["new"])
    for sname, (q, plane, ids, live) in sq8_full_shapes(args.seed, dev):
        b, c = ids.shape
        n, h = plane.shape
        sq8_check(libs, grouped, sname, q, plane, ids, live, failed)
        tr = sq8_traffic(ids, live, n, h, tl)
        fixed = 9.0 * b * c + 4.0 * q.numel()     # ids, live, out, q
        per_lane = fixed + tr["live"] * h
        grouped_bytes = fixed + tr["reads"] * h
        flops, nbytes = sq8_ops.work(b, c, h, tr["live"], tr["distinct"])
        bound = 1e3 * max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)
        print(f"[traffic] {sname} B={b} C={c} h={h}: {tr['live']} live "
              f"slots over {tr['distinct']} distinct rows; each live lane "
              f"reading its row moves {per_lane / 1e9:.3f} GB "
              f"({1e3 * per_lane / PEAK_BYTES:.3f} ms at peak); "
              f"{tr['items']} items in {tr['groups']} groups (mean "
              f"{tr['items'] / tr['groups']:.2f}, at most {tl.group_max}); "
              f"a group's distinct rows a slot: {tr['reads']} rows, "
              f"{grouped_bytes / 1e9:.3f} GB "
              f"({1e3 * grouped_bytes / PEAK_BYTES:.3f} ms at peak)",
              flush=True)

        def run(name, vec=None):
            return lambda: call_sq8(libs[name], grouped[name], q, plane,
                                    ids, live, vec)
        times = {}
        for name in ("parent", "new", "new", "parent"):
            times.setdefault(name, []).append(timer.ms(run(name), args.reps))
        for name in libs:
            if name not in times:
                times[name] = [timer.ms(run(name), args.reps)]
        mis = misaligned_copy(plane)          # both builds' scalar instance
        for name in ("parent", "new"):
            times[f"{name}_scalar"] = [timer.ms(
                lambda: call_sq8(libs[name], grouped[name], q, mis, ids, live,
                                 False), max(args.reps // 4, 3))]
        del mis
        report_times(sname, bound, times)
        report[sname] = dict(bound_ms=bound, **tr, **times)
    if failed:      # after the times, which still tell where time goes
        print(json.dumps(report))
        sys.exit(f"disagrees: {', '.join(failed)}")
    return report


# --------------------------------------------------------------------------
# pq_adc_fused
# --------------------------------------------------------------------------

def persistent_entry(source: str) -> bool:
    """Whether a ``pq_adc_fused.cu``'s C entry is ``pq_adc_fused_launch``
    (else the per-dtype ``pq_adc_fused_u8``/``_i32`` of the kernel before
    it, which picked its own instance)."""
    if re.search(r"int pq_adc_fused_launch\(", source):
        return True
    if re.search(r"int pq_adc_fused_u8\(", source):
        return False
    raise ValueError("no pq_adc_fused C entry in the source")


#: ctypes signature of the earlier kernel's ``pq_adc_fused_u8``/``_i32``
ADC_PARENT_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong, ctypes.c_void_p])


def call_adc(lib, persistent: bool, lut, plane, ids, live,
             vec: bool | None = None):
    """One call of a build: a persistent one through ``ops.launch``
    (``vec`` None takes the wrapper's choice), an earlier one through its
    own C entry (it picks its instance)."""
    if persistent:
        return adc_ops.launch(lib, lut, plane, ids, live, vec)
    out = torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
    fn = getattr(lib, "pq_adc_fused_u8" if plane.dtype == torch.uint8
                 else "pq_adc_fused_i32")
    fn.argtypes, fn.restype = ADC_PARENT_ARGTYPES, ctypes.c_int
    b, m, k = lut.shape
    err = fn(lut.data_ptr(), plane.data_ptr(), ids.data_ptr(),
             live.data_ptr(), out.data_ptr(), b, ids.shape[1], m, k,
             plane.shape[0], torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "pq_adc_fused")
    return out


def adc_case(name: str, dev):
    """The inputs of edge shape ``name`` on ``dev``: lut (b, m, k) f32, an
    (ADC_ROWS, m) plane (a view ``offset`` bytes into its buffer), ids and
    live."""
    b, c, m, k, dtype, dup, mask, offset, layout = ADC_SHAPES[name]
    rng = np.random.default_rng(len(name) + 200)
    lut = torch.tensor(rng.normal(size=(b, m, k)), dtype=torch.float32,
                       device=dev)
    codes = torch.tensor(rng.integers(0, k, (ADC_ROWS, m)).astype(dtype),
                         device=dev)
    plane = misaligned_copy(codes, offset) if offset else codes
    if layout == "random":
        ids = rng.integers(-3, ADC_ROWS + 3, (b, c)).astype(np.int32)
        if dup:
            ids = np.concatenate([ids[:, : (c + 1) // 2]] * 2, -1)[:, :c]
        live = rng.random((b, c)) < 0.8
    else:
        ids, live = sq8_layout(rng, b, c, ADC_ROWS, layout)
    if mask == "all":
        live[:] = False
    elif mask is not None:
        live[mask] = False
    return (lut, plane, torch.tensor(ids, device=dev),
            torch.tensor(live, device=dev))


def adc_bench_shape(dev):
    """kernel_bench's full pq_adc inputs, made as it makes them."""
    b, m, k, n, c = ADC_BENCH
    rng = np.random.default_rng(0)
    lut = torch.from_numpy(rng.normal(size=(b, m, k)).astype(
        np.float32)).to(dev)
    plane = torch.from_numpy(rng.integers(0, k, (n, m)).astype(
        np.uint8)).to(dev)
    ids = torch.from_numpy(rng.integers(0, n, (b, c)).astype(np.int32))
    live = torch.from_numpy(rng.random((b, c)) < 0.9)
    return lut, plane, ids.to(dev), live.to(dev)


def adc_plain(lut, plane, ids, live):
    """The plain version in ADC_PLAIN_CHUNK-query pieces."""
    return torch.cat([adc_ref.pq_adc_fused(
        lut[s:s + ADC_PLAIN_CHUNK], plane, ids[s:s + ADC_PLAIN_CHUNK],
        live[s:s + ADC_PLAIN_CHUNK])
        for s in range(0, lut.shape[0], ADC_PLAIN_CHUNK)])


def adc_instances(lib, lut, plane) -> list:
    """The ``vec`` flags a persistent build runs at: the wrapper's choice
    first, then the scalar instance where that was the vector one."""
    vec, _ = adc_ops.choose(lib, lut, plane)
    return [True, False] if vec else [False]


def adc_check(libs: dict, persistent: dict, sname: str, lut, plane, ids,
              live, failed: list) -> None:
    """Every build in each instance the plane allows against the parent
    bit for bit and the plain version within ADC_TOL (``--cut``'s builds
    are left out: they compute something else)."""
    want = adc_plain(lut, plane, ids, live)
    base = call_adc(libs["parent"], persistent["parent"], lut, plane, ids,
                    live)
    runs = [("parent", "misaligned copy", lambda: call_adc(
        libs["parent"], persistent["parent"], lut,
        misaligned_copy(plane, plane.element_size()), ids, live))]
    for name, lib in libs.items():
        if not persistent[name] or name.startswith("cut_"):
            continue
        for vec in adc_instances(lib, lut, plane):
            inst = adc_ops.INSTANCES[adc_ops.plan(
                lib, lut.shape[1], lut.shape[2], plane.element_size(),
                vec).instance]
            runs.append((name, inst, lambda lib=lib, vec=vec: call_adc(
                lib, True, lut, plane, ids, live, vec)))
    for name, inst, run in runs:
        got = run()
        fin = torch.isfinite(want)
        ok = (torch.equal(torch.isneginf(got), torch.isneginf(want))
              and torch.allclose(got[fin], want[fin], rtol=ADC_TOL,
                                 atol=ADC_TOL))
        err = float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.
        same = torch.equal(got, base)
        print(f"[check] {sname} {name} {inst}: max abs err {err:.3g} "
              f"{'ok' if ok else 'FAILED'}; bitwise equal to the parent: "
              f"{same}", flush=True)
        if not ok or not same:
            failed.append(f"{name} {inst} at {sname}")


def adc_full_shapes(seed: int, dev):
    """The phase-5 opq candidate plane of chip_smoke.py from ``seed`` (its
    first batch), the same plane and live lanes with random ids, and
    kernel_bench's full shape."""
    rng = np.random.default_rng(seed)
    leaves = sm.synth_leaves(rng)
    qe, qt = sm.synth_queries(rng, sm.BATCH * sm.SMOKE_BATCHES)
    index = ckpt.index_from_numpy(leaves, "opq", device=dev)
    del leaves
    inp = sm.main_path_inputs(
        index, torch.from_numpy(qe[:sm.BATCH]).to(dev),
        torch.from_numpy(qt[:sm.BATCH]).to(dev).long())
    lut, plane, ids, live = (inp[k] for k in ("lut", "plane", "rows",
                                              "live"))
    del index, inp
    torch.cuda.empty_cache()
    yield "served", (lut, plane, ids, live)
    gen = torch.Generator(device=dev).manual_seed(seed)
    yield "no_reuse", (lut, plane, torch.randint(
        0, plane.shape[0], ids.shape, generator=gen, device=dev,
        dtype=torch.int32), live)
    del lut, plane, ids, live
    torch.cuda.empty_cache()
    yield "kernel_bench", adc_bench_shape(dev)


def adc_traffic(libs: dict, persistent: dict, lut, plane, ids,
                live) -> dict:
    """What a call asks of the card: live lanes, distinct live rows, the
    row bytes each live lane's read requests, and each build's LUT bytes
    staged (the earlier kernel: a copy per 8,192-slot block)."""
    b, m, k = lut.shape
    c = ids.shape[1]
    rows = ids.long().clamp(0, plane.shape[0] - 1)
    n_live = int(live.sum())
    out = dict(live=n_live, distinct=torch.unique(rows[live]).numel(),
               row_bytes=n_live * m * plane.element_size())
    for name, lib in libs.items():
        if persistent[name]:
            vec, p = adc_ops.choose(lib, lut, plane)
            n = adc_ops.lut_stagings(b, c, adc_ops.grid_size(b * c, p))
        else:
            n = b * -(-c // 8192)
        out[f"lut_bytes_{name}"] = n * m * k * 4
    return out


def profiled_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Mean device time (ms) a call spends in kernels whose name holds
    ``adc_fused`` (both builds' kernels), by torch.profiler over ``reps``
    calls, L2 flushed before each: the card's time alone, whatever the
    host's."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "adc_fused" in e.key)
    return us / reps / 1e3


def adc_main(args) -> dict:
    src = _build.SOURCES["pq_adc_fused"]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    sources = {"parent": args.parent, "new": src}
    for i, consts in enumerate(args.variant):
        sources[f"variant{i}"] = OUT_DIR / f"adc_variant{i}.cu"
        sources[f"variant{i}"].write_text(
            variant_source(src.read_text(), consts))
        print(f"[variant] variant{i}: {consts}")
    for cut, (pattern, stand_in) in (ADC_CUTS.items() if args.cut else ()):
        text, n = pattern.subn(stand_in, src.read_text())
        if n != 1:
            sys.exit(f"--cut {cut}: found {n} matches in the source, want 1")
        sources[f"cut_{cut}"] = OUT_DIR / f"adc_cut_{cut}.cu"
        sources[f"cut_{cut}"].write_text(text)
    persistent = {name: persistent_entry(path.read_text())
                  for name, path in sources.items()}
    libs = build(sources)
    if args.sass:
        report_sass(libs, args.sass, "adc")
    dev = torch.device("cuda", torch.cuda.current_device())
    failed, report = [], {}
    for sname in ADC_SHAPES:
        adc_check(libs, persistent, sname, *adc_case(sname, dev), failed)
    timer = Timer(queued=True)
    for sname, (lut, plane, ids, live) in adc_full_shapes(args.seed, dev):
        b, m, k = lut.shape
        c = ids.shape[1]
        adc_check(libs, persistent, sname, lut, plane, ids, live, failed)
        if sname == "served":
            fused = call_adc(libs["new"], True, lut, plane, ids, live)
            unfused = adc_ops.pq_adc(lut, plane[ids.long()])
            same = torch.equal(fused[live], unfused[live])
            print(f"[check] served new: bitwise equal to pq_adc on "
                  f"{int(live.sum())} live lanes: {same}", flush=True)
            if not same:
                failed.append("new against pq_adc at served")
            del fused, unfused
        tr = adc_traffic(libs, persistent, lut, plane, ids, live)
        flops, nbytes = adc_ops.fused_work(b, c, m, k, plane.element_size(),
                                           tr["live"], tr["distinct"])
        bound = 1e3 * max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)
        print(f"[traffic] {sname} B={b} C={c} m={m} k={k}: {tr['live']} "
              f"live lanes over {tr['distinct']} distinct rows; row bytes "
              f"requested {tr['row_bytes'] / 1e9:.3f} GB; bound bytes "
              f"{nbytes / 1e9:.3f} GB; LUT bytes staged " + ", ".join(
                  f"{n[10:]} {v / 1e6:.1f} MB" for n, v in tr.items()
                  if n.startswith("lut_bytes_")), flush=True)

        def run(name, vec=None, plane=plane):
            return lambda: call_adc(libs[name], persistent[name], lut, plane,
                                    ids, live, vec)
        times = {}
        for name in ("parent", "new", "new", "parent"):
            times.setdefault(name, []).append(timer.ms(run(name), args.reps))
        for name in libs:
            if name not in times:
                times[name] = [timer.ms(run(name), args.reps)]
        mis = misaligned_copy(plane, plane.element_size())
        times["parent_scalar"] = [timer.ms(run("parent", plane=mis),
                                           max(args.reps // 4, 3))]
        times["new_scalar"] = [timer.ms(run("new", False),
                                        max(args.reps // 4, 3))]
        del mis
        for name in libs:
            times[f"{name}_device"] = [profiled_ms(run(name), args.reps,
                                                   timer.flush)]
        if sname == "kernel_bench":
            times["unfused"] = [timer.ms(lambda: torch.where(
                live, adc_ops.pq_adc(lut, plane[ids.long()]), -torch.inf),
                args.reps) for _ in range(2)]
        report_times(sname, bound, times)
        report[sname] = dict(bound_ms=bound, **tr, **times)
    if failed:      # after the times, which still tell where time goes
        print(json.dumps(report))
        sys.exit(f"disagrees: {', '.join(failed)}")
    return report


def main(argv=None) -> None:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    report = {"assign_argmax": assign_main, "flash_attention": flash_main,
              "pq_adc_fused": adc_main, "sq8_dot_fused": sq8_main,
              "topk_scores": topk_main}[args.kernel](args)
    print(json.dumps(report))


if __name__ == "__main__":
    main()

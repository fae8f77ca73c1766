"""Checked wrappers of the dispatch top-k and KMeans assignment kernels
(port of ``repro/kernels/assign_topk/ops.py``: ``topk_scores`` and
``assign_argmax``).

``topk_scores`` replaces the TPU kernel
``repro/kernels/assign_topk/kernel.py::_topk_kernel`` (+
``_select_topk``).  On the H100 it is bound by operations: 2·N·L·h
fp32 FMAs, kept off the TF32 tensor cores so dispatch ids match the fp32
plain path on near-ties.  ``csrc/topk_scores.cu`` streams queries ×
centroids through shared memory by double-buffered ``cp.async`` copies
into 4 × 8 register tiles fed by 128-bit shared reads (the (N, L) plane
never reaches device memory).  At the end of each tile every score is
tested in registers against its query's running k-th, and only those
that beat it enter a small per-query buffer (ballot-ranked slots); one
warp a query merges the buffer into a sorted running list by a bitonic
network in registers (warp shuffles), a round more wherever a buffer
filled.  The centroids are split over parallel slices to fill the card,
and the last block of each query tile merges the slice lists by a tree
of pairwise merges — one launch.  The tile shape and the blocks an SM
holds come from the library (:func:`tiles`); :func:`n_slices` sizes the
slices from them.

The reference wrapper pads L with zero rows masked through ``l_true``;
here the kernel bounds-checks the ragged edge itself, so nothing is
padded, and never with duplicate rows (unsafe for top-k).

``assign_argmax`` replaces the TPU kernel
``repro/kernels/assign_topk/kernel.py::_assign_kernel``: per point, the
max and argmax of ⟨x, c⟩ − ½‖c‖² over the centroids, ties to the lower
index.  Bound by operations (2·N·L·h fp32 FMAs, kept off TF32 so
assignments match the fp32 plain version).  ``csrc/assign_argmax.cu``
writes ½‖c‖² into a (m, L) scratch first (a second launch of the same
call, counted once), then, for h > 16, streams point × centroid rows
through shared memory by double-buffered 16-byte ``cp.async`` copies
into 8 × 8 register tiles fed by 128-bit shared reads, and for PQ's
narrow fragments (h ≤ 16) keeps each thread's points in registers
against a codebook staged in shared memory.  Each thread keeps running
(max, argmax) pairs that only a strictly greater score replaces and
merges them at the end, every score one fmaf per feature in feature
order, so results equal the earlier kernel's bit for bit.  No (N, L)
plane exists, so one call covers a whole batch (m, N, h) × (m, L, h);
the ragged N and L edges are masked in the kernel, where the reference
wrapper pads L with copies of centroid 0.  :func:`assign_vector_loads`
chooses the 16-byte copies (else 4-byte ones); PERF.md §6 has the
kernel's registers and times.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor
launches the kernel on the current stream, without synchronizing, or
raises.  :data:`launches` counts ``topk_scores`` launches and
:data:`assign_launches` ``assign_argmax`` launches.  ``topk_scores`` on
fake CUDA tensors (the dry run, :mod:`repro_torch.launch.cells`) takes
its fake path: the launch's outputs and scratch, shaped by
:data:`HOPPER_TILES`, nothing built or launched; both CUDA paths add
:func:`work`'s count to the dry run's tally (:mod:`repro_torch.work`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch import work as work_mod
from repro_torch.kernels import _build
from repro_torch.kernels.assign_topk import ref

#: kernel launches in this process (CPU calls do not count)
launches = 0
assign_launches = 0

MAX_K = 128          # list slots per query in the kernel (kMaxK)
MAX_BATCH = 65_535   # assign_argmax's batch axis is grid z


def _check(x, emb, k) -> None:
    if x.dim() != 2 or emb.dim() != 2 or x.shape[1] != emb.shape[1]:
        raise ValueError(f"x (N, h) and emb (L, h) must share h, got "
                         f"{tuple(x.shape)} and {tuple(emb.shape)}")
    if x.dtype != torch.float32 or emb.dtype != torch.float32:
        raise ValueError(f"x and emb must be float32, got {x.dtype}, "
                         f"{emb.dtype}")
    if x.device != emb.device:
        raise ValueError(f"x on {x.device}, emb on {emb.device}")
    if not 1 <= k <= emb.shape[0]:
        raise ValueError(f"k={k} must lie in [1, L={emb.shape[0]}]")


class Tiles(NamedTuple):
    """A ``topk_scores`` build's tile shape and residency."""
    queries_per_block: int
    centroid_tile: int
    blocks_per_sm: int


#: ``topk_tiles`` of the built library on an H100 (smoke phase 27a
#: holds it equal), which the fake path shapes its scratch by
HOPPER_TILES = Tiles(queries_per_block=32, centroid_tile=256,
                     blocks_per_sm=1)
#: SMs of an H100 SXM, the fake path's where no card is visible
HOPPER_SMS = 132

#: ctypes signature of ``topk_scores_launch`` (csrc/topk_scores.cu)
ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_TILES: dict[int, Tiles] = {}     # device index → the built library's


def tiles(lib: ctypes.CDLL) -> Tiles:
    """The tile shape of a built ``topk_scores`` library and how many of
    its blocks fit an SM of the current device."""
    vals = [ctypes.c_int() for _ in Tiles._fields]
    fn = lib.topk_scores_tiles
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * len(vals)
    fn.restype = ctypes.c_int
    _build.check(lib, fn(*map(ctypes.byref, vals)), "topk_scores_tiles")
    return Tiles(*(v.value for v in vals))


def n_slices(n: int, l: int, sms: int, tl: Tiles) -> int:
    """Centroid slices per query tile: as many as one wave of
    ``tl.blocks_per_sm`` blocks on each of ``sms`` SMs holds, at least
    one, spread so that every slice gets the same whole number of
    centroid tiles (the last slice may be short)."""
    q_tiles = -(-n // tl.queries_per_block)
    c_tiles = -(-l // tl.centroid_tile)
    want = min(max(1, tl.blocks_per_sm * sms // q_tiles), c_tiles)
    return -(-c_tiles // -(-c_tiles // want))


def buffers(x: torch.Tensor, k: int, tl: Tiles, slices: int) -> list:
    """Fresh outputs and zeroed scratch of one launch: out_s, out_i
    (N, k), part_s, part_i (N, slices, k), counters (ceil(N / qb),)."""
    n, dev = x.shape[0], x.device
    return [torch.empty((n, k), dtype=torch.float32, device=dev),
            torch.empty((n, k), dtype=torch.int32, device=dev),
            torch.empty((n, slices, k), dtype=torch.float32, device=dev),
            torch.empty((n, slices, k), dtype=torch.int32, device=dev),
            torch.zeros(-(-n // tl.queries_per_block), dtype=torch.int32,
                        device=dev)]


def kernel_args(x, emb, bufs: list, k: int, slices: int,
                stream: int) -> list:
    """The arguments of ``topk_scores_launch``, in :data:`ARGTYPES`'
    order."""
    return [x.data_ptr(), emb.data_ptr(), *(b.data_ptr() for b in bufs),
            x.shape[0], emb.shape[0], x.shape[1], k, slices, stream]


def launch(lib: ctypes.CDLL, x, emb, k: int, slices: int, bufs: list
           ) -> None:
    """One launch of ``lib``'s kernel on the current stream; raises if
    the launch is refused."""
    fn = lib.topk_scores_launch
    fn.argtypes, fn.restype = ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*kernel_args(x, emb, bufs, k, slices, stream))
    _build.check(lib, err, "topk_scores")


def work(n: int, l: int, h: int, k: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one call: 2·N·L·h, and x, emb read once and the
    (N, k) scores and ids written once."""
    return 2 * n * l * h, 4 * (n * h + l * h) + 8 * n * k


def _count(x, emb, k: int) -> None:
    work_mod.add_kernel("topk_scores", *work(x.shape[0], emb.shape[0],
                                             x.shape[1], k))


def topk_scores(x: torch.Tensor, emb: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (N, h) f32; emb (L, h) f32 → ((N, k) f32 scores, (N, k) i32
    ids): per row, the k largest ⟨x, emb_j⟩, score descending and lowest
    index first on ties (``lax.top_k`` order)."""
    global launches
    _check(x, emb, k)
    if x.device.type == "cpu":
        return ref.topk_scores(x, emb, k)
    if x.device.type != "cuda":
        raise ValueError(f"topk_scores runs on cpu or cuda, not {x.device}")
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds the kernel's {MAX_K} list slots")
    if not (x.is_contiguous() and emb.is_contiguous()):
        raise ValueError("topk_scores needs contiguous inputs")
    n, l = x.shape[0], emb.shape[0]
    if n == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=x.device),
                torch.empty((0, k), dtype=torch.int32, device=x.device))
    if work_mod.is_fake(x):
        sms = (torch.cuda.get_device_properties(x.device)
               .multi_processor_count if torch.cuda.is_available()
               else HOPPER_SMS)
        bufs = buffers(x, k, HOPPER_TILES,
                       n_slices(n, l, sms, HOPPER_TILES))
        _count(x, emb, k)
        return bufs[0], bufs[1]
    lib = _build.library("topk_scores")
    dev = x.device.index
    tl = _TILES.get(dev)
    if tl is None:
        with torch.cuda.device(dev):
            tl = _TILES[dev] = tiles(lib)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slices = n_slices(n, l, sms, tl)
    bufs = buffers(x, k, tl, slices)
    launch(lib, x, emb, k, slices, bufs)
    launches += 1
    _count(x, emb, k)
    return bufs[0], bufs[1]


#: ctypes signature of ``assign_argmax_launch`` (csrc/assign_argmax.cu)
ASSIGN_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def assign_vector_loads(xb: torch.Tensor, cb: torch.Tensor) -> bool:
    """Whether ``assign_argmax``'s 16-byte copies can read x (m, N, h)
    and centroids (m, L, h): both bases 16-byte aligned, h and x's row
    stride (and batch stride, for m > 1) multiples of 4 floats.  The C
    entry refuses the flag on anything else."""
    m, _, h = xb.shape
    return (h % 4 == 0 and xb.data_ptr() % 16 == 0
            and cb.data_ptr() % 16 == 0 and xb.stride(1) % 4 == 0
            and (m == 1 or xb.stride(0) % 4 == 0))


def assign_buffers(xb: torch.Tensor, cb: torch.Tensor) -> list:
    """Fresh outputs and scratch of one call: out_s, out_i (m, N) and
    the ½‖c‖² scratch (m, L)."""
    (m, n, _), dev = xb.shape, xb.device
    return [torch.empty((m, n), dtype=torch.float32, device=dev),
            torch.empty((m, n), dtype=torch.int32, device=dev),
            torch.empty(cb.shape[:2], dtype=torch.float32, device=dev)]


def assign_kernel_args(xb, cb, bufs: list, vec: bool, stream: int) -> list:
    """The arguments of ``assign_argmax_launch``, in
    :data:`ASSIGN_ARGTYPES`' order."""
    m, n, h = xb.shape
    return [xb.data_ptr(), cb.data_ptr(), *(b.data_ptr() for b in bufs),
            xb.stride(0), xb.stride(1), m, n, cb.shape[1], h, int(vec),
            stream]


def assign_argmax(x: torch.Tensor, centroids: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (N, h) f32, centroids (L, h) f32 → ((N,) f32 best scores,
    (N,) i32 ids): per point the max and argmax of ⟨x, c_j⟩ − ½‖c_j‖²,
    lowest index on ties; or batched over a leading axis, (m, N, h) ×
    (m, L, h) → ((m, N), (m, N)).  ``x`` may be a strided view whose
    last dim is unit-stride."""
    global assign_launches
    if x.dim() not in (2, 3) or centroids.dim() != x.dim():
        raise ValueError(f"x (N, h) / (m, N, h) and centroids of the same "
                         f"rank expected, got {tuple(x.shape)} and "
                         f"{tuple(centroids.shape)}")
    if (x.shape[-1] != centroids.shape[-1]
            or x.shape[:-2] != centroids.shape[:-2]):
        raise ValueError(f"x {tuple(x.shape)} and centroids "
                         f"{tuple(centroids.shape)} must share the batch "
                         f"and h")
    if x.dtype != torch.float32 or centroids.dtype != torch.float32:
        raise ValueError(f"x and centroids must be float32, got {x.dtype}, "
                         f"{centroids.dtype}")
    if x.device != centroids.device:
        raise ValueError(f"x on {x.device}, centroids on {centroids.device}")
    if centroids.shape[-2] < 1 or x.shape[-1] < 1:
        raise ValueError("no centroids or no features")
    if x.device.type == "cpu":
        return ref.assign_argmax(x, centroids)
    if x.device.type != "cuda":
        raise ValueError(f"assign_argmax runs on cpu or cuda, not "
                         f"{x.device}")
    xb = x if x.dim() == 3 else x[None]
    cb = centroids if centroids.dim() == 3 else centroids[None]
    if xb.shape[0] > MAX_BATCH:
        raise ValueError(f"batch {xb.shape[0]} exceeds the kernel's "
                         f"{MAX_BATCH}")
    if xb.stride(2) != 1 or not cb.is_contiguous():
        raise ValueError("assign_argmax needs unit-stride features in x and "
                         "contiguous centroids")
    bufs = assign_buffers(xb, cb)
    if xb.shape[1]:
        lib = _build.library("assign_argmax")
        fn = lib.assign_argmax_launch
        fn.argtypes, fn.restype = ASSIGN_ARGTYPES, ctypes.c_int
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(*assign_kernel_args(xb, cb, bufs,
                                         assign_vector_loads(xb, cb),
                                         stream))
        _build.check(lib, err, "assign_argmax")
        assign_launches += 1
    out_s, out_i = bufs[0], bufs[1]
    if x.dim() == 2:
        return out_s[0], out_i[0]
    return out_s, out_i

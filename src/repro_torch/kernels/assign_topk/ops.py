"""Checked wrappers of the dispatch top-k and KMeans assignment kernels
(port of ``repro/kernels/assign_topk/ops.py``: ``topk_scores`` and
``assign_argmax``).

``topk_scores`` replaces the TPU kernel
``repro/kernels/assign_topk/kernel.py::_topk_kernel`` (+
``_select_topk``).  On the H100 it is bound by operations: 2·N·L·h
fp32 FMAs, kept off the TF32 tensor cores so dispatch ids match the fp32
plain path on near-ties.  ``csrc/topk_scores.cu`` tiles queries × centroids
through shared memory with register tiles, merges each score tile into a
running top-k in shared memory (the (N, L) plane never reaches device
memory), splits the centroids over parallel slices to fill the card, and
merges the slice lists in the last block of each query tile — one launch.

The reference wrapper pads L with zero rows masked through ``l_true``;
here the kernel bounds-checks the ragged edge itself, so nothing is
padded, and never with duplicate rows (unsafe for top-k).

``assign_argmax`` replaces the TPU kernel
``repro/kernels/assign_topk/kernel.py::_assign_kernel``: per point, the
max and argmax of ⟨x, c⟩ − ½‖c‖² over the centroids, ties to the lower
index.  Bound by operations (2·N·L·h fp32 FMAs, kept off TF32 so
assignments match the fp32 plain version);
``csrc/assign_argmax.cu`` tiles points × centroids through shared
memory with 8 × 8 register tiles, sums ½‖c‖² once per centroid tile,
and keeps a running (max, argmax) per point that only a strictly
greater score replaces.  No (N, L) plane exists, so one launch covers a
whole batch (m, N, h) × (m, L, h); the ragged N and L edges are masked
in the kernel, where the reference wrapper pads L with copies of
centroid 0.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor
launches the kernel on the current stream, without synchronizing, or
raises.  :data:`launches` counts ``topk_scores`` launches and
:data:`assign_launches` ``assign_argmax`` launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.assign_topk import ref

#: kernel launches in this process (CPU calls do not count)
launches = 0
assign_launches = 0

MAX_K = 128          # list slots per query in the kernel (kMaxK)
QUERIES_PER_BLOCK = 16
CENTROID_TILE = 64
BLOCKS_PER_SM = 4    # slices are sized for about this many blocks per SM
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


def n_slices(n: int, l: int, device: torch.device) -> int:
    """Centroid slices per query tile: enough blocks for
    :data:`BLOCKS_PER_SM` per SM, at most one slice per centroid tile."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    q_tiles = -(-n // QUERIES_PER_BLOCK)
    want = -(-BLOCKS_PER_SM * sms // q_tiles)
    return max(1, min(want, -(-l // CENTROID_TILE)))


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
    n, h = x.shape
    l = emb.shape[0]
    out_s = torch.empty((n, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((n, k), dtype=torch.int32, device=x.device)
    if n == 0:
        return out_s, out_i
    slices = n_slices(n, l, x.device)
    part_s = torch.empty((n, slices, k), dtype=torch.float32,
                         device=x.device)
    part_i = torch.empty((n, slices, k), dtype=torch.int32, device=x.device)
    counters = torch.zeros(-(-n // QUERIES_PER_BLOCK), dtype=torch.int32,
                           device=x.device)
    lib = _build.library("topk_scores")
    fn = lib.topk_scores_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), emb.data_ptr(), out_s.data_ptr(),
                 out_i.data_ptr(), part_s.data_ptr(), part_i.data_ptr(),
                 counters.data_ptr(), n, l, h, k, slices, stream)
    _build.check(lib, err, "topk_scores")
    launches += 1
    return out_s, out_i


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
    m, n, h = xb.shape
    if m > MAX_BATCH:
        raise ValueError(f"batch {m} exceeds the kernel's {MAX_BATCH}")
    if xb.stride(2) != 1 or not cb.is_contiguous():
        raise ValueError("assign_argmax needs unit-stride features in x and "
                         "contiguous centroids")
    out_s = torch.empty((m, n), dtype=torch.float32, device=x.device)
    out_i = torch.empty((m, n), dtype=torch.int32, device=x.device)
    if n:
        lib = _build.library("assign_argmax")
        fn = lib.assign_argmax_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(xb.data_ptr(), cb.data_ptr(), out_s.data_ptr(),
                     out_i.data_ptr(), xb.stride(0), xb.stride(1), m, n,
                     cb.shape[1], h, stream)
        _build.check(lib, err, "assign_argmax")
        assign_launches += 1
    if x.dim() == 2:
        return out_s[0], out_i[0]
    return out_s, out_i

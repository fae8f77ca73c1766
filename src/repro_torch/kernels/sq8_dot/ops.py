"""Checked wrapper of the fused SQ8 gather + dequantized dot kernel
(port of ``repro/kernels/sq8_dot/ops.py::sq8_dot_fused``).

Replaces the TPU kernel ``repro/kernels/sq8_dot/kernel.py::_sq8_fused_kernel``.
On the H100 it is bound by bytes: one h-byte code row per live slot,
gathered at random from a plane far larger than L2 (6.8 GB at the
``serve_msmarco`` shape), plus the ids, live flags and scores; the
arithmetic is one FMA per byte.  ``csrc/sq8_dot_fused.cu`` stages the
query's pre-scaled row in shared memory once per block, gives each
candidate to 16 lanes that read its row as 16-byte vectors (a scalar
path covers unaligned planes and h not a multiple of 16), reduces with
warp shuffles, and skips the row of dead lanes — no (B, C, h) tensor.

The kernel is bias-free, as on the TPU: the SQ8 scorer adds ⟨q, lo⟩
after the in-kernel mask (``-inf`` + bias stays ``-inf``).

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor
launches the kernel on the current stream, without synchronizing, or
raises.  :data:`launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sq8_dot import ref

#: kernel launches in this process (CPU calls do not count)
launches = 0

#: dynamic shared memory one block may use on sm_90 (227 KB)
MAX_SMEM = 232_448


def _check(q_scaled, codes_plane, ids, live) -> None:
    if q_scaled.dim() != 2 or q_scaled.dtype != torch.float32:
        raise ValueError(f"q_scaled must be (B, h) float32, got "
                         f"{tuple(q_scaled.shape)} {q_scaled.dtype}")
    b, h = q_scaled.shape
    if (codes_plane.dim() != 2 or codes_plane.shape[1] != h
            or codes_plane.dtype != torch.uint8):
        raise ValueError(f"codes_plane must be (N, {h}) uint8, got "
                         f"{tuple(codes_plane.shape)} {codes_plane.dtype}")
    if codes_plane.shape[0] < 1:
        raise ValueError("codes_plane has no rows")
    if ids.dim() != 2 or ids.shape[0] != b or ids.dtype != torch.int32:
        raise ValueError(f"ids must be ({b}, C) int32, got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    if live.shape != ids.shape or live.dtype != torch.bool:
        raise ValueError(f"live must be {tuple(ids.shape)} bool, got "
                         f"{tuple(live.shape)} {live.dtype}")
    devs = {t.device for t in (q_scaled, codes_plane, ids, live)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")


def sq8_dot_fused(q_scaled: torch.Tensor, codes_plane: torch.Tensor,
                  ids: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """q_scaled (B, h) f32 (queries times the per-dim scale);
    codes_plane (N, h) uint8; ids (B, C) int32 (clipped into [0, N));
    live (B, C) bool → (B, C) f32 bias-free scores
    ⟨q_scaled[b], codes_plane[ids[b, c]]⟩, ``-inf`` on lanes that are
    not live."""
    global launches
    _check(q_scaled, codes_plane, ids, live)
    if q_scaled.device.type == "cpu":
        return ref.sq8_dot_fused(q_scaled, codes_plane, ids, live)
    if q_scaled.device.type != "cuda":
        raise ValueError(f"sq8_dot_fused runs on cpu or cuda, not "
                         f"{q_scaled.device}")
    b, h = q_scaled.shape
    if h * 4 > MAX_SMEM:
        raise ValueError(f"query row of {h} floats ({h * 4} B) exceeds the "
                         f"{MAX_SMEM} B of shared memory a block can use")
    tensors = (q_scaled, codes_plane, ids, live)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sq8_dot_fused needs contiguous inputs")
    out = torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
    if out.numel() == 0:
        return out
    lib = _build.library("sq8_dot_fused")
    fn = lib.sq8_dot_fused
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), out.data_ptr(),
                 b, ids.shape[1], h, codes_plane.shape[0], stream)
    _build.check(lib, err, "sq8_dot_fused")
    launches += 1
    return out

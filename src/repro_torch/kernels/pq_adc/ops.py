"""Checked wrapper of the fused gather + ADC + mask kernel (port of
``repro/kernels/pq_adc/ops.py::pq_adc_fused``).

Replaces the TPU kernel ``repro/kernels/pq_adc/kernel.py::_adc_fused_kernel``.
On the H100 it is bound by bytes: one m-byte code row per live slot,
gathered at random from a plane far larger than L2, plus the ids, live
flags and scores.  ``csrc/pq_adc_fused.cu`` stages each query's LUT in
shared memory once per block, has each thread look up its candidate's m
codes directly (no one-hot product, no (B, C, m) tensor), skips the
code row of dead lanes and reads rows as 16-byte vectors.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor
launches the kernel on the current stream, without synchronizing, or
raises.  :data:`launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pq_adc import ref

#: kernel launches in this process (CPU calls do not count)
launches = 0

#: dynamic shared memory one block may use on sm_90 (227 KB)
MAX_SMEM = 232_448

_ENTRY = {torch.uint8: "pq_adc_fused_u8", torch.int32: "pq_adc_fused_i32"}


def _check(lut, codes_plane, ids, live) -> None:
    if lut.dim() != 3 or lut.dtype != torch.float32:
        raise ValueError(f"lut must be (B, m, k) float32, got "
                         f"{tuple(lut.shape)} {lut.dtype}")
    b, m, k = lut.shape
    if (codes_plane.dim() != 2 or codes_plane.shape[1] != m
            or codes_plane.dtype not in _ENTRY):
        raise ValueError(f"codes_plane must be (N, {m}) uint8 or int32, got "
                         f"{tuple(codes_plane.shape)} {codes_plane.dtype}")
    if codes_plane.shape[0] < 1:
        raise ValueError("codes_plane has no rows")
    if ids.dim() != 2 or ids.shape[0] != b or ids.dtype != torch.int32:
        raise ValueError(f"ids must be ({b}, C) int32, got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    if live.shape != ids.shape or live.dtype != torch.bool:
        raise ValueError(f"live must be {tuple(ids.shape)} bool, got "
                         f"{tuple(live.shape)} {live.dtype}")
    devs = {t.device for t in (lut, codes_plane, ids, live)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devs))}")


def pq_adc_fused(lut: torch.Tensor, codes_plane: torch.Tensor,
                 ids: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """lut (B, m, k) f32; codes_plane (N, m) uint8/int32; ids (B, C)
    int32 (clipped into [0, N)); live (B, C) bool → (B, C) f32 scores,
    ``-inf`` on lanes that are not live."""
    global launches
    _check(lut, codes_plane, ids, live)
    if lut.device.type == "cpu":
        return ref.pq_adc_fused(lut, codes_plane, ids, live)
    if lut.device.type != "cuda":
        raise ValueError(f"pq_adc_fused runs on cpu or cuda, not {lut.device}")
    b, m, k = lut.shape
    if m * k * 4 > MAX_SMEM:
        raise ValueError(f"LUT of {m}x{k} floats ({m * k * 4} B) exceeds the "
                         f"{MAX_SMEM} B of shared memory a block can use")
    tensors = (lut, codes_plane, ids, live)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("pq_adc_fused needs contiguous inputs")
    out = torch.empty(ids.shape, dtype=torch.float32, device=lut.device)
    if out.numel() == 0:
        return out
    lib = _build.library("pq_adc_fused")
    fn = getattr(lib, _ENTRY[codes_plane.dtype])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(lut.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), out.data_ptr(),
                 b, ids.shape[1], m, k, codes_plane.shape[0], stream)
    _build.check(lib, err, "pq_adc_fused")
    launches += 1
    return out

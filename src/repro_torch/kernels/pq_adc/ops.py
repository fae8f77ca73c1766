"""Checked wrappers of the two ADC kernels (port of
``repro/kernels/pq_adc/ops.py``: ``pq_adc_fused`` and ``pq_adc``).

``pq_adc_fused`` replaces the TPU kernel
``repro/kernels/pq_adc/kernel.py::_adc_fused_kernel``.  On the H100 it
is bound by bytes: one m-byte code row per live slot, gathered at
random from a plane far larger than L2, plus the ids, live flags and
scores.  ``csrc/pq_adc_fused.cu`` stages each query's LUT in shared
memory once per block, has each thread look up its candidate's m codes
directly (no one-hot product, no (B, C, m) tensor), skips the code row
of dead lanes and reads rows as 16-byte vectors.

``pq_adc`` replaces ``kernel.py::_adc_kernel`` (entry
``pq_adc_fragmajor``), the unfused ADC over codes the caller gathered
into a (B, C, m) tensor.  ``csrc/pq_adc.cu`` reads that tensor once, as
given, with the same LUT staging and the same j = 0..m−1 order of fp32
adds as ``pq_adc_fused.cu``: on the same codes the two kernels agree bit
for bit.  It is bound by the bytes of the codes tensor.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor
launches the kernel on the current stream, without synchronizing, or
raises.  :data:`launches` and :data:`unfused_launches` count kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pq_adc import ref

#: kernel launches in this process (CPU calls do not count):
#: pq_adc_fused, and pq_adc
launches = 0
unfused_launches = 0

#: dynamic shared memory one block may use on sm_90 (227 KB)
MAX_SMEM = 232_448

_ENTRY = {torch.uint8: "pq_adc_fused_u8", torch.int32: "pq_adc_fused_i32"}
_UNFUSED_ENTRY = {torch.uint8: "pq_adc_u8", torch.int32: "pq_adc_i32"}


def _check_lut_fits(m: int, k: int) -> None:
    if m * k * 4 > MAX_SMEM:
        raise ValueError(f"LUT of {m}x{k} floats ({m * k * 4} B) exceeds the "
                         f"{MAX_SMEM} B of shared memory a block can use")


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
    _check_lut_fits(m, k)
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


def pq_adc(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """lut (B, m, k) f32; codes (B, C, m) uint8/int32 in [0, k) → (B, C)
    f32 scores, ``out[b, c] = Σ_j lut[b, j, codes[b, c, j]]``.

    The reference's ``c_blk`` (its TPU candidate tile) and
    ``use_kernel`` (its switch to the jnp oracle) have no counterpart:
    the kernel reads the codes candidate-major with no padding, and the
    device of the inputs picks the kernel or the plain version."""
    global unfused_launches
    if lut.dim() != 3 or lut.dtype != torch.float32:
        raise ValueError(f"lut must be (B, m, k) float32, got "
                         f"{tuple(lut.shape)} {lut.dtype}")
    b, m, k = lut.shape
    if (codes.dim() != 3 or codes.shape[0] != b or codes.shape[2] != m
            or codes.dtype not in _UNFUSED_ENTRY):
        raise ValueError(f"codes must be ({b}, C, {m}) uint8 or int32, got "
                         f"{tuple(codes.shape)} {codes.dtype}")
    if lut.device != codes.device:
        raise ValueError(f"inputs on several devices: {lut.device}, "
                         f"{codes.device}")
    if lut.device.type == "cpu":
        return ref.pq_adc(lut, codes)
    if lut.device.type != "cuda":
        raise ValueError(f"pq_adc runs on cpu or cuda, not {lut.device}")
    if m < 1 or k < 1:
        raise ValueError(f"pq_adc needs m, k >= 1, got m={m}, k={k}")
    _check_lut_fits(m, k)
    if not (lut.is_contiguous() and codes.is_contiguous()):
        raise ValueError("pq_adc needs contiguous inputs")
    out = torch.empty(codes.shape[:2], dtype=torch.float32,
                      device=lut.device)
    if out.numel() == 0:
        return out
    lib = _build.library("pq_adc")
    fn = getattr(lib, _UNFUSED_ENTRY[codes.dtype])
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(lut.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(lut.data_ptr(), codes.data_ptr(), out.data_ptr(), b,
                 codes.shape[1], m, k, stream)
    _build.check(lib, err, "pq_adc")
    unfused_launches += 1
    return out

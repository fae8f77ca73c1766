"""Checked wrapper of the flash-attention forward kernel (port of
``repro/kernels/flash_attention/ops.py::flash_attention``, forward only;
the ``torch.autograd.Function`` whose backward recomputes through the
plain version comes with training).

Replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py::_flash_kernel``.  On the H100
it is bound by bytes at the HI²_sup term scorer's shape (S = 64: one
score tile per head, about 8 FLOPs per byte of q, k, v and out) and by
operations at long sequences.  ``csrc/flash_attention.cu`` gives one
block to each (batch, q-head, 64-row q tile) and loops over 64-row kv
tiles staged in shared memory, with the online-softmax state in
registers, fp32 FMAs (no TF32), fully-masked kv tiles skipped, and the
ragged edges masked from the true lengths.  It reads q, k and v through
their strides, so the (B, H, S, d) views of (B, S, H, d) projections cost
no copy, and writes ``out`` as a (B, H, S, d) view of (B, S, H, d)
memory, which the attention layer reshapes back for free.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor
launches the kernel on the current stream, without synchronizing, or
raises.  :data:`launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

#: kernel launches in this process (CPU calls do not count)
launches = 0

HEAD_DIMS = (16, 32, 64, 128)     # the kernel's template cases
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_YZ = 65_535              # q heads (grid y) and batch (grid z)
#: query rows per chunk of the plain version (bounds its score plane)
Q_CHUNK = 512


def _check(q, k, v, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q (B, Hq, Sq, d), k and v (B, Hkv, Sk, d) "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k / v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch or head dim")
    if k.shape[1] < 1 or hq % k.shape[1]:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={k.shape[1]}")
    if sq < 1 or k.shape[2] < 1:
        raise ValueError("empty query or key sequence")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"q, k, v on several devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if window < 0:
        raise ValueError(f"window={window} must be >= 0 (0: no window)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, Hq, Sq, d); k, v (B, Hkv, Sk, d), Hq a multiple of Hkv,
    float32 or bfloat16 → (out (B, Hq, Sq, d) in q's dtype, lse
    (B, Hq, Sq) f32).  Query head h reads kv head h // (Hq / Hkv); masks
    go by absolute position; a row with no visible key gives zeros and
    lse = -1e30."""
    global launches
    _check(q, k, v, window)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal, window, scale,
                                   q_chunk=Q_CHUNK)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of the kernel's "
                         f"{HEAD_DIMS}")
    if b > MAX_GRID_YZ or hq > MAX_GRID_YZ:
        raise ValueError(f"B={b} and Hq={hq} must be <= {MAX_GRID_YZ}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs unit-stride features "
                         "(last dim)")
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 12
                   + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), *strides, b, hq, hkv, sq, sk, d,
                 DTYPES[q.dtype], int(causal), int(window), float(scale),
                 stream)
    _build.check(lib, err, "flash_attention")
    launches += 1
    return out, lse

"""Checked, differentiable wrapper of the flash-attention forward kernel
(port of ``repro/kernels/flash_attention/ops.py::flash_attention`` and
its ``jax.custom_vjp``).

Under autograd (HI²_sup distillation trains through the term scorer)
:func:`flash_attention` is a ``torch.autograd.Function``: the forward
is the kernel on a CUDA tensor (its plain version on a CPU tensor),
and the backward recomputes the attention through the plain version
(``ref.attention``) under autograd, exactly as the reference's ``_bwd``
differentiates its ``ref.attention``.  The JAX package has no backward
Pallas kernel, so that recompute is the reference's own algorithm, not
a fallback, and there is no backward kernel to port.  The recompute
runs in blocks of query rows (:func:`_bwd_rows`), each differentiated
on its own over the keys its rows can see (:func:`_live_keys`: under a
causal mask the first q1 keys of a block ending at row q1), so its live
(B, Hq, rows, keys) f32 planes stay near :data:`BWD_PLANE` elements
however long the sequence: the reference's LM path differentiates
``attention_chunked``, the same function with a bounded plane, and at
S 4,096 the whole plane of an LM layer is 1-2 GB a sequence.  A block's
dq is its rows' own; dk and dv add the blocks' contributions in f32 and
round once to the inputs' dtype.  Where one block covers every row and
sees every key (S 64 and 50 at the HI²_sup and SASRec shapes) the
gradients are those of one recompute.  ``lse`` is
returned non-differentiable.  The forward saves q, k and v themselves
(never the kernel's output buffer), so the recompute reads nothing a
later launch writes.

Replaces the TPU kernel
``repro/kernels/flash_attention/kernel.py::_flash_kernel`` with two
kernels in ``csrc/flash_attention.cu``, one for each dtype; both give
each (batch, q-head, q tile) item one block that loops over the item's
live kv tiles (fully-masked tiles are skipped, the ragged edges masked
from the true lengths), with the online-softmax state in registers.

* bf16 (the LM shapes, bound by the tensor cores' operations): 128-row
  q tiles, 16 rows a warp, QKᵀ and P·V on ``mma.sync`` m16n8k16 with
  fp32 accumulation (a bf16 product is exact in fp32, so only the order
  of summation differs from the reference's f32 dot), operands by
  ``ldmatrix`` from 64-key K and V tiles that 16-byte ``cp.async``
  copies into a two-stage ring, the softmax in registers and P rounded
  to bf16 as the A operand of P·V (the one rounding it adds: ``out`` is
  bf16 and ``lse`` does not see it).  Instances at D in {16, 32, 64,
  80, 128}: stablelm-3b's d 80 has its own.
* f32 (the HI²_sup encoder and SASRec, bound by bytes at S 64 and d 64):
  64-row q tiles of 128 threads, products in fp32 FMAs (no TF32) fed by
  128-bit shared reads, four blocks an SM at d <= 64 so one block's
  loads overlap the others' FMAs.

Both read q, k and v through their strides, so the (B, H, S, d) views
of (B, S, H, d) projections cost no copy, and write ``out`` as a (B, H,
S, d) view of (B, S, H, d) memory, which the attention layer reshapes
back for free.  Inputs that are not 16-byte aligned
(:func:`vector_loads`) take the same kernel's element-wise load
instance.  A head dim d outside its dtype's :data:`HEAD_DIMS` (SASRec's
d = 50) runs in the next instance up (:func:`instance_dim`): the kernel
zero-fills columns d .. D - 1 as it loads them and never stores them,
so q, k and v are read in place, with no padded copy.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor
launches the kernel on the current stream, without synchronizing, or
raises.  :data:`launches` counts kernel launches (forward launches; the
backward launches none).  A fake CUDA tensor (the dry run,
:mod:`repro_torch.launch.cells`) takes the fake path: the kernel's
outputs, allocated as the launch allocates them, nothing built or
launched.  Both CUDA paths add :func:`work`'s count to the dry run's
tally (:mod:`repro_torch.work`).  On fake inputs the backward runs only
its largest block's recompute, for the working set it holds, and counts
every other block by :func:`recompute_flops`, which equals what
``torch.utils.flop_counter`` counts over that block's recompute.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch import work as work_mod
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

#: kernel launches in this process (CPU calls do not count)
launches = 0

#: the kernel instances (head dims D) of each dtype: the f32 FMA kernel's
#: and the bf16 tensor-core kernel's
HEAD_DIMS = {torch.float32: (16, 32, 64, 128),
             torch.bfloat16: (16, 32, 64, 80, 128)}
MAX_HEAD_DIM = 128                # any 1 <= d <= 128 runs (ragged above)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_ITEMS = 2 ** 31 - 1           # B · Hq · ceil(Sq / 64) work items
#: query rows per work item of the f32 kernel, which the item limit
#: counts (the bf16 kernel's items are 128 rows, so fewer)
Q_TILE = 64
#: query rows per chunk of the plain version (bounds its score plane)
Q_CHUNK = 512
#: elements of one (B, Hq, rows, Sk) f32 plane of the backward's recompute
BWD_PLANE = 2 ** 28
#: ctypes signature of ``flash_attention_fwd`` (csrc/flash_attention.cu)
ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 12
            + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int,
                                    ctypes.c_void_p])


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


def vector_loads(*tensors: torch.Tensor) -> bool:
    """Whether the kernel's 16-byte ``cp.async`` instance may read and
    write these (B, H, S, d) tensors: every base address 16-byte aligned
    and every batch, head and row stride a multiple of 16 bytes.  The
    feature stride must be 1 (ValueError otherwise); a tensor that fails
    only the alignment takes the element-wise instance."""
    if any(t.stride(3) != 1 for t in tensors):
        raise ValueError("flash_attention needs unit-stride features "
                         "(last dim)")
    return all(t.data_ptr() % 16 == 0
               and all(s * t.element_size() % 16 == 0
                       for s in t.stride()[:3])
               for t in tensors)


def outputs(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fresh (out, lse) for the kernel: out (B, Hq, Sq, d) in q's dtype
    as a view of (B, Sq, Hq, d) memory, lse (B, Hq, Sq) f32."""
    b, hq, sq, d = q.shape
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    return out, torch.empty((b, hq, sq), dtype=torch.float32,
                            device=q.device)


def kernel_args(q, k, v, out, lse, causal: bool, window: int, scale: float,
                vec: bool, stream: int) -> list:
    """The arguments of ``flash_attention_fwd``, in :data:`ARGTYPES`'
    order."""
    b, hq, sq, d = q.shape
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    return [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *strides, b, hq, k.shape[1], sq, k.shape[2], d,
            DTYPES[q.dtype], int(causal), int(window), float(scale),
            int(vec), stream]


def instance_dim(d: int, dtype: torch.dtype = torch.float32) -> int:
    """The kernel instance that runs head dim ``d`` in ``dtype``: the
    least of its :data:`HEAD_DIMS` >= d (``d`` itself when it is one)."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is outside the kernel's 1 .. "
                         f"{MAX_HEAD_DIM}")
    return next(h for h in HEAD_DIMS[dtype] if h >= d)


def instance_name(d: int, dtype: torch.dtype) -> str:
    """Which kernel and instance runs head dim ``d`` in ``dtype``, e.g.
    ``"tensor-core D 80"`` (bf16) or ``"fp32 FMA D 64"`` (f32)."""
    kind = "tensor-core" if dtype == torch.bfloat16 else "fp32 FMA"
    return f"{kind} D {instance_dim(d, dtype)}"


def visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the masks leave visible, query row i and
    key j at absolute positions i and j (:func:`_live_keys` a row)."""
    i = np.arange(sq, dtype=np.int64)
    k0 = np.maximum(0, i - window + 1) if window > 0 else np.zeros_like(i)
    if causal:
        k1 = i + 1
    elif window > 0:
        k1 = i + window
    else:
        k1 = np.full_like(i, sk)
    k0 = np.minimum(k0, sk)
    return int(np.maximum(np.minimum(k1, sk) - k0, 0).sum())


def work(b: int, hq: int, hkv: int, sq: int, sk: int, d: int,
         causal: bool, window: int, elem: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one forward: the two products over the visible
    pairs (4·B·Hq·d a pair), and q, k, v and out read or written once in
    ``elem``-byte elements, lse in f32."""
    flops = 4 * b * hq * d * visible_pairs(sq, sk, causal, window)
    nbytes = elem * (2 * b * hq * sq * d + 2 * b * hkv * sk * d)
    return flops, nbytes + 4 * b * hq * sq


def _count(q, k, causal: bool, window: int) -> None:
    b, hq, sq, d = q.shape
    work_mod.add_kernel("flash_attention", *work(
        b, hq, k.shape[1], sq, k.shape[2], d, causal, window,
        q.element_size()))


def _check_launch(q) -> None:
    b, hq, sq, d = q.shape
    instance_dim(d, q.dtype)          # raises above MAX_HEAD_DIM
    if b * hq * -(-sq // Q_TILE) > MAX_ITEMS:
        raise ValueError(f"B·Hq·ceil(Sq/{Q_TILE}) must be <= {MAX_ITEMS}")


def _fake(q, k, causal: bool, window: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fake path on fake CUDA tensors: the launch's outputs, no
    launch."""
    _check_launch(q)
    _count(q, k, causal, window)
    return outputs(q)


def _launch(q, k, v, causal: bool, window: int, scale: float
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors (already checked) → (out, lse)."""
    global launches
    _check_launch(q)
    out, lse = outputs(q)
    vec = vector_loads(q, k, v, out)
    lib = _build.library("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*kernel_args(q, k, v, out, lse, causal, window, scale, vec,
                              stream))
    _build.check(lib, err, "flash_attention")
    launches += 1
    _count(q, k, causal, window)
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU).  Backward:
    autograd through ``ref.attention`` on the saved q, k, v — the
    reference's ``_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        if q.device.type == "cpu":
            out, lse = ref.flash_attention(q, k, v, causal, window, scale,
                                           q_chunk=Q_CHUNK)
        elif work_mod.is_fake(q):
            out, lse = _fake(q, k, causal, window)
        else:
            out, lse = _launch(q, k, v, causal, window, scale)
        ctx.save_for_backward(q, k, v)
        ctx.attn = (causal, window, scale)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, grad_out, _grad_lse):
        causal, window, scale = ctx.attn
        q, k, v = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        blocks = bwd_blocks(q, k, causal, window)
        fake = work_mod.is_fake(q)
        if fake:
            # the largest block's recompute runs (its working set is the
            # backward's peak); every other block is counted, not run
            blocks = [max(blocks, key=lambda blk: (blk[1] - blk[0])
                          * (blk[3] - blk[2]))]
        dq = []
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        with (work_mod.counting(local=True) if fake
              else contextlib.nullcontext()) as ran:
            for q0, q1, k0, k1 in blocks:
                if k0 == k1:              # rows that see no key: out 0
                    dq.append(torch.zeros(q[:, :, q0:q1].shape,
                                          dtype=torch.float32,
                                          device=q.device))
                    continue
                gq, gk, gv = _recompute(q, k, v, grad_out, q0, q1, k0, k1,
                                        causal, window, scale)
                dq.append(gq)
                dk[:, :, k0:k1] += gk
                dv[:, :, k0:k1] += gv
        if fake:
            dq = _fake_dq(q, k, blocks[0], dq[0], ran.op_bytes, causal,
                          window)
        else:
            dq = torch.cat(dq, dim=2)
        grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
        return tuple(g if n else None for g, n in zip(grads, need)) + (
            None,) * 3


def _recompute(q, k, v, grad_out, q0: int, q1: int, k0: int, k1: int,
               causal: bool, window: int, scale: float) -> tuple:
    """One block of the backward: query rows [q0, q1) against keys
    [k0, k1), differentiated through the plain version in f32 → (dq
    rows, dk and dv over [k0, k1))."""
    qf = q[:, :, q0:q1].detach().float().requires_grad_(True)
    kf, vf = (t[:, :, k0:k1].detach().float().requires_grad_(True)
              for t in (k, v))
    with torch.enable_grad():
        out, _ = ref.flash_attention(qf, kf, vf, causal, window, scale,
                                     q_offset=q0, k_offset=k0)
        return torch.autograd.grad(out, (qf, kf, vf),
                                   grad_out[:, :, q0:q1].float())


def _fake_dq(q, k, big: tuple, gq: torch.Tensor, big_bytes: int,
             causal: bool, window: int) -> torch.Tensor:
    """The fake backward's dq (f32) after its largest block ran: the
    other blocks' rows stand beside that block's, and their recompute is
    counted, FLOPs by :func:`recompute_flops` and bytes as the block
    that ran moved, in proportion to rows x keys."""
    b, hq, sq, d = q.shape
    size = (big[1] - big[0]) * (big[3] - big[2])
    flops = nbytes = 0
    for q0, q1, k0, k1 in bwd_blocks(q, k, causal, window):
        if (q0, q1, k0, k1) != big:
            flops += recompute_flops(b, hq, q1 - q0, k1 - k0, d)
            nbytes += big_bytes * (q1 - q0) * (k1 - k0) // max(size, 1)
    if flops:
        work_mod.add_kernel("flash_attention.recompute", flops, nbytes)
    rest = torch.empty((b, hq, sq - gq.shape[2], d), dtype=torch.float32,
                       device=q.device)
    return torch.cat([rest, gq], dim=2)


def recompute_flops(b: int, hq: int, rows: int, keys: int, d: int) -> int:
    """FLOPs of one backward block's recompute as
    ``torch.utils.flop_counter`` counts them: the forward's two batched
    products and the four of their gradients, 2·B·Hq·rows·keys·d each."""
    return 12 * b * hq * rows * keys * d


def bwd_blocks(q: torch.Tensor, k: torch.Tensor, causal: bool,
               window: int) -> list:
    """The backward's blocks (q0, q1, k0, k1): :func:`_bwd_rows` query
    rows each, over the keys they see (:func:`_live_keys`)."""
    sq, sk = q.shape[2], k.shape[2]
    rows = _bwd_rows(q, k)
    return [(q0, min(q0 + rows, sq))
            + _live_keys(q0, min(q0 + rows, sq), sk, causal, window)
            for q0 in range(0, sq, rows)]


def _live_keys(q0: int, q1: int, sk: int, causal: bool,
               window: int) -> tuple[int, int]:
    """The keys [k0, k1) that query rows [q0, q1) can see (the masks go
    by absolute position): the rest would take a zero probability and
    give a zero gradient."""
    k0 = max(0, q0 - window + 1) if window > 0 else 0
    if causal:
        k1 = q1
    elif window > 0:
        k1 = q1 - 1 + window
    else:
        k1 = sk
    return min(k0, sk), max(min(k1, sk), min(k0, sk))


def _bwd_rows(q: torch.Tensor, k: torch.Tensor) -> int:
    """Query rows a block of the backward's recompute: as many as keep
    its (B, Hq, rows, Sk) plane within :data:`BWD_PLANE` elements, at
    least one."""
    b, hq = q.shape[:2]
    return max(1, BWD_PLANE // (b * hq * k.shape[2]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """q (B, Hq, Sq, d); k, v (B, Hkv, Sk, d), Hq a multiple of Hkv,
    float32 or bfloat16 → (out (B, Hq, Sq, d) in q's dtype, lse
    (B, Hq, Sq) f32).  Query head h reads kv head h // (Hq / Hkv); masks
    go by absolute position; a row with no visible key gives zeros and
    lse = -1e30.  Differentiable in q, k and v (not in lse)."""
    _check(q, k, v, window)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if scale is None:
        scale = 1.0 / (q.shape[3] ** 0.5)
    return _FlashAttention.apply(q, k, v, bool(causal), int(window),
                                 float(scale))

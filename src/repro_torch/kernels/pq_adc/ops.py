"""Checked wrappers of the two ADC kernels (port of
``repro/kernels/pq_adc/ops.py``: ``pq_adc_fused`` and ``pq_adc``).

``pq_adc_fused`` replaces the TPU kernel
``repro/kernels/pq_adc/kernel.py::_adc_fused_kernel``.  On the H100 it
is bound by bytes: one m-byte code row per live slot, gathered at
random from a plane far larger than L2, plus the ids, live flags and
scores.  ``csrc/pq_adc_fused.cu`` runs one wave of persistent blocks
over equal ranges of the flattened (B, C) plane (:func:`block_ranges`),
stages a query's LUT in shared memory once per block that scores it,
and keeps code rows in flight: each warp copies the rows of its next
32-slot groups into a shared-memory ring by 16-byte ``cp.async`` while
it looks up the current group's codes (no one-hot product, no (B, C,
m) tensor; dead lanes read no row).  :func:`plan` asks the library
which instance runs a shape (the served one: uint8, k 256, m a
multiple of 16) and its resident blocks, once per shape; :func:`choose` takes the 16-byte instance where
:func:`rows_vectorizable` and the ring's room allow, else the scalar
one, which reads each row code by code.

``pq_adc`` replaces ``kernel.py::_adc_kernel`` (entry
``pq_adc_fragmajor``), the unfused ADC over codes the caller gathered
into a (B, C, m) tensor.  ``csrc/pq_adc.cu`` reads that tensor once, as
given, with the same LUT staging and the same j = 0..m−1 order of fp32
adds as ``pq_adc_fused.cu``: on the same codes the two kernels agree bit
for bit.  It is bound by the bytes of the codes tensor.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor
launches the kernel on the current stream, without synchronizing, or
raises.  :data:`launches` and :data:`unfused_launches` count kernel
launches.  ``pq_adc_fused`` on fake CUDA tensors (the dry run,
:mod:`repro_torch.launch.cells`) takes its fake path: the launch's
output, nothing built or launched; both CUDA paths add
:func:`fused_work`'s count to the dry run's tally
(:mod:`repro_torch.work`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch import work as work_mod
from repro_torch.kernels import _build
from repro_torch.kernels.pq_adc import ref

#: kernel launches in this process (CPU calls do not count):
#: pq_adc_fused, and pq_adc
launches = 0
unfused_launches = 0

#: dynamic shared memory one block may use on sm_90 (227 KB)
MAX_SMEM = 232_448

#: ctypes signature of ``pq_adc_fused_launch`` (csrc/pq_adc_fused.cu)
ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
            + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
#: ctypes signature of ``pq_adc_fused_plan``
PLAN_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3
#: the kernel's instances, by the number ``pq_adc_fused_plan`` gives
INSTANCES = ("served", "vector", "scalar")
_CODE_DTYPES = (torch.uint8, torch.int32)
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
            or codes_plane.dtype not in _CODE_DTYPES):
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


class Plan(NamedTuple):
    """What a ``pq_adc_fused`` library runs at one (m, k, codes, vec)."""
    instance: int       # index into INSTANCES
    resident: int       # blocks of it resident on the whole card
    min_slots: int      # the fewest slots a block takes


_PLANS: dict[tuple, Plan | None] = {}


def plan(lib: ctypes.CDLL, m: int, k: int, elem: int, vec: bool
         ) -> Plan | None:
    """The library's plan for (m, k, ``elem``-byte codes, ``vec``) on the
    current device, asked once per shape; None where no instance runs it
    (``vec`` without room for the ring)."""
    key = (lib._name, torch.cuda.current_device(), m, k, elem, bool(vec))
    if key not in _PLANS:
        fn = lib.pq_adc_fused_plan
        if fn.argtypes is None:
            fn.argtypes, fn.restype = PLAN_ARGTYPES, ctypes.c_int
        vals = [ctypes.c_int() for _ in Plan._fields]
        err = fn(m, k, elem, int(vec), *map(ctypes.byref, vals))
        if err == 1:                      # cudaErrorInvalidValue: no instance
            _PLANS[key] = None
        else:
            _build.check(lib, err, "pq_adc_fused_plan")
            _PLANS[key] = Plan(*(v.value for v in vals))
    return _PLANS[key]


def rows_vectorizable(codes_plane: torch.Tensor) -> bool:
    """Whether every row of ``codes_plane`` (N, m), contiguous, is whole
    16-byte pieces starting 16-byte aligned: m · code bytes a multiple of
    16 and the base aligned.  The C entry refuses ``vec`` otherwise."""
    return ((codes_plane.shape[1] * codes_plane.element_size()) % 16 == 0
            and codes_plane.data_ptr() % 16 == 0)


def choose(lib: ctypes.CDLL, lut: torch.Tensor,
           codes_plane: torch.Tensor) -> tuple[bool, Plan]:
    """(``vec``, plan) of the instance the wrapper launches: the 16-byte
    ring where :func:`rows_vectorizable` holds and the ring fits beside
    the LUT, else the scalar one."""
    m, k = lut.shape[1:]
    elem = codes_plane.element_size()
    if rows_vectorizable(codes_plane):
        p = plan(lib, m, k, elem, True)
        if p is not None:
            return True, p
    p = plan(lib, m, k, elem, False)
    if p is None:
        raise ValueError(f"pq_adc_fused has no instance for m={m}, k={k}")
    return False, p


def grid_size(total: int, p: Plan) -> int:
    """Blocks a launch over ``total`` = B · C slots: one wave of resident
    blocks, fewer where each would take less than ``p.min_slots``."""
    return max(1, min(p.resident, -(-total // p.min_slots)))


def block_ranges(total: int, grid: int) -> list[tuple[int, int]]:
    """Each block's [lo, hi) of the flattened (B, C) plane, as the kernel
    cuts it: equal shares, the first ``total % grid`` one slot longer."""
    per, rem = divmod(total, grid)
    los = [per * i + min(i, rem) for i in range(grid + 1)]
    return list(zip(los[:-1], los[1:]))


def lut_stagings(b: int, c: int, grid: int) -> int:
    """LUT copies a launch makes: one per block per query its range
    touches."""
    return sum(len(range(lo // c, (hi - 1) // c + 1)) if hi > lo else 0
               for lo, hi in block_ranges(b * c, grid))


def kernel_args(lut, codes_plane, ids, live, out, vec: bool, grid: int,
                stream: int) -> list:
    """The arguments of ``pq_adc_fused_launch``, in :data:`ARGTYPES`'
    order."""
    b, m, k = lut.shape
    return [lut.data_ptr(), codes_plane.data_ptr(), ids.data_ptr(),
            live.data_ptr(), out.data_ptr(), b, ids.shape[1], m, k,
            codes_plane.shape[0], codes_plane.element_size(), int(vec),
            grid, stream]


def launch(lib: ctypes.CDLL, lut, codes_plane, ids, live,
           vec: bool | None = None) -> torch.Tensor:
    """One call of ``lib``'s kernel on the current stream: (B, C)
    scores.  ``vec`` None takes :func:`choose`'s instance; True or False
    forces one (the C entry refuses a ``vec`` the inputs do not allow).
    Raises if the launch is refused."""
    if ids.device.index != torch.cuda.current_device():
        with torch.cuda.device(ids.device):
            return launch(lib, lut, codes_plane, ids, live, vec)
    if vec is None:
        vec, p = choose(lib, lut, codes_plane)
    else:
        p = plan(lib, lut.shape[1], lut.shape[2],
                 codes_plane.element_size(), vec)
        if p is None:
            raise ValueError("pq_adc_fused: no instance for that vec")
    fn = lib.pq_adc_fused_launch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = ARGTYPES, ctypes.c_int
    out = torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
    err = fn(*kernel_args(lut, codes_plane, ids, live, out, vec,
                          grid_size(ids.numel(), p),
                          torch.cuda.current_stream().cuda_stream))
    _build.check(lib, err, "pq_adc_fused")
    return out


def fused_work(b: int, c: int, m: int, k: int, elem: int,
               live: int | None = None, distinct: int | None = None
               ) -> tuple[int, int]:
    """(FLOPs, bytes) of one ``pq_adc_fused`` call: m adds a live lane;
    the ids, live flags and scores (9 bytes a lane), the LUTs, and each
    distinct live row of ``elem``-byte codes read once.  Without data
    every lane counts as live and each lane's row as distinct (the dry
    run's count)."""
    live = b * c if live is None else live
    distinct = live if distinct is None else distinct
    return live * m, 9 * b * c + 4 * b * m * k + distinct * m * elem


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
    if m < 1 or k < 1:
        raise ValueError(f"pq_adc_fused needs m, k >= 1, got m={m}, k={k}")
    _check_lut_fits(m, k)
    if not all(t.is_contiguous() for t in (lut, codes_plane, ids, live)):
        raise ValueError("pq_adc_fused needs contiguous inputs")
    if ids.numel() == 0:
        return torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
    if work_mod.is_fake(lut):
        out = torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
    else:
        out = launch(_build.library("pq_adc_fused"), lut, codes_plane, ids,
                     live)
        launches += 1
    work_mod.add_kernel("pq_adc_fused", *fused_work(
        b, ids.shape[1], m, k, codes_plane.element_size()))
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

"""Checked wrapper of the fused SQ8 gather + dequantized dot kernel
(port of ``repro/kernels/sq8_dot/ops.py::sq8_dot_fused``).

Replaces the TPU kernel ``repro/kernels/sq8_dot/kernel.py::_sq8_fused_kernel``.
On the H100 it is bound by bytes: h-byte code rows gathered at random
from a plane far larger than L2 (6.8 GB at the ``serve_msmarco`` shape),
plus the ids, live flags and scores; the arithmetic is one FMA per byte.
The queries of a batch share rows (every query that probes an inverted
list holds its ids), so ``csrc/sq8_dot_fused.cu`` requests a row once
for a group of queries: :func:`schedule` cuts the (B, C) plane into
items of ``tile_slots`` slots of one query, keys each item by the
clipped id of its first slot and sorts the keys on the device; the
kernel cuts each run of equal keys into groups of up to ``group_max``
(:func:`lead_flags`) and gives each group one block, in which a thread
owns a slot: it reads that slot's row once (copied through shared memory
by its warp), converts each byte once (exactly, without I2F) and applies
it to every query of the group that holds that row there and is live.  A
query with another id at that slot reads its own row, so the result is
exact for any ids.  Dead lanes read nothing; no (B, C, h) tensor exists.
Each score is summed in the order of the kernel before this one, so
scores are equal to its bit for bit.

:func:`sq8_vector_loads` chooses the 16-byte row copies (else 4-byte
words); the C entry refuses the choice where the inputs do not allow
it.  The kernel
is bias-free, as on the TPU: the SQ8 scorer adds ⟨q, lo⟩ after the
in-kernel mask (``-inf`` + bias stays ``-inf``).

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor
launches the kernel on the current stream, after the schedule's torch
ops and without synchronizing, or raises.  :data:`launches` counts kernel
launches.  On fake CUDA tensors (the dry run,
:mod:`repro_torch.launch.cells`) the wrapper takes its fake path: the
output and the schedule's tensors, shaped by :data:`HOPPER_TILES`,
nothing built or launched; both CUDA paths add :func:`work`'s count to
the dry run's tally (:mod:`repro_torch.work`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch import work as work_mod
from repro_torch.kernels import _build
from repro_torch.kernels.sq8_dot import ref

#: kernel launches in this process (CPU calls do not count)
launches = 0

#: ctypes signature of ``sq8_dot_fused_launch`` (csrc/sq8_dot_fused.cu)
ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


class Tiles(NamedTuple):
    """A ``sq8_dot_fused`` build's schedule shape."""
    tile_slots: int     # slots of one query an item covers
    group_max: int      # items one block serves from one read of a row
    max_h: int          # the widest h its shared memory holds


_TILES: dict[str, Tiles] = {}     # library path → its tiles
#: ``tiles`` of the built library (smoke phase 27a holds it equal), which
#: the fake path shapes the schedule by
HOPPER_TILES = Tiles(tile_slots=1024, group_max=2, max_h=24432)


def tiles(lib: ctypes.CDLL) -> Tiles:
    """The schedule shape of a built ``sq8_dot_fused`` library."""
    got = _TILES.get(lib._name)
    if got is None:
        vals = [ctypes.c_int() for _ in Tiles._fields]
        fn = lib.sq8_dot_tiles
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * len(vals)
        fn.restype = ctypes.c_int
        _build.check(lib, fn(*map(ctypes.byref, vals)), "sq8_dot_tiles")
        got = _TILES[lib._name] = Tiles(*(v.value for v in vals))
    return got


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


def sq8_vector_loads(codes_plane: torch.Tensor) -> bool:
    """Whether the kernel can read ``codes_plane`` (N, h), contiguous, as
    16-byte vectors: h a multiple of 16 and the base 16-byte aligned, so
    every row starts aligned.  The C entry refuses the flag otherwise."""
    return codes_plane.shape[1] % 16 == 0 and codes_plane.data_ptr() % 16 == 0


def tile_keys(ids: torch.Tensor, live: torch.Tensor, n_rows: int,
              tile_slots: int) -> torch.Tensor:
    """(B, T) int32 keys of the items, T = ceil(C / tile_slots): the
    clipped id of an item's first slot where that lane is live, else -1
    - the item's index, a key of its own below every row, so that PAD
    tails (their ids clipped to row 0) do not form one long group."""
    b = ids.shape[0]
    first, first_live = ids[:, ::tile_slots], live[:, ::tile_slots]
    own = torch.arange(-1, -1 - first.numel(), -1, dtype=torch.int32,
                       device=ids.device).view(b, -1)
    return torch.where(first_live, first.clamp(0, min(n_rows, 2**31) - 1),
                       own)


def schedule(ids: torch.Tensor, live: torch.Tensor, n_rows: int,
             tile_slots: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's work order, computed on ``ids``' device without a
    read back: ``skey`` (B·T,) int32, the :func:`tile_keys` sorted
    (stable), and ``order`` (B·T,) int64, the items (query · T + tile) in
    that order.  The kernel groups them as :func:`lead_flags` says."""
    return torch.sort(tile_keys(ids, live, n_rows, tile_slots).flatten(),
                      stable=True)


def lead_flags(skey: torch.Tensor, group_max: int) -> torch.Tensor:
    """Where the kernel starts a group in the sorted keys: windows of
    32·``group_max`` positions, and inside a window each run of equal
    keys cut into groups of ``group_max`` from its first position (or
    the window's); a group runs to the next start.  The kernel decides
    it from the keys of its window alone."""
    pos = torch.arange(skey.numel(), device=skey.device)
    reset = pos % (32 * group_max) == 0
    reset[1:] |= skey[1:] != skey[:-1]
    start = torch.cummax(torch.where(reset, pos, 0), 0).values
    return (pos - start) % group_max == 0


def kernel_args(q_scaled, codes_plane, ids, live, skey, order, out,
                vec: bool, stream: int) -> list:
    """The arguments of ``sq8_dot_fused_launch``, in :data:`ARGTYPES`'
    order."""
    b, h = q_scaled.shape
    return [q_scaled.data_ptr(), codes_plane.data_ptr(), ids.data_ptr(),
            live.data_ptr(), skey.data_ptr(), order.data_ptr(),
            out.data_ptr(), b, ids.shape[1], h, codes_plane.shape[0],
            int(vec), stream]


def launch(lib: ctypes.CDLL, q_scaled, codes_plane, ids, live,
           vec: bool | None = None) -> torch.Tensor:
    """One call of ``lib``'s kernel on the current stream, its schedule
    included: (B, C) scores.  ``vec`` None takes
    :func:`sq8_vector_loads`' choice.  Raises if the launch is refused."""
    tl = tiles(lib)
    h = q_scaled.shape[1]
    if h > tl.max_h:
        raise ValueError(f"h={h} exceeds the {tl.max_h} that one block's "
                         f"shared memory holds for {tl.group_max} queries")
    vec = sq8_vector_loads(codes_plane) if vec is None else vec
    out = torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
    skey, order = schedule(ids, live, codes_plane.shape[0], tl.tile_slots)
    fn = lib.sq8_dot_fused_launch
    fn.argtypes, fn.restype = ARGTYPES, ctypes.c_int
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*kernel_args(q_scaled, codes_plane, ids, live, skey, order,
                              out, vec, stream))
    _build.check(lib, err, "sq8_dot_fused")
    return out


def work(b: int, c: int, h: int, live: int | None = None,
         distinct: int | None = None) -> tuple[int, int]:
    """(FLOPs, bytes) of one call: 2·h a live lane; the ids, live flags
    and scores (9 bytes a lane), the queries, and each distinct live row
    read once.  Without data every lane counts as live and each lane's
    row as distinct (the dry run's count)."""
    live = b * c if live is None else live
    distinct = live if distinct is None else distinct
    return 2 * live * h, 9 * b * c + 4 * b * h + distinct * h


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
    if not all(t.is_contiguous() for t in (q_scaled, codes_plane, ids,
                                           live)):
        raise ValueError("sq8_dot_fused needs contiguous inputs")
    if ids.numel() == 0:
        return torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
    if work_mod.is_fake(q_scaled):
        # the launch's output and its schedule (skey, order)
        out = torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
        items = ids.shape[0] * -(-ids.shape[1] // HOPPER_TILES.tile_slots)
        torch.empty(items, dtype=torch.int32, device=ids.device)
        torch.empty(items, dtype=torch.int64, device=ids.device)
    else:
        out = launch(_build.library("sq8_dot_fused"), q_scaled,
                     codes_plane, ids, live)
        launches += 1
    work_mod.add_kernel("sq8_dot_fused", *work(*ids.shape,
                                               q_scaled.shape[1]))
    return out

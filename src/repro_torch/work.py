"""What the port's hand-written kernels and mesh collectives do, counted
for the dry run (no reference counterpart: XLA's cost analysis reads a
compiled module, where a kernel launched through ``ctypes`` is invisible
to PyTorch's own counters).

A kernel wrapper calls :func:`add_kernel` with its formula's FLOPs and
bytes wherever it launches its kernel on a CUDA tensor, and on its fake
path, which it takes only when its inputs are fake tensors
(:func:`is_fake`).  A mesh collective calls :func:`add_collective` with
the bytes a position receives from the others, and the dry run's
dispatch mode (:mod:`repro_torch.launch.roofline`) calls
:func:`add_op_bytes` with each PyTorch op's.  Each adds into every
:class:`Tally` open at the time (:func:`counting`), from any thread: a
mesh position's worker thread adds to the tally its caller opened; a
``local`` tally takes only its own thread's.  Outside :func:`counting`
each costs one empty-list check.
"""
from __future__ import annotations

import collections
import contextlib
import threading

import torch
from torch._subclasses.fake_tensor import FakeTensor

_LOCK = threading.Lock()
_OPEN: list = []


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor (shape, dtype and device, no
    storage): the one test that sends a kernel wrapper down its fake
    path."""
    return isinstance(t, FakeTensor)


class Tally:
    """FLOPs and bytes by kernel, bytes and calls by collective, and the
    bytes of the PyTorch ops the dry run's mode counted."""

    def __init__(self, thread=None):
        self.thread = thread
        self.op_bytes = 0
        self.kernels = collections.defaultdict(
            lambda: {"calls": 0, "flops": 0, "bytes": 0})
        self.collectives = collections.defaultdict(
            lambda: {"calls": 0, "bytes": 0})


@contextlib.contextmanager
def counting(local: bool = False):
    """A :class:`Tally` of every kernel call, collective and counted op
    made until the block ends, on any thread (on this one, ``local``)."""
    tally = Tally(threading.get_ident() if local else None)
    with _LOCK:
        _OPEN.append(tally)
    try:
        yield tally
    finally:
        with _LOCK:
            _OPEN.remove(tally)


def _tallies() -> list:
    me = threading.get_ident()
    return [t for t in _OPEN if t.thread is None or t.thread == me]


def add_kernel(name: str, flops: int, nbytes: int) -> None:
    """One call of kernel ``name``: its formula's FLOPs and bytes."""
    if not _OPEN:
        return
    with _LOCK:
        for tally in _tallies():
            k = tally.kernels[name]
            k["calls"] += 1
            k["flops"] += int(flops)
            k["bytes"] += int(nbytes)


def add_collective(op: str, nbytes: int) -> None:
    """One position's part of a collective: the bytes it receives."""
    if not _OPEN:
        return
    with _LOCK:
        for tally in _tallies():
            c = tally.collectives[op]
            c["calls"] += 1
            c["bytes"] += int(nbytes)


def add_op_bytes(nbytes: int) -> None:
    """The bytes one PyTorch op read and wrote."""
    if not _OPEN:
        return
    with _LOCK:
        for tally in _tallies():
            tally.op_bytes += int(nbytes)

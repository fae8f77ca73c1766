"""Timing of a callable: CUDA events on the current card (:class:`Timer`,
shared by ``chip_smoke.py`` and :mod:`repro_torch.benchmarks.
kernel_variants`) and the host clock around synchronized calls
(:func:`mean_us`, the paper benchmarks' per-call time)."""
from __future__ import annotations

import statistics
import time

import torch


class Timer:
    """Medians of CUDA-event times of a callable, the 50 MB L2 flushed
    before every run (the serving path finds the kernels' inputs cold).

    ``queued`` False synchronizes after every run, so a run's window also
    holds the host's time inside the callable (Python, allocation, the
    launch itself), as a served call's does.  ``queued`` True enqueues
    all runs before one synchronize, so only the card's time counts: for
    two builds of one kernel compared in one process."""

    def __init__(self, queued: bool = False):
        self.queued = queued
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps: int, warm: int = 2) -> float:
        for _ in range(warm):
            fn()
        times, events = [], []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            if self.queued:
                events.append((start, end))
            else:
                end.synchronize()
                times.append(start.elapsed_time(end))
        if self.queued:
            torch.cuda.synchronize()
            times = [s.elapsed_time(e) for s, e in events]
        return statistics.median(times)


def mean_us(fn, *args, device: torch.device, warmup: int = 1,
            iters: int = 3) -> float:
    """Mean host-clock µs per call of ``fn(*args)`` after ``warmup``
    calls, each call followed by a synchronize of ``device`` when it is
    a card: the time a caller waits for the result."""
    def call():
        fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        call()
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    return (time.perf_counter() - t0) / iters * 1e6

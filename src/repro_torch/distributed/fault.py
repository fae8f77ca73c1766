"""Straggler detection for the training loop (port of
``repro/distributed/fault.py``: ``StragglerMonitor`` and its policy
constants ``STRAGGLER_FACTOR`` and ``MAX_STRIKES``; ``ShardHealth``,
``reshard_bounds`` and ``SimulatedFailure`` come with the multi-device
path).

The monitor is an observer: it times steps against a rolling-median
deadline and counts strikes per host, and sits outside the numeric
path, so a training run with any monitor (or none) is bit-identical.
At scale a host that collects ``MAX_STRIKES`` strikes is ejected and
the data pipeline reshards over the healthy hosts.
"""
from __future__ import annotations

import collections
import time
from typing import Optional

STRAGGLER_FACTOR = 2.5
MAX_STRIKES = 3


class StragglerMonitor:
    """Rolling-median step-latency watchdog."""

    def __init__(self, window: int = 50, factor: float = STRAGGLER_FACTOR,
                 max_strikes: int = MAX_STRIKES):
        self.durations: collections.deque = collections.deque(maxlen=window)
        self.factor = factor
        self.max_strikes = max_strikes
        self.strikes: collections.Counter = collections.Counter()
        self._t0: Optional[float] = None

    def step_start(self) -> None:
        self._t0 = time.monotonic()

    def step_end(self, host_id: int = 0) -> bool:
        """Record a timed step; True if this host just exceeded the
        deadline.  Convenience over :meth:`observe` for loops that let
        the monitor do its own timing."""
        assert self._t0 is not None, "step_start not called"
        dt = time.monotonic() - self._t0
        self._t0 = None
        return self.observe(dt, host_id)

    def observe(self, dt: float, host_id: int = 0) -> bool:
        """Record one externally-measured duration for ``host_id``;
        True when it exceeded the rolling-median deadline.  This is the
        seam the serving path feeds (per-shard latencies measured by the
        caller, DESIGN.md §12) — the median window is shared across
        hosts, strikes are per host."""
        flagged = False
        if len(self.durations) >= 8:
            med = sorted(self.durations)[len(self.durations) // 2]
            if dt > med * self.factor:
                self.strikes[host_id] += 1
                flagged = True
        self.durations.append(dt)
        return flagged

    def should_eject(self, host_id: int = 0) -> bool:
        return self.strikes[host_id] >= self.max_strikes

"""Straggler detection and shard membership (port of
``repro/distributed/fault.py``: ``StragglerMonitor`` and its policy
constants ``STRAGGLER_FACTOR`` and ``MAX_STRIKES``, ``ShardHealth``,
``reshard_bounds`` and ``SimulatedFailure``).

The monitor is an observer: it times steps against a rolling-median
deadline and counts strikes per host, and sits outside the numeric
path, so a training run with any monitor (or none) is bit-identical.
At scale a host that collects ``MAX_STRIKES`` strikes is ejected and
the data pipeline reshards over the healthy hosts
(:func:`reshard_bounds`).  :class:`ShardHealth` is the serving side of
the same policy: per-shard latencies in, which shards to eject out
(``repro_torch.launch.serve.MeshServer``, DESIGN.md §12).
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


class ShardHealth:
    """Serving-side shard membership driven by the straggler policy
    (DESIGN.md §12): feed per-shard latencies through :meth:`observe`;
    after ``max_strikes`` deadline misses a shard should be ejected from
    the serving set.  Ejection and rejoin are explicit calls; the index
    layer rebuilds the survivor set."""

    def __init__(self, n_shards: int, window: int = 50,
                 factor: float = STRAGGLER_FACTOR,
                 max_strikes: int = MAX_STRIKES):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.monitor = StragglerMonitor(window=window, factor=factor,
                                        max_strikes=max_strikes)
        self._lost: set[int] = set()

    def observe(self, shard: int, dt: float) -> bool:
        """Record one measured shard latency; True when the shard has
        now collected enough strikes that it should be ejected."""
        self._check(shard)
        self.monitor.observe(dt, shard)
        return shard not in self._lost and self.monitor.should_eject(shard)

    def eject(self, shard: int) -> None:
        self._check(shard)
        if len(self.healthy) <= 1 and shard in self.healthy:
            raise ValueError("cannot eject the last healthy shard")
        self._lost.add(shard)

    def rejoin(self, shard: Optional[int] = None) -> None:
        """Return one shard (or, with None, every lost shard) to the
        healthy set and clear its strikes."""
        back = list(self._lost) if shard is None else [shard]
        for s in back:
            self._check(s)
            self._lost.discard(s)
            self.monitor.strikes[s] = 0

    @property
    def healthy(self) -> list[int]:
        return [s for s in range(self.n_shards) if s not in self._lost]

    @property
    def lost(self) -> list[int]:
        return sorted(self._lost)

    @property
    def degraded(self) -> bool:
        return bool(self._lost)

    def _check(self, shard: int) -> None:
        if not 0 <= shard < self.n_shards:
            raise ValueError(
                f"shard {shard} out of range [0, {self.n_shards})")


def reshard_bounds(n_examples: int, healthy_hosts: list[int]
                   ) -> dict[int, tuple[int, int]]:
    """Contiguous per-host example ranges over the current host set, the
    skip-and-reshard step after an ejection."""
    n = len(healthy_hosts)
    per, rem = divmod(n_examples, n)
    out, start = {}, 0
    for i, h in enumerate(sorted(healthy_hosts)):
        size = per + (1 if i < rem else 0)
        out[h] = (start, start + size)
        start += size
    return out


class SimulatedFailure(RuntimeError):
    """Raised by a drill to kill a run at a chosen step."""

"""The traced window (``--trace 1``): ``torch.profiler`` (CUPTI) over the
measured window, reduced in memory to what the per-layer metrics read.
No trace file is written.

  · device operations (kernels, memsets, copies) clipped to the window;
  · busy seconds: the union of their intervals; the idle gaps between;
  · host events (operators, CUDA runtime calls, the harness's spans) to
    say what the host did in each idle gap.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import re

import numpy as np

WINDOW = "hi2bench.window"
#: the harness's spans around the runtime's steps (run.py wraps them);
#: ``submit`` is left bare, since a span a single query would load the
#: open mix's sender with the profiler's cost
SPANS = ("runtime.query", "runtime.execute", "runtime.run_batch")
#: host spans that cover a whole client call or more: they say nothing of
#: what the host was doing in a gap
_BROAD = (WINDOW,)
#: gaps labelled for the breakdown, longest first
_LABELLED = 2000


@dataclasses.dataclass
class Trace:
    window_s: float
    names: np.ndarray      # (n,) object: device operation names
    start: np.ndarray      # (n,) s from window start, clipped
    end: np.ndarray        # (n,) s
    host: list             # (start s, end s, name) host events
    kinds: np.ndarray      # (n,) object: "kernel", "memset" or "memcpy"

    def select(self, pattern: str) -> np.ndarray:
        rx = re.compile(pattern)
        return np.array([bool(rx.search(n)) for n in self.names], dtype=bool)

    def seconds(self, mask=None) -> float:
        d = self.end - self.start
        return float(d.sum() if mask is None else d[mask].sum())

    def busy_intervals(self) -> np.ndarray:
        if self.names.size == 0:
            return np.zeros((0, 2))
        order = np.argsort(self.start, kind="stable")
        s, e = self.start[order], self.end[order]
        reach = np.maximum.accumulate(e)
        new = np.ones(s.size, dtype=bool)
        new[1:] = s[1:] > reach[:-1]
        idx = np.flatnonzero(new)
        ends = np.append(reach[idx[1:] - 1], reach[-1])
        return np.stack([s[idx], ends], 1)

    @property
    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum())

    def gaps(self) -> np.ndarray:
        iv = self.busy_intervals()
        edges = np.concatenate([[0.0], iv.reshape(-1), [self.window_s]])
        g = edges.reshape(-1, 2)
        return g[g[:, 1] > g[:, 0]]

    def top_ops(self, n: int = 10) -> list:
        tot: dict = collections.defaultdict(float)
        for name, d in zip(self.names, self.end - self.start):
            tot[name[:200]] += float(d)
        return [[k, v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, n: int = 10) -> list:
        """The longest idle gaps, grouped by what the host was doing in
        each: the innermost host event around its middle, else the host
        calls just before and after it."""
        g = self.gaps()
        g = g[np.argsort(g[:, 0] - g[:, 1], kind="stable")[:_LABELLED]]
        host = sorted((h for h in self.host if h[2] not in _BROAD),
                      key=lambda h: h[0])
        starts = [h[0] for h in host]
        by_end = sorted(host, key=lambda h: h[1])
        ends = [h[1] for h in by_end]
        tot: dict = collections.defaultdict(lambda: [0.0, 0])
        for a, b in g:
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid)
            inner = [h for h in host[max(0, i - 4000):i] if h[1] >= mid]
            if inner:
                label = min(inner, key=lambda h: h[1] - h[0])[2]
            else:
                j = bisect.bisect_right(ends, a) - 1
                k = bisect.bisect_left(starts, b)
                before = by_end[j][2] if j >= 0 else "window start"
                after = host[k][2] if k < len(host) else "window end"
                label = f"after {before}, before {after}"
            tot[label[:160]][0] += float(b - a)
            tot[label[:160]][1] += 1
        rows = sorted(tot.items(), key=lambda kv: -kv[1][0])[:n]
        return [[f"{k} ({c} gaps)", s] for k, (s, c) in rows]

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(),
                "idle_gaps": self.idle_by_host()}


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


@contextlib.contextmanager
def window(enabled: bool, cuda: bool, out: dict):
    """Profile the body when ``enabled``, and yield ``opened()``, which
    the body calls as the measured window opens: events before it (an
    open mix's lead-in) are left out.  ``out["trace"]`` then holds the
    window's :class:`Trace` (one with no device operations off the
    card)."""
    if not enabled:
        yield lambda: None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    kw = {}
    try:       # host events of every thread, where this torch offers it
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        pass
    span = record_function(WINDOW)
    with profile(activities=acts, **kw) as prof:
        yield span.__enter__
        if cuda:
            torch.cuda.synchronize()
        span.__exit__(None, None, None)
    out["trace"] = reduce(prof, torch.autograd.DeviceType.CUDA)


def reduce(prof, cuda_type) -> Trace:
    events = prof.profiler.kineto_results.events()
    win = [e for e in events
           if e.name() == WINDOW and e.device_type() != cuda_type]
    if not win:
        raise RuntimeError("the profiler recorded no window span")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    names, st, en, host = [], [], [], []
    for e in events:
        a, b = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if b <= a and e.duration_ns() > 0:
            continue
        if e.device_type() == cuda_type:
            if e.is_user_annotation() or e.name() in (WINDOW,) + SPANS:
                # a host span's shadow on the device timeline, no work
                continue
            names.append(e.name())
            st.append((a - w0) * 1e-9)
            en.append((b - w0) * 1e-9)
        else:
            host.append(((a - w0) * 1e-9, (b - w0) * 1e-9, e.name()))
    names_a = np.array(names, dtype=object)
    return Trace(window_s=(w1 - w0) * 1e-9, names=names_a,
                 start=np.array(st, dtype=float),
                 end=np.array(en, dtype=float), host=host,
                 kinds=np.array([_kind(n) for n in names], dtype=object))

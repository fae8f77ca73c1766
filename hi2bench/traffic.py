"""The one traffic generator.  A mix is a data file of parameters
(``traffic/<mix>.json``) that this module reads:

  rows_per_request  pool queries a request carries
  pool_requests     requests the pool holds (its queries are
                    ``pool_requests × rows_per_request`` rows)
  draw              how the requests walk the pool, from the seed:
                    ``{"law": "permute"}`` one permutation after another,
                    or ``{"law": "zipf", "s": s}`` with P(item at rank i)
                    ∝ 1/(i+1)^s over a seeded ranking, so a head of
                    requests repeats (a result cache then hits)
  arrivals          ``{"process": "closed", "clients": c}``: c threads,
                    each sending its next request through
                    ``runtime.query`` as soon as its last returned; or
                    ``{"process": "open", "rates": [[seconds, qps], ...]}``:
                    single queries through ``runtime.submit`` at Poisson
                    arrivals whose rate follows the list's steps, cycled
                    (one step: a constant rate; a step at 0: an off
                    period), each timed from when it was due
  runtime           the ``RuntimeConfig`` of the serving runtime, whole
                    (linger, queue depth, cache, smallest bucket)
  warm_requests     (closed) requests sent before the window, in set-up
  lead_s            (open) seconds of the same schedule before the
                    window, in set-up, so the queue starts in its steady
                    state
  rejects           "fail" (default): a request that admission control
                    rejects makes the run not correct; "expected": it is
                    counted as failed and the run may still be correct
  check_queries     queries of the seed's sample that the reference
                    compares
  tiny              the same keys at the CPU rehearsal's sizes

Both loops return a :class:`Log` of what ran: per request its pool rows,
its due, sent and done times (``time.perf_counter``) and whether its
result came.  Both keep the results of the seed's sample alone, so that
the window's garbage is the runtime's own and not a growing heap of the
harness's (holding every 256-row result grew the process by ~40 MB a
second and cost ~10% of ``qps`` on the card).
"""
from __future__ import annotations

import dataclasses
import functools
import heapq
import math
import sys
import threading
import time
from typing import Callable, Optional

import numpy as np

#: seconds to wait, after the window, for a request still in flight
DRAIN_S = 60.0


@dataclasses.dataclass
class Log:
    rows: list          # per request: the pool row ids it carried
    due: np.ndarray     # (n,) when each request was due
    sent: np.ndarray    # (n,) when it was handed to the runtime
    done: np.ndarray    # (n,) when its result came; nan if none
    ok: np.ndarray      # (n,) bool: its result came
    rejected: np.ndarray  # (n,) bool: admission control turned it away
    kept: dict          # request index -> its result, for the requests
    #                     the comparison may sample (the seed's draw)
    t0: float           # window start
    t1: float           # window end

    @property
    def n(self) -> int:
        return len(self.rows)

    @property
    def failed(self) -> int:
        return int((~self.ok).sum())


def pool_size(mix: dict) -> int:
    """Queries the mix's pool holds."""
    return mix["pool_requests"] * mix["rows_per_request"]


def _order(seed: int, n_items: int, length: int, draw: dict) -> np.ndarray:
    """``length`` pool items drawn from the seed by the mix's ``draw``."""
    rng = np.random.default_rng([seed, 7])
    if draw["law"] == "permute":
        reps = -(-length // n_items)
        return np.concatenate([rng.permutation(n_items)
                               for _ in range(reps)])[:length]
    if draw["law"] == "zipf":
        w = np.arange(1, n_items + 1, dtype=np.float64) ** -draw["s"]
        cdf = np.cumsum(w) / w.sum()
        rank = np.minimum(np.searchsorted(cdf, rng.random(length),
                                          side="right"), n_items - 1)
        return rng.permutation(n_items)[rank]
    raise ValueError(f"unknown draw law {draw['law']!r}")


def closed(rt, qe: np.ndarray, qt: np.ndarray, mix: dict, seed: int,
           seconds: float, max_requests: Optional[int] = None,
           overloaded: type = RuntimeError,
           at_start: Callable[[], None] = lambda: None) -> Log:
    """Closed loop for ``seconds`` (or, with ``max_requests``, until that
    many requests were sent); ``at_start()`` runs just before the
    window opens.  The results kept are those of the finished requests
    of least rank in a ranking drawn from the seed, as many as the
    comparison samples: a uniform draw over the window."""
    per, n_req = mix["rows_per_request"], mix["pool_requests"]
    order = _order(seed, n_req, 1 << 16, mix["draw"])
    rank = np.random.default_rng([seed, 13]).random(order.size)
    want = max(1, mix["check_queries"] // per)
    lock = threading.Lock()
    nxt = [0]
    recs: list = []
    kept: dict = {}
    least: list = []                   # (-rank, k) of the kept requests
    start = threading.Barrier(mix["arrivals"]["clients"] + 1)
    t = {}

    def client():
        start.wait()
        while True:
            with lock:
                k = nxt[0]
                if (time.perf_counter() >= t["end"] or
                        (max_requests is not None and k >= max_requests)):
                    return
                nxt[0] += 1
            rows = np.arange(per) + per * int(order[k % order.size])
            sent = time.perf_counter()
            rejected = False
            try:
                res = rt.query(qe[rows], qt[rows], timeout=DRAIN_S)
            except overloaded:
                res, done, rejected = None, math.nan, True
            except Exception as e:                # noqa: BLE001 — counted
                res, done = None, math.nan        # as failed
                print(f"request {k} failed: {e!r}", file=sys.stderr)
            else:
                done = time.perf_counter()
            with lock:
                recs.append((k, rows, sent, done, res is not None, rejected))
                r = float(rank[k % rank.size])
                if res is None or (len(least) == want and -least[0][0] <= r):
                    continue
                kept[k] = res
                if len(least) == want:
                    del kept[heapq.heapreplace(least, (-r, k))[1]]
                else:
                    heapq.heappush(least, (-r, k))

    clients = mix["arrivals"]["clients"]
    threads = [threading.Thread(target=client, name=f"hi2bench-client-{i}")
               for i in range(clients)]
    for th in threads:
        th.start()
    t["end"] = math.inf
    at_start()
    t0 = time.perf_counter()
    t["end"] = t0 + seconds
    start.wait()
    wait = (seconds if math.isfinite(seconds) else 0.0) + DRAIN_S + 60.0
    for th in threads:
        th.join(wait)
        if th.is_alive():
            raise RuntimeError("a client thread did not finish")
    t1 = t0 + seconds
    recs.sort(key=lambda r: r[0])
    sent = np.array([r[2] for r in recs])
    return Log(rows=[r[1] for r in recs], due=sent, sent=sent,
               done=np.array([r[3] for r in recs], dtype=float),
               ok=np.array([r[4] for r in recs], dtype=bool),
               rejected=np.array([r[5] for r in recs], dtype=bool),
               kept={i: kept[r[0]] for i, r in enumerate(recs)
                     if r[0] in kept}, t0=t0, t1=t1)


def arrivals(seed: int, rates: list, seconds: float) -> np.ndarray:
    """Arrival offsets in [0, seconds) of a Poisson process whose rate
    follows ``rates`` ([[seconds, qps], ...], cycled): in each step a
    Poisson count at its rate, placed uniformly."""
    rng = np.random.default_rng([seed, 11])
    out, t, i = [], 0.0, 0
    while t < seconds:
        span, rate = rates[i % len(rates)]
        end = min(t + span, seconds)
        if rate > 0:
            out.append(np.sort(rng.uniform(t, end,
                                           rng.poisson(rate * (end - t)))))
        t, i = end, i + 1
    return np.concatenate(out) if out else np.zeros(0)


def open_loop(rt, qe: np.ndarray, qt: np.ndarray, mix: dict, seed: int,
              seconds: float, overloaded: type = RuntimeError,
              lead: float = 0.0,
              at_start: Callable[[], None] = lambda: None) -> Log:
    """Open loop: one arrival schedule over ``lead`` + ``seconds``.  The
    first ``lead`` seconds bring the runtime's queue and batch sizes to
    their steady state and are not logged; ``at_start()`` runs as the
    window opens.  Every arrival is sent when due (or as soon after as
    the sender gets to it) and a window request is timed from when it
    was due.  A request that admission control rejects has failed."""
    if mix["rows_per_request"] != 1:
        raise ValueError("an open mix sends single queries")
    off = arrivals(seed, mix["arrivals"]["rates"], lead + seconds)
    first = int(np.searchsorted(off, lead))
    n = off.size - first
    rows = _order(seed, qe.shape[0], off.size, mix["draw"])
    keep = set(np.random.default_rng([seed, 13]).choice(
        n, min(n, mix["check_queries"]), replace=False).tolist())
    sent = np.full(n, math.nan)
    done = np.full(n, math.nan)
    ok = np.zeros(n, dtype=bool)
    rejected = np.zeros(n, dtype=bool)
    kept: dict = {}
    cv = threading.Condition()
    count = [0, 0, 0]               # submitted, resolved, failure told

    def finish(i, fut):
        t = time.perf_counter()
        exc = fut.exception()
        if exc is not None and not count[2]:
            count[2] = 1
            print(f"a request failed: {exc!r}", file=sys.stderr)
        if i >= 0 and exc is None:
            done[i], ok[i] = t, True
            if i in keep:
                kept[i] = fut.result()
        with cv:
            count[1] += 1
            cv.notify_all()

    base = time.perf_counter()
    due = base + off
    for i in range(off.size):
        j = i - first                      # the window's index; < 0: lead
        if j == 0:
            at_start()
        wait = due[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        if j >= 0:
            sent[j] = time.perf_counter()
        r = int(rows[i])
        try:
            f = rt.submit(qe[r], qt[r])
        except overloaded:
            if j >= 0:
                rejected[j] = True
            continue
        with cv:
            count[0] += 1
        f.add_done_callback(functools.partial(finish, j))
        del f
    with cv:
        if not cv.wait_for(lambda: count[1] == count[0], DRAIN_S):
            raise RuntimeError(f"{count[0] - count[1]} requests did not "
                               f"resolve within {DRAIN_S} s of the window")
    t0 = base + lead
    return Log(rows=[np.array([int(r)]) for r in rows[first:]],
               due=due[first:], sent=sent, done=done, ok=ok,
               rejected=rejected, kept=kept,
               t0=t0, t1=t0 + seconds)


def run(rt, qe: np.ndarray, qt: np.ndarray, mix: dict, seed: int,
        seconds: float, overloaded: type = RuntimeError,
        at_start: Callable[[], None] = lambda: None) -> Log:
    """The mix's window; an open mix leads in with ``lead_s`` of the
    same schedule (set-up, not logged)."""
    process = mix["arrivals"]["process"]
    if process == "closed":
        return closed(rt, qe, qt, mix, seed, seconds, overloaded=overloaded,
                      at_start=at_start)
    if process == "open":
        return open_loop(rt, qe, qt, mix, seed, seconds,
                         overloaded=overloaded, lead=mix["lead_s"],
                         at_start=at_start)
    raise ValueError(f"unknown arrival process {process!r}")


def warm(rt, qe: np.ndarray, qt: np.ndarray, mix: dict, seed: int,
         overloaded: type = RuntimeError) -> None:
    """A closed mix's warm-up before the window, counted as set-up:
    requests of the same shapes from the same pool, on another seed
    stream.  (An open mix warms in its window's lead-in.)"""
    if mix["arrivals"]["process"] == "closed":
        closed(rt, qe, qt, mix, seed + 1, math.inf, overloaded=overloaded,
               max_requests=mix["warm_requests"])


def not_served(log: Log, mix: dict) -> int:
    """Requests whose answer never came, less those that admission
    control turned away where the mix expects it."""
    bad = ~log.ok
    if mix.get("rejects", "fail") == "expected":
        bad &= ~log.rejected
    return int(bad.sum())


def lateness_ms(log: Log) -> dict:
    """How late the sender ran: quantiles of sent − due, in ms."""
    late = (log.sent - log.due)[np.isfinite(log.sent)] * 1e3
    if late.size == 0:
        return {}
    return {"p50": float(np.percentile(late, 50)),
            "p99": float(np.percentile(late, 99)),
            "max": float(late.max())}

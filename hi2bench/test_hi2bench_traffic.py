"""The traffic generator: repeatable by seed, its arrival processes and
query draws as the mix's data describe them, and the open loop's latency
timed from each request's due time."""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from hi2bench import planes as planes_mod, traffic
from hi2bench.conftest import micro


PERMUTE = {"law": "permute"}
STEADY = [[2.0, 5000.0]]


def test_orders_and_arrivals_repeat_by_seed():
    a = traffic._order(2**31 + 5, 32, 1000, PERMUTE)
    assert np.array_equal(a, traffic._order(2**31 + 5, 32, 1000, PERMUTE))
    assert not np.array_equal(a, traffic._order(2**31 + 6, 32, 1000,
                                                PERMUTE))
    # one permutation of the pool after another
    assert sorted(a[:32].tolist()) == list(range(32))
    t = traffic.arrivals(2**33 + 1, STEADY, 2.0)
    assert np.array_equal(t, traffic.arrivals(2**33 + 1, STEADY, 2.0))
    assert not np.array_equal(t, traffic.arrivals(2**33 + 2, STEADY, 2.0))
    assert t.min() >= 0 and t.max() < 2.0 and np.all(np.diff(t) > 0)
    assert abs(t.size - 10000) < 400        # Poisson: 10000 ± 4 sigma


def test_arrivals_follow_the_steps_of_their_rate():
    """On/off bursts: 0.1 s at 20,000/s, then 0.3 s off, cycled."""
    t = traffic.arrivals(2**31 + 9, [[0.1, 20000.0], [0.3, 0.0]], 2.0)
    phase = np.mod(t, 0.4)
    assert (phase < 0.1).all()
    assert abs(t.size - 10000) < 400
    # one step: a constant rate, the same process whatever its length
    a = traffic.arrivals(2**31 + 9, [[0.5, 1000.0]], 4.0)
    assert abs(a.size - 4000) < 260 and np.all(np.diff(a) > 0)


def test_zipf_draw_repeats_a_head_of_the_pool():
    law = {"law": "zipf", "s": 1.2}
    a = traffic._order(2**32 + 1, 1000, 20000, law)
    assert np.array_equal(a, traffic._order(2**32 + 1, 1000, 20000, law))
    counts = np.bincount(a, minlength=1000)
    top = np.sort(counts)[::-1]
    # P(first rank) = 1 / H(1000, 1.2) ≈ 0.22; the tail is seldom drawn
    assert 0.19 < top[0] / a.size < 0.25
    assert top[:10].sum() > 0.5 * a.size
    # the head is a seeded choice of items, not the first ids
    b = traffic._order(2**32 + 2, 1000, 20000, law)
    assert np.argmax(counts) != np.argmax(np.bincount(b, minlength=1000))


def test_planes_and_pool_repeat_by_seed():
    cfg = micro("msmarco_refine_sq8")
    cpu = torch.device("cpu")
    a = planes_mod.draw(cfg, 2**32 + 3, cpu, 8)
    b = planes_mod.draw(cfg, 2**32 + 3, cpu, 8)
    c = planes_mod.draw(cfg, 2**32 + 4, cpu, 8)
    for x, y in ((a[0].codes, b[0].codes), (a[0].refine_emb, b[0].refine_emb),
                 (a[0].term_entries, b[0].term_entries), (a[1][0], b[1][0]),
                 (a[1][1], b[1][1]), (a[2]["sparse_weights"],
                                      b[2]["sparse_weights"])):
        assert torch.equal(x, y)
    assert not torch.equal(a[1][0], c[1][0])
    assert not torch.equal(a[0].codes, c[0].codes)


class _SlowRuntime:
    """A runtime stand-in: each request resolves ``delay`` after it was
    submitted, on a worker thread; the first submit blocks the sender
    for ``stall`` seconds."""

    def __init__(self, delay: float, stall: float):
        self.delay, self.stall = delay, stall
        self.calls = 0

    def submit(self, qe, qt):
        self.calls += 1
        if self.calls == 1:
            time.sleep(self.stall)
        f = Future()
        t = threading.Timer(self.delay, f.set_result, args=(("row", qe[0]),))
        t.start()
        return f


def _open(rate: float) -> dict:
    return {"rows_per_request": 1, "draw": PERMUTE, "check_queries": 4,
            "arrivals": {"process": "open", "rates": [[1.0, rate]]}}


def test_open_loop_times_from_due_and_reports_lateness():
    mix = _open(400.0)
    qe = np.arange(16, dtype=np.float32)[:, None]
    qt = np.zeros((16, 1), dtype=np.int64)
    rt = _SlowRuntime(delay=0.01, stall=0.2)
    log = traffic.open_loop(rt, qe, qt, mix, 2**31 + 99, 0.5)
    assert log.ok.all() and log.failed == 0
    lat = log.done - log.due
    # every request waits at least its own service time
    assert (lat >= 0.01).all()
    # requests due during the sender's stall (in the first submit) carry
    # the stall: timed from when they were due, not from when they were
    # sent
    stalled = log.due < log.due[0] + 0.15
    stalled[0] = False
    assert stalled.sum() > 10
    assert (lat[stalled] > (log.done - log.sent)[stalled] + 0.04).all()
    late = traffic.lateness_ms(log)
    assert late["max"] >= 150.0
    # only the seed's sample keeps its result
    assert len(log.kept) == 4
    assert all(log.kept[i][1] == qe[log.rows[i][0], 0] for i in log.kept)


def test_open_loop_counts_a_rejected_request_as_failed():
    class Busy(RuntimeError):
        pass

    class Rejecting(_SlowRuntime):
        def submit(self, qe, qt):
            if self.calls % 2:
                self.calls += 1
                raise Busy()
            return super().submit(qe, qt)

    mix = _open(200.0)
    qe = np.zeros((4, 1), dtype=np.float32)
    qt = np.zeros((4, 1), dtype=np.int64)
    log = traffic.open_loop(Rejecting(0.001, 0.0), qe, qt, mix, 7, 0.2,
                            overloaded=Busy)
    assert 0 < log.failed < log.n
    assert np.isnan(log.done[~log.ok]).all()
    assert np.array_equal(log.rejected, ~log.ok)
    # a rejection fails the run unless the mix expects them
    assert traffic.not_served(log, mix) == log.failed
    assert traffic.not_served(log, dict(mix, rejects="expected")) == 0


def test_closed_loop_repeats_its_request_order():
    class Echo:
        def query(self, qe, qt, timeout=None):
            return qe[:, 0].copy()

    mix = {"arrivals": {"process": "closed", "clients": 2},
           "rows_per_request": 4, "pool_requests": 8, "draw": PERMUTE,
           "check_queries": 12}
    qe = np.arange(32, dtype=np.float32)[:, None]
    qt = np.zeros((32, 1), dtype=np.int64)
    logs = [traffic.closed(Echo(), qe, qt, mix, 2**31 + 7, np.inf,
                           max_requests=24) for _ in range(2)]
    firsts = [[int(r[0]) for r in log.rows] for log in logs]
    assert firsts[0] == firsts[1] and len(firsts[0]) == 24
    assert sorted(firsts[0][:8]) == [4 * i for i in range(8)]
    log = logs[0]
    assert log.ok.all() and log.n == 24
    # only the sample's results are held: the 12 // 4 requests of least
    # rank in the seed's ranking
    rank = np.random.default_rng([2**31 + 7, 13]).random(1 << 16)
    assert sorted(log.kept) == sorted(np.argsort(rank[:24])[:3].tolist())
    assert sorted(logs[1].kept) == sorted(log.kept)
    assert all(np.array_equal(log.kept[i], qe[log.rows[i], 0])
               for i in log.kept)

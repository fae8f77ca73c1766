"""The kernels' counts of operations and bytes, and the roofline readers
that divide them by the traced kernel time."""
from __future__ import annotations

import types

import numpy as np
import pytest

from hi2bench import spec, trace


def test_topk_scores_bound_at_the_served_batch():
    """256 queries over 10,000 clusters of 768: 2·N·L·h operations at
    the float32 peak, 0.0587 ms, well above its bytes' time."""
    flops, nbytes = spec.counts("topk_scores").work(n=256, l=10000, h=768,
                                                    k=30)
    assert flops == 2 * 256 * 10000 * 768
    assert nbytes == 4 * (256 * 768 + 10000 * 768) + 8 * 256 * 30
    bound = spec.bound_s("topk_scores", n=256, l=10000, h=768, k=30)
    assert bound == pytest.approx(flops / 67e12)
    assert round(bound * 1e3, 4) == 0.0587
    assert nbytes / 3.35e12 < bound / 5


def test_pq_adc_fused_counts_a_toy_batch():
    """2 queries × 3 slots, 5 live, 4 distinct documents, m 4, k 16:
    5·4 adds; 2·3·4 id bytes, 5·4 score bytes, 2·4·16·4 table bytes and
    4·4 code bytes."""
    work = spec.counts("pq_adc_fused").work
    assert work(b=2, c=3, m=4, k=16, n_live=5, distinct=4) == (20, 572)
    assert spec.counts("pq_adc_fused").PEAK == "fp32_flops"


def test_sq8_dot_fused_counts_a_toy_batch():
    """2 queries × 3 slots, 5 live, 4 distinct rows of h 8: 2·5·8
    operations; 24 id bytes, 20 score bytes, 2·8·4 query bytes, 4·8 code
    bytes."""
    work = spec.counts("sq8_dot_fused").work
    assert work(b=2, c=3, h=8, n_live=5, distinct=4) == (80, 140)


def test_peaks_are_the_published_ones():
    pk = spec.peaks()
    assert pk["fp32_flops"] == 67e12 and pk["hbm_bytes_per_s"] == 3.35e12


def _trace(ops):
    names = np.array([n for n, _, _ in ops], dtype=object)
    return trace.Trace(window_s=1.0, names=names,
                       start=np.array([a for _, a, _ in ops], dtype=float),
                       end=np.array([b for _, _, b in ops], dtype=float),
                       host=[], kinds=np.array([trace._kind(n) for n in names],
                                               dtype=object))


class _Ctx:
    def __init__(self, tr, cfg, batches, live=()):
        self.trace, self.cfg = tr, cfg
        self.stats0 = {"n_batches": 0, "n_served": 0, "bucket_counts": {}}
        self.stats1 = {"n_batches": sum(batches.values()),
                       "n_served": sum(b * n for b, n in batches.items()),
                       "bucket_counts": dict(batches)}
        self._live = list(live)

    def bucket_batches(self):
        return self.stats1["bucket_counts"]

    def batch_live(self):
        return self._live


CFG = {"n_clusters": 10000, "hidden": 768, "kc": 30, "pq_m": 96, "pq_k": 256}


def test_roofline_readers_read_100_at_the_bound():
    one = spec.bound_s("topk_scores", n=256, l=10000, h=768, k=30)
    tr = _trace([("void (anonymous namespace)::topk_kernel<true>(float)",
                  0.0, one), ("other", one, 2 * one),
                 ("void (anonymous namespace)::topk_kernel<true>(float)",
                  0.5, 0.5 + one)])
    got = spec.reader("topk_scores_roofline")(_Ctx(tr, CFG, {256: 2}))
    assert got == pytest.approx(100.0)
    live = [{"b": 256, "c": 63488, "n_live": 9_000_000,
             "distinct": 5_000_000}]
    need = spec.bound_s("pq_adc_fused", b=256, c=63488, m=96, k=256,
                        n_live=9_000_000, distinct=5_000_000)
    tr = _trace([("void (anonymous namespace)::adc_fused<unsigned char, "
                  "256, true>(float const*)", 0.0, 4 * need)])
    got = spec.reader("pq_adc_fused_roofline")(_Ctx(tr, CFG, {256: 1},
                                                        live))
    assert got == pytest.approx(25.0)


def test_readers_return_nothing_where_nothing_ran():
    tr = _trace([("memcpy HtoD", 0.0, 0.1)])
    ctx = _Ctx(tr, CFG, {256: 3})
    for m in ("topk_scores_roofline", "pq_adc_fused_roofline",
              "sq8_dot_fused_roofline", "stages.sort_ms",
              "stages.device_ms"):
        assert spec.reader(m)(ctx) is None, m
    assert spec.reader("device.idle_pct")(ctx) == pytest.approx(90.0)
    none = types.SimpleNamespace(trace=None, stats0=ctx.stats0,
                                 stats1=ctx.stats1)
    assert spec.reader("device.idle_pct")(none) is None


def test_a_metric_split_by_its_cells_shares_its_stems_reader():
    """``device.idle_pct.serve`` (moving another end-to-end metric than
    ``device.idle_pct``) reads by ``metrics/device.idle_pct.py``; a name
    with no reader at any stem is refused."""
    assert (spec.reader("device.idle_pct.serve").__code__.co_filename
            == spec.reader("device.idle_pct").__code__.co_filename)
    with pytest.raises(KeyError):
        spec.reader("no_such.metric")

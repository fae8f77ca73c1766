"""Port parity of the kernels: the plain versions behind
``repro_torch.kernels.{pq_adc,assign_topk,sq8_dot}.ops`` (what a CPU
tensor takes) against the JAX kernels in Pallas interpret mode and their
jnp oracles, on identical numpy inputs from a seed.  The CUDA kernels
themselves are held against the same plain versions on the card by
``chip_smoke.py``.

Tolerances: ADC scores 1e-4 (the kernels sum the m fragments in
another order than the oracles); top-k ids bit-identical, including the
lowest-index-first order under constructed ties, scores 1e-5; SQ8 dots
rtol 1e-4, atol 1e-2 (the reference kernel test's own: an h-long dot of
byte codes against the MXU's reduction order), ``-inf`` lanes identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # accelerator image: no pip installs; CI has the real one
    from _hypothesis_fallback import given, settings, strategies as st

from repro.kernels.assign_topk import ops as jat_ops
from repro.kernels.assign_topk import ref as jat_ref
from repro.kernels.pq_adc import ops as jadc_ops
from repro.kernels.pq_adc import ref as jadc_ref
from repro.kernels.sq8_dot import ops as jsq8_ops
from repro.kernels.sq8_dot import ref as jsq8_ref
from repro_torch.kernels import _build
from repro_torch.kernels.assign_topk import ops as at_ops
from repro_torch.kernels.pq_adc import ops as adc_ops
from repro_torch.kernels.sq8_dot import ops as sq8_ops

torch.set_num_threads(2)


# --------------------------------------------------------------------------
# pq_adc_fused
# --------------------------------------------------------------------------

def _adc_case(seed, b, c, m, k, n, dtype, mask_row, dup):
    rng = np.random.default_rng(seed)
    lut = rng.normal(size=(b, m, k)).astype(np.float32)
    plane = rng.integers(0, k, size=(n, m)).astype(dtype)
    ids = rng.integers(0, n, size=(b, c)).astype(np.int32)
    if dup:              # every id appears at least twice per row
        ids = np.concatenate([ids[:, : (c + 1) // 2]] * 2, -1)[:, :c]
    live = (rng.random((b, c)) < 0.8).astype(np.int32)
    if mask_row is not None:
        live[mask_row % b] = 0                       # fully masked row
    return lut, plane, ids, live


ADC_CASES = {
    # name: (b, c, m, k, code dtype, duplicate ids, fully masked row)
    "c_ragged": (2, 300, 4, 64, np.uint8, False, None),
    "c_below_tile": (3, 5, 8, 128, np.uint8, False, 1),
    "int32_dup_masked": (2, 257, 8, 256, np.int32, True, 0),
    "uint8_dup_masked": (4, 130, 16, 256, np.uint8, True, 3),
    "single_slot": (1, 1, 1, 64, np.int32, False, None),
    "paper_m96_k256": (2, 384, 96, 256, np.uint8, False, 1),
}


@pytest.mark.parametrize("name", sorted(ADC_CASES))
def test_pq_adc_fused_plain_matches_jax(name):
    b, c, m, k, dtype, dup, mask_row = ADC_CASES[name]
    lut, plane, ids, live = _adc_case(len(name), b, c, m, k, 500, dtype,
                                      mask_row, dup)
    got = adc_ops.pq_adc_fused(torch.from_numpy(lut),
                               torch.from_numpy(plane),
                               torch.from_numpy(ids),
                               torch.from_numpy(live.astype(bool))).numpy()
    args = tuple(jnp.asarray(a) for a in (lut, plane, ids, live))
    for want in (np.asarray(jadc_ops.pq_adc_fused(*args, c_blk=128)),
                 np.asarray(jadc_ref.pq_adc_fused(*args))):
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4,
                                   atol=1e-4)
    if mask_row is not None:
        assert np.isneginf(got[mask_row % b]).all()


# --------------------------------------------------------------------------
# topk_scores
# --------------------------------------------------------------------------

TOPK_CASES = {
    # name: (n, l, h, k, duplicated centroid rows)
    "small": (5, 37, 16, 4, False),
    "ties": (33, 300, 32, 12, True),
    "k_equals_l": (3, 2, 16, 2, True),
    "ragged_l": (70, 600, 32, 30, False),
    "ties_ragged": (16, 129, 16, 8, True),
}


@pytest.mark.parametrize("name", sorted(TOPK_CASES))
def test_topk_scores_plain_matches_jax(name):
    n, l, h, k, ties = TOPK_CASES[name]
    rng = np.random.default_rng(n * 13 + l)
    x = rng.normal(size=(n, h)).astype(np.float32)
    emb = rng.normal(size=(l, h)).astype(np.float32)
    if ties:             # duplicate the first half: every score tied 2x
        emb = np.concatenate([emb[: (l + 1) // 2]] * 2)[:l]
    gs, gi = at_ops.topk_scores(torch.from_numpy(x), torch.from_numpy(emb), k)
    for ws, wi in (jat_ops.topk_scores(jnp.asarray(x), jnp.asarray(emb), k,
                                       l_blk=128),
                   jat_ref.topk_scores(jnp.asarray(x), jnp.asarray(emb), k)):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                                   atol=1e-5)
    assert gi.dtype == torch.int32 and gs.dtype == torch.float32


# --------------------------------------------------------------------------
# sq8_dot_fused
# --------------------------------------------------------------------------

def _sq8_case(seed, b, c, h, n, mask_row, dup=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h)).astype(np.float32)
    plane = rng.integers(0, 256, size=(n, h)).astype(np.uint8)
    ids = rng.integers(0, n, size=(b, c)).astype(np.int32)
    if dup:              # every id appears at least twice per row
        ids = np.concatenate([ids[:, : (c + 1) // 2]] * 2, -1)[:, :c]
    live = (rng.random((b, c)) < 0.8).astype(np.int32)
    if mask_row is not None:
        live[mask_row % b] = 0                       # fully masked row
    return q, plane, ids, live


def _check_sq8(args, mask_row):
    q, plane, ids, live = args
    got = sq8_ops.sq8_dot_fused(torch.from_numpy(q), torch.from_numpy(plane),
                                torch.from_numpy(ids),
                                torch.from_numpy(live.astype(bool))).numpy()
    jargs = tuple(jnp.asarray(a) for a in args)
    for want in (np.asarray(jsq8_ops.sq8_dot_fused(*jargs, c_blk=128)),
                 np.asarray(jsq8_ref.sq8_dot_fused(*jargs))):
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4,
                                   atol=1e-2)
    if mask_row is not None:
        assert np.isneginf(got[mask_row % q.shape[0]]).all()


@settings(max_examples=12, deadline=None)
@given(b=st.integers(1, 4), c=st.integers(1, 700),
       h=st.sampled_from([16, 32, 64]), mask_row=st.integers(0, 3))
def test_sq8_dot_fused_plain_matches_jax(b, c, h, mask_row):
    """The grid of tests/test_kernels.py::test_sq8_dot_fused_matches_oracle."""
    _check_sq8(_sq8_case(b * 31 + c, b, c, h, 400, mask_row), mask_row)


SQ8_CASES = {
    # name: (b, c, h, duplicate ids, fully masked row)
    "h40_unvectorized": (3, 130, 40, False, None),
    "dup_ids": (2, 257, 32, True, 1),
    "single_slot": (1, 1, 16, False, None),
    "paper_h768": (2, 300, 768, False, 0),
}


@pytest.mark.parametrize("name", sorted(SQ8_CASES))
def test_sq8_dot_fused_plain_matches_jax_edges(name):
    b, c, h, dup, mask_row = SQ8_CASES[name]
    _check_sq8(_sq8_case(len(name), b, c, h, 500, mask_row, dup), mask_row)


# --------------------------------------------------------------------------
# wrapper contract
# --------------------------------------------------------------------------

def test_cpu_tensors_never_touch_the_build(monkeypatch):
    """CPU tensors take the plain version: no nvcc, no library load, no
    launch counted."""
    def refuse(*a, **kw):
        raise AssertionError("the CPU path reached the kernel build")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "library", refuse)
    before = (adc_ops.launches, at_ops.launches, sq8_ops.launches)
    lut, plane, ids, live = _adc_case(0, 2, 40, 4, 64, 50, np.uint8, None,
                                      False)
    adc_ops.pq_adc_fused(torch.from_numpy(lut), torch.from_numpy(plane),
                         torch.from_numpy(ids),
                         torch.from_numpy(live.astype(bool)))
    at_ops.topk_scores(torch.randn(4, 8), torch.randn(20, 8), 3)
    q, plane, ids, live = _sq8_case(0, 2, 40, 16, 50, None)
    sq8_ops.sq8_dot_fused(torch.from_numpy(q), torch.from_numpy(plane),
                          torch.from_numpy(ids),
                          torch.from_numpy(live.astype(bool)))
    assert (adc_ops.launches, at_ops.launches, sq8_ops.launches) == before


@pytest.mark.parametrize("bad", ["lut_f64", "ids_i64", "live_i32", "plane_m"])
def test_pq_adc_fused_rejects_what_the_kernel_does_not_take(bad):
    lut = torch.zeros(2, 4, 16)
    plane = torch.zeros(10, 4, dtype=torch.uint8)
    ids = torch.zeros(2, 5, dtype=torch.int32)
    live = torch.ones(2, 5, dtype=torch.bool)
    if bad == "lut_f64":
        lut = lut.double()
    elif bad == "ids_i64":
        ids = ids.long()
    elif bad == "live_i32":
        live = live.int()
    else:
        plane = torch.zeros(10, 3, dtype=torch.uint8)
    with pytest.raises(ValueError):
        adc_ops.pq_adc_fused(lut, plane, ids, live)


@pytest.mark.parametrize("bad", ["k_zero", "k_above_l", "h_mismatch",
                                 "x_f64"])
def test_topk_scores_rejects_what_the_kernel_does_not_take(bad):
    x, emb, k = torch.zeros(3, 8), torch.zeros(10, 8), 4
    if bad == "k_zero":
        k = 0
    elif bad == "k_above_l":
        k = 11
    elif bad == "h_mismatch":
        emb = torch.zeros(10, 7)
    else:
        x = x.double()
    with pytest.raises(ValueError):
        at_ops.topk_scores(x, emb, k)


@pytest.mark.parametrize("bad", ["q_f64", "plane_i32", "plane_h", "ids_i64",
                                 "live_i32", "no_rows"])
def test_sq8_dot_fused_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(2, 16)
    plane = torch.zeros(10, 16, dtype=torch.uint8)
    ids = torch.zeros(2, 5, dtype=torch.int32)
    live = torch.ones(2, 5, dtype=torch.bool)
    if bad == "q_f64":
        q = q.double()
    elif bad == "plane_i32":
        plane = plane.int()
    elif bad == "plane_h":
        plane = torch.zeros(10, 15, dtype=torch.uint8)
    elif bad == "ids_i64":
        ids = ids.long()
    elif bad == "live_i32":
        live = live.int()
    else:
        plane = plane[:0]
    with pytest.raises(ValueError):
        sq8_ops.sq8_dot_fused(q, plane, ids, live)

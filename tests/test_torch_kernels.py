"""Port parity of the kernels: the plain versions behind
``repro_torch.kernels.{pq_adc,assign_topk,sq8_dot,flash_attention}.ops``
(what a CPU tensor takes) against the JAX kernels in Pallas interpret
mode and their jnp oracles, on identical numpy inputs from a seed.  The
CUDA kernels themselves are held against the same plain versions on the
card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

Tolerances: ADC scores 1e-4 (the kernels sum the m fragments in
another order than the oracles); top-k ids bit-identical, including the
lowest-index-first order under constructed ties, scores 1e-5; SQ8 dots
rtol 1e-4, atol 1e-2 (the reference kernel test's own: an h-long dot of
byte codes against the MXU's reduction order), ``-inf`` lanes identical;
assignment ids bit-identical (ties included), scores 1e-5; attention
outputs and ``lse`` 3e-4 (the reference kernel test's own).
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
from repro.kernels.flash_attention import kernel as jfa_kernel
from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention import ref as jfa_ref
from repro.kernels.assign_topk import ref as jat_ref
from repro.kernels.pq_adc import ops as jadc_ops
from repro.kernels.pq_adc import ref as jadc_ref
from repro.kernels.sq8_dot import ops as jsq8_ops
from repro.kernels.sq8_dot import ref as jsq8_ref
from repro_torch.kernels import _build
from repro_torch.kernels.assign_topk import ops as at_ops
from repro_torch.kernels.assign_topk import ref as at_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
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
# assign_argmax
# --------------------------------------------------------------------------

ASSIGN_CASES = {
    # name: (n, l, h, duplicated centroid rows)
    "small": (7, 5, 8, False),
    "l_not_multiple_of_512": (70, 700, 16, False),
    "ties": (64, 300, 32, True),
    "ties_across_tiles": (33, 1030, 8, True),
    "single_centroid": (5, 1, 40, False),
}


def _assign_case(name):
    n, l, h, ties = ASSIGN_CASES[name]
    rng = np.random.default_rng(n * 7 + l)
    x = rng.normal(size=(n, h)).astype(np.float32)
    c = rng.normal(size=(l, h)).astype(np.float32)
    if ties:             # duplicate the first half: every centroid twice
        c = np.concatenate([c[: (l + 1) // 2]] * 2)[:l]
    return x, c


@pytest.mark.parametrize("name", sorted(ASSIGN_CASES))
def test_assign_argmax_plain_matches_jax(name):
    x, c = _assign_case(name)
    gs, gi = at_ops.assign_argmax(torch.from_numpy(x), torch.from_numpy(c))
    assert gi.dtype == torch.int32 and gs.dtype == torch.float32
    for ws, wi in (jat_ops.assign_argmax(jnp.asarray(x), jnp.asarray(c)),
                   jat_ref.assign_argmax(jnp.asarray(x), jnp.asarray(c))):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                                   atol=1e-5)
    if ASSIGN_CASES[name][3]:          # every winner is the lower twin
        half = (c.shape[0] + 1) // 2
        assert (gi.numpy() < half).all()


def test_assign_argmax_batched_is_per_fragment_and_l2_argmin():
    """The leading batch axis (PQ's m fragments) is m independent calls,
    and the argmax is the L2 argmin (the KMeans contract)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 50, 8)).astype(np.float32)
    c = rng.normal(size=(3, 20, 8)).astype(np.float32)
    c[1, 11] = c[1, 4]                  # a constructed tie in fragment 1
    # a strided view, as PQ's (m, n, d_sub) view of (n, m·d_sub) data
    xv = torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2))
                          ).transpose(0, 1)
    gs, gi = at_ops.assign_argmax(xv, torch.from_numpy(c))
    assert gi.shape == (3, 50)
    for f in range(3):
        ws, wi = jat_ops.assign_argmax(jnp.asarray(x[f]), jnp.asarray(c[f]))
        np.testing.assert_array_equal(gi[f].numpy(), np.asarray(wi))
        np.testing.assert_allclose(gs[f].numpy(), np.asarray(ws), rtol=1e-5,
                                   atol=1e-5)
        d = np.linalg.norm(x[f][:, None] - c[f][None], axis=-1)
        np.testing.assert_array_equal(gi[f].numpy(), d.argmin(axis=1))
    assert 11 not in gi[1].tolist()


# --------------------------------------------------------------------------
# flash_attention
# --------------------------------------------------------------------------

def _qkv(seed, b, hq, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, d)).astype(np.float32))


def _lse_oracle(q, k, causal, window):
    """logsumexp of the reference's masked scores; NEG_INF on rows with
    no visible key."""
    b, hq, sq, d = q.shape
    kg = np.repeat(k, hq // k.shape[1], axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64) / np.sqrt(d), kg)
    qp, kp = np.arange(sq)[:, None], np.arange(k.shape[2])[None, :]
    mask = np.ones((sq, k.shape[2]), bool)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= (qp - kp) < window
        if not causal:
            mask &= (kp - qp) < window
    s = np.where(mask, s, -np.inf)
    top = s.max(-1, keepdims=True)
    with np.errstate(invalid="ignore"):
        lse = (top + np.log(np.exp(s - top).sum(-1, keepdims=True)))[..., 0]
    return np.where(mask.any(-1), lse, fa_ref.NEG_INF)


@settings(max_examples=8, deadline=None)
@given(sq=st.sampled_from([64, 200, 256]), sk=st.sampled_from([64, 256, 384]),
       d=st.sampled_from([32, 64]), causal=st.booleans(),
       window=st.sampled_from([0, 32]),
       heads=st.sampled_from([(4, 4), (4, 2), (8, 1)]))
def test_flash_attention_plain_matches_jax(sq, sk, d, causal, window, heads):
    """The grid of tests/test_kernels.py::test_flash_attention_matches_oracle
    at its tolerance, against the Pallas kernel (interpret mode) and the
    dense oracle, plus ``lse`` against the masked scores' logsumexp."""
    if causal and sk != sq:
        sk = sq  # causal masks assume aligned positions
    hq, hkv = heads
    q, k, v = _qkv(sq * 31 + sk, 1, hq, hkv, sq, sk, d)
    out, lse = fa_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), causal, window)
    args = tuple(jnp.asarray(a) for a in (q, k, v))
    for want in (jfa_ops.flash_attention(*args, causal, window, None),
                 jfa_ref.attention(*args, causal=causal, window=window)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=3e-4,
                                   atol=3e-4)
    np.testing.assert_allclose(lse.numpy(), _lse_oracle(q, k, causal, window),
                               rtol=3e-4, atol=3e-4)


def test_flash_attention_lse_and_fully_masked_rows_match_the_kernel():
    """A non-causal window with Sq > Sk leaves rows with no visible key:
    zeros out and lse = -1e30, as the Pallas kernel writes them; its lse
    elsewhere (tile-aligned shapes, so no wrapper padding) too."""
    q, k, v = _qkv(11, 2, 4, 2, 256, 128, 32)
    out, lse = fa_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), False, 32)
    jout, jlse = jfa_kernel.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=False, window=32,
        interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=3e-4,
                               atol=3e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=3e-4,
                               atol=3e-4)
    dead = np.arange(256) >= 128 + 32 - 1     # no key within the window
    assert dead.sum() > 0
    assert (out.numpy()[:, :, dead] == 0).all()
    assert (lse.numpy()[:, :, dead] == fa_ref.NEG_INF).all()
    assert np.isfinite(lse.numpy()[:, :, ~dead]).all()


def test_flash_attention_chunked_equals_dense():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 4, 2, 130, 70, 16))
    for causal, window in ((True, 0), (False, 9), (True, 16)):
        dense = fa_ref.attention(q, k, v, causal=causal, window=window)
        chunked = fa_ref.attention_chunked(q, k, v, causal=causal,
                                           window=window, q_chunk=32)
        torch.testing.assert_close(chunked, dense, rtol=1e-6, atol=1e-6)


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
    before = (adc_ops.launches, at_ops.launches, sq8_ops.launches,
              at_ops.assign_launches, fa_ops.launches)
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
    at_ops.assign_argmax(torch.randn(2, 9, 8), torch.randn(2, 4, 8))
    fa_ops.flash_attention(torch.randn(1, 2, 5, 16), torch.randn(1, 1, 7, 16),
                           torch.randn(1, 1, 7, 16))
    assert (adc_ops.launches, at_ops.launches, sq8_ops.launches,
            at_ops.assign_launches, fa_ops.launches) == before


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


@pytest.mark.parametrize("bad", ["x_f64", "h_mismatch", "rank_mismatch",
                                 "batch_mismatch", "no_centroids"])
def test_assign_argmax_rejects_what_the_kernel_does_not_take(bad):
    x, c = torch.zeros(2, 6, 8), torch.zeros(2, 4, 8)
    if bad == "x_f64":
        x = x.double()
    elif bad == "h_mismatch":
        c = torch.zeros(2, 4, 7)
    elif bad == "rank_mismatch":
        c = c[0]
    elif bad == "batch_mismatch":
        c = torch.zeros(3, 4, 8)
    else:
        c = c[:, :0]
    with pytest.raises(ValueError):
        at_ops.assign_argmax(x, c)


@pytest.mark.parametrize("bad", ["q_f64", "mixed_dtype", "heads_not_grouped",
                                 "d_mismatch", "rank", "negative_window",
                                 "empty_keys"])
def test_flash_attention_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = torch.zeros(1, 4, 8, 16), torch.zeros(1, 2, 8, 16), torch.zeros(
        1, 2, 8, 16)
    window = 0
    if bad == "q_f64":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "mixed_dtype":
        k = k.bfloat16()
    elif bad == "heads_not_grouped":
        k, v = torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16)
    elif bad == "d_mismatch":
        k, v = torch.zeros(1, 2, 8, 8), torch.zeros(1, 2, 8, 8)
    elif bad == "rank":
        q = q[0]
    elif bad == "negative_window":
        window = -1
    else:
        k, v = k[:, :, :0], v[:, :, :0]
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k, v, True, window)

"""Port parity of the kernels: the plain versions behind
``repro_torch.kernels.{pq_adc,assign_topk,sq8_dot,flash_attention}.ops``
(what a CPU tensor takes) against the JAX kernels in Pallas interpret
mode and their jnp oracles, on identical numpy inputs from a seed.  The
CUDA kernels themselves are held against the same plain versions on the
card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

Tolerances: fused ADC scores 1e-4 (the kernels sum the m fragments in
another order than the oracles); unfused ADC scores 1e-5 on the
reference test's grid and 1e-4 at m = 96, its own; top-k ids
bit-identical, including the lowest-index-first order under constructed
ties, scores 1e-5; SQ8 dots rtol 1e-4, atol 1e-2 (the reference kernel
test's own: an h-long dot of byte codes against the MXU's reduction
order), ``-inf`` lanes identical;
assignment ids bit-identical (ties included), scores 1e-5; attention
outputs and ``lse`` 3e-4 (the reference kernel test's own).
"""
import pathlib

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


@pytest.mark.parametrize("b, c, grid", [
    (3, 1000, 7),            # ragged C: ranges cut queries mid-way
    (1, 5, 1),               # B = 1, one block
    (1, 5, 8),               # more blocks than slots: some ranges empty
    (600, 200, 132),         # B above one wave: ranges span queries
    (256, 63_488, 132),      # the served plane
])
def test_pq_adc_fused_block_ranges_cover_every_slot_once(b, c, grid):
    """The kernel's cut of the flattened (B, C) plane into ``grid``
    ranges covers every (query, slot) exactly once, in order, with
    sizes within one; the LUT copies it makes are one per block per
    query its range touches."""
    ranges = adc_ops.block_ranges(b * c, grid)
    assert len(ranges) == grid
    assert ranges[0][0] == 0 and ranges[-1][1] == b * c
    assert all(hi == lo for (_, hi), (lo, _) in zip(ranges, ranges[1:]))
    sizes = {hi - lo for lo, hi in ranges}
    assert max(sizes) - min(sizes) <= 1
    seen = np.zeros(b * c, dtype=np.int64)
    stagings = 0
    for lo, hi in ranges:
        seen[lo:hi] += 1
        stagings += len({s // c for s in range(lo, hi)})
    assert (seen == 1).all()
    assert adc_ops.lut_stagings(b, c, grid) == stagings
    assert stagings <= grid + b - 1


def test_pq_adc_fused_grid_is_one_wave_or_fewer():
    """One wave of resident blocks, fewer where a block would take less
    than ``min_slots``, never none; at the served plane 132 blocks stage
    at most 50 MB of LUTs (m 96, k 256)."""
    p = adc_ops.Plan(instance=0, resident=132, min_slots=512)
    assert adc_ops.grid_size(256 * 63_488, p) == 132
    assert adc_ops.grid_size(64 * 2048, p) == 132
    assert adc_ops.grid_size(20 * 512, p) == 20
    assert adc_ops.grid_size(1, p) == 1
    assert adc_ops.lut_stagings(256, 63_488, 132) * 96 * 256 * 4 <= 50e6


@pytest.mark.parametrize("case, want", [
    ("u8_m96", True), ("u8_m16", True), ("u8_m8", False), ("u8_m3", False),
    ("u8_m96_offset1", False), ("u8_m96_offset16", True), ("i32_m4", True),
    ("i32_m3", False), ("i32_m8_offset4", False)])
def test_pq_adc_fused_rows_vectorizable(case, want):
    """16-byte row pieces need whole pieces a row and an aligned base:
    m · code bytes a multiple of 16 and the plane's address too."""
    dtype, m, offset = {
        "u8_m96": (torch.uint8, 96, 0), "u8_m16": (torch.uint8, 16, 0),
        "u8_m8": (torch.uint8, 8, 0), "u8_m3": (torch.uint8, 3, 0),
        "u8_m96_offset1": (torch.uint8, 96, 1),
        "u8_m96_offset16": (torch.uint8, 96, 16),
        "i32_m4": (torch.int32, 4, 0), "i32_m3": (torch.int32, 3, 0),
        "i32_m8_offset4": (torch.int32, 8, 1)}[case]
    flat = torch.zeros(10 * m + 64, dtype=dtype)
    skip = (-flat.data_ptr() % 16) // flat.element_size() + offset
    plane = flat[skip:skip + 10 * m].view(10, m)
    assert plane.data_ptr() % 16 == (offset * flat.element_size()) % 16
    assert adc_ops.rows_vectorizable(plane) is want


def test_pq_adc_fused_kernel_args_follow_argtypes():
    """The wrapper's argument list matches the C entry's ctypes signature
    position by position: lut, plane, ids, live, out, B, C, m, k, N, the
    code bytes, ``vec``, the grid and the stream."""
    lut = torch.zeros(3, 8, 256)
    plane = torch.zeros(50, 8, dtype=torch.int32)
    ids = torch.zeros(3, 700, dtype=torch.int32)
    live = torch.ones(3, 700, dtype=torch.bool)
    out = torch.empty(3, 700)
    args = adc_ops.kernel_args(lut, plane, ids, live, out, True, 64, 11)
    assert len(args) == len(adc_ops.ARGTYPES)
    assert args[:5] == [t.data_ptr() for t in (lut, plane, ids, live, out)]
    assert args[5:] == [3, 700, 8, 256, 50, 4, 1, 64, 11]
    for ctype, arg in zip(adc_ops.ARGTYPES, args):
        ctype(arg)
    assert len(adc_ops.PLAN_ARGTYPES) == 4 + len(adc_ops.Plan._fields)


# --------------------------------------------------------------------------
# pq_adc (the unfused ADC over gathered codes)
# --------------------------------------------------------------------------

def _unfused_case(seed, b, c, m, k, dtype):
    rng = np.random.default_rng(seed)
    lut = rng.normal(size=(b, m, k)).astype(np.float32)
    return lut, rng.integers(0, k, size=(b, c, m)).astype(dtype)


def _assert_pq_adc_matches_jax(lut, codes, tol):
    got = adc_ops.pq_adc(torch.from_numpy(lut), torch.from_numpy(codes))
    assert got.dtype == torch.float32 and got.shape == codes.shape[:2]
    jl, jc = jnp.asarray(lut), jnp.asarray(codes.astype(np.int32))
    for want in (jadc_ops.pq_adc(jl, jc, c_blk=128),     # interpret mode
                 jadc_ref.pq_adc(jl, jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)


@settings(max_examples=12, deadline=None)
@given(b=st.integers(1, 4), c=st.integers(1, 700),
       m=st.sampled_from([1, 3, 8, 16]), k=st.sampled_from([128, 256]),
       u8=st.booleans())
def test_pq_adc_plain_matches_jax(b, c, m, k, u8):
    """The grid of tests/test_kernels.py::test_pq_adc_matches_oracle, with
    uint8 and int32 codes, at its 1e-5."""
    lut, codes = _unfused_case(b * 1000 + c, b, c, m, k,
                               np.uint8 if u8 else np.int32)
    _assert_pq_adc_matches_jax(lut, codes, 1e-5)


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_pq_adc_plain_matches_jax_paper_scale(dtype):
    """m = 96, k = 256 over 2,048 candidates, at the reference's 1e-4."""
    lut, codes = _unfused_case(0, 2, 2048, 96, 256, dtype)
    _assert_pq_adc_matches_jax(lut, codes, 1e-4)


def test_pq_adc_equals_pq_adc_fused_on_gathered_codes():
    """The unfused path (gather, then ADC) scores live lanes as the fused
    one does: bitwise on the CPU, where both take one plain version."""
    lut, plane, ids, live = _adc_case(5, 3, 300, 8, 128, 200, np.uint8, 1,
                                      True)
    lut, plane, ids = (torch.from_numpy(a) for a in (lut, plane, ids))
    live = torch.from_numpy(live.astype(bool))
    fused = adc_ops.pq_adc_fused(lut, plane, ids, live)
    unfused = adc_ops.pq_adc(lut, plane[ids.long()])
    assert torch.equal(fused[live], unfused[live])


# --------------------------------------------------------------------------
# topk_scores
# --------------------------------------------------------------------------

TOPK_CASES = {
    # name: (n, l, h, k, centroid layout): "ties" duplicates the first
    # half of the rows (every score tied 2x), "ascending" scales one row by
    # (j + 1) / L with each query's sign set so that its scores rise with
    # the id, "equal" repeats one row (every score of a query tied)
    "small": (5, 37, 16, 4, "random"),
    "ties": (33, 300, 32, 12, "ties"),
    "k_equals_l": (3, 2, 16, 2, "ties"),
    "ragged_l": (70, 600, 32, 30, "random"),
    "ties_ragged": (16, 129, 16, 8, "ties"),
    "ascending": (16, 600, 32, 30, "ascending"),
    "all_equal": (12, 300, 16, 30, "equal"),
    "k128_l129": (5, 129, 40, 128, "random"),
}


@pytest.mark.parametrize("name", sorted(TOPK_CASES))
def test_topk_scores_plain_matches_jax(name):
    n, l, h, k, layout = TOPK_CASES[name]
    rng = np.random.default_rng(n * 13 + l)
    x = rng.normal(size=(n, h)).astype(np.float32)
    emb = rng.normal(size=(l, h)).astype(np.float32)
    if layout == "ties":
        emb = np.concatenate([emb[: (l + 1) // 2]] * 2)[:l]
    elif layout == "ascending":
        x *= np.where(x @ emb[0] < 0, -1, 1).astype(np.float32)[:, None]
        emb = (np.arange(1, l + 1, dtype=np.float32) / l)[:, None] * emb[0]
    elif layout == "equal":
        emb = np.repeat(emb[:1], l, axis=0)
    gs, gi = at_ops.topk_scores(torch.from_numpy(x), torch.from_numpy(emb), k)
    for ws, wi in (jat_ops.topk_scores(jnp.asarray(x), jnp.asarray(emb), k,
                                       l_blk=128),
                   jat_ref.topk_scores(jnp.asarray(x), jnp.asarray(emb), k)):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                                   atol=1e-5)
    assert gi.dtype == torch.int32 and gs.dtype == torch.float32



# the kernel's tiles (csrc/topk_scores.cu: 32 queries × 256 centroids,
# one block an SM), a two-blocks-an-SM build of the same tiles, and the
# parent's (16, 64) at 4 an SM
SLICE_TILES = {"kernel": at_ops.Tiles(32, 256, 1),
               "two_an_sm": at_ops.Tiles(32, 256, 2),
               "parent": at_ops.Tiles(16, 64, 4)}


@pytest.mark.parametrize("tiles", sorted(SLICE_TILES))
@pytest.mark.parametrize("n, l", [(256, 10_000), (1, 10_000), (257, 10_000),
                                  (33, 129), (4096, 10_000), (5, 20)])
def test_topk_n_slices_fill_one_wave_with_whole_tiles(tiles, n, l):
    tl = SLICE_TILES[tiles]
    sms = 132
    s = at_ops.n_slices(n, l, sms, tl)
    q_tiles = -(-n // tl.queries_per_block)
    c_tiles = -(-l // tl.centroid_tile)
    assert 1 <= s <= c_tiles                  # at most a slice per tile
    # one wave where the query tiles leave room, else one slice
    assert q_tiles * s <= max(tl.blocks_per_sm * sms, q_tiles)
    per = -(-c_tiles // s)                    # every slice has tiles
    assert (s - 1) * per < c_tiles
    if (n, l) == (256, 10_000):
        assert s <= 33                        # today's slice merge width
    if n == 1:
        assert s == min(c_tiles, tl.blocks_per_sm * sms)


def test_topk_n_slices_at_the_served_shape():
    """N 256, L 10,000 on 132 SMs: 8 query tiles × 14 slices of three
    256-centroid tiles (112 blocks, one wave at 1 an SM); at 2 an SM,
    20 slices of two (160 blocks); the parent's tiles give 16 × 32
    slices of five 64-centroid tiles."""
    assert at_ops.n_slices(256, 10_000, 132, SLICE_TILES["kernel"]) == 14
    assert at_ops.n_slices(256, 10_000, 132, SLICE_TILES["two_an_sm"]) == 20
    assert at_ops.n_slices(256, 10_000, 132, SLICE_TILES["parent"]) == 32


def test_topk_scores_buffers_and_kernel_args_follow_argtypes():
    x, emb = torch.zeros(40, 12), torch.zeros(300, 12)
    tl = at_ops.Tiles(32, 256, 2)
    bufs = at_ops.buffers(x, 7, tl, 3)
    assert [tuple(b.shape) for b in bufs] == [(40, 7), (40, 7), (40, 3, 7),
                                              (40, 3, 7), (2,)]
    assert [b.dtype for b in bufs] == [torch.float32, torch.int32,
                                       torch.float32, torch.int32,
                                       torch.int32]
    assert not bufs[4].any()
    args = at_ops.kernel_args(x, emb, bufs, 7, 3, 9)
    assert len(args) == len(at_ops.ARGTYPES)
    assert args[:7] == [t.data_ptr() for t in (x, emb, *bufs)]
    assert args[7:] == [40, 300, 12, 7, 3, 9]
    for ctype, arg in zip(at_ops.ARGTYPES, args):
        ctype(arg)


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


def _schedule_case(name):
    """A tool edge shape's ids and live lanes (CPU)."""
    from repro_torch.benchmarks import kernel_variants as kv
    _, plane, ids, live = kv.sq8_case(name, "cpu")
    return ids, live, plane.shape[0]


@pytest.mark.parametrize("group_max", [1, 3, 8])
@pytest.mark.parametrize("name", ["c_below_tile", "c_ragged", "all_masked",
                                  "shared_lists", "same_key_differs",
                                  "dedup_across_lists", "served_ragged"])
def test_sq8_schedule_groups_equal_keys(name, group_max):
    """The kernel's work order: a permutation of all B·T items with their
    keys sorted (equal keys adjacent, query order kept among them); a
    group starts at each run of equal keys, every ``group_max`` positions
    after it and at every window of 32·``group_max``, so no group is
    longer than ``group_max``, crosses a window or holds two keys; items
    whose first lane is dead (PAD tails, all-dead tiles) have negative
    keys of their own, so each is a group alone, and a live first lane
    keys by its id."""
    ids, live, n_rows = _schedule_case(name)
    tile = 512
    skey, order = sq8_ops.schedule(ids, live, n_rows, tile)
    key = sq8_ops.tile_keys(ids, live, n_rows, tile).flatten()
    b, c = ids.shape
    n_items = b * -(-c // tile)
    assert skey.dtype == torch.int32 and order.dtype == torch.int64
    assert sorted(order.tolist()) == list(range(n_items))
    assert torch.equal(skey, key[order])
    assert bool((skey[1:] >= skey[:-1]).all())
    same = skey[1:] == skey[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())    # stable
    lead = sq8_ops.lead_flags(skey, group_max)
    assert bool(lead[0]) and bool(lead[1:][~same].all())
    starts = torch.nonzero(lead).flatten().tolist() + [n_items]
    for a, z in zip(starts, starts[1:]):
        assert 1 <= z - a <= group_max
        assert len(set(skey[a:z].tolist())) == 1
        assert a // (32 * group_max) == (z - 1) // (32 * group_max)
        if z < n_items and skey[z] == skey[a] and z % (32 * group_max):
            assert z - a == group_max        # runs are cut in full groups
    dead_head = ~live[:, ::tile].flatten()
    assert len(set(key[dead_head].tolist())) == int(dead_head.sum())
    assert bool((key[dead_head] < 0).all())
    heads = ids[:, ::tile].flatten()[~dead_head].long()
    assert torch.equal(key[~dead_head].long(), heads.clamp(0, n_rows - 1))


def test_sq8_schedule_shares_list_tiles():
    """Queries that hold the same inverted list share its tiles' keys:
    at ``shared_lists`` (20 queries over 4 lists of which each holds 3)
    more than 8 items hold one key, so groups of 8 split the run."""
    ids, live, n_rows = _schedule_case("shared_lists")
    key = sq8_ops.tile_keys(ids, live, n_rows, 512).flatten()
    assert int(torch.unique(key, return_counts=True)[1].max()) > 8
    skey, _ = sq8_ops.schedule(ids, live, n_rows, 512)
    assert int(sq8_ops.lead_flags(skey, 8).sum()) < key.numel() // 2


def test_sq8_schedule_keys_and_windows():
    """A live first slot keys by its clipped id (-3 and 0 read row 0, 99
    the last row), a dead one by -1 - the item's index, below every row;
    a run is cut into groups of ``group_max`` from its first position,
    and at windows of 32·``group_max``."""
    ids = torch.tensor([[-3, 5, 1, 1], [0, 2, 99, 4], [7, 7, 7, 7]],
                       dtype=torch.int32)
    live = torch.tensor([[True, True, True, True],
                         [True, True, True, False],
                         [False, True, True, True]])
    key = sq8_ops.tile_keys(ids, live, 10, 2)
    assert key.tolist() == [[0, 1], [0, 9], [-5, 7]]
    skey, order = sq8_ops.schedule(ids, live, 10, 2)
    assert order.tolist() == [4, 0, 2, 1, 5, 3]
    assert skey.tolist() == [-5, 0, 0, 1, 7, 9]
    assert sq8_ops.lead_flags(skey, 8).tolist() == [True, True, False, True,
                                                    True, True]
    assert sq8_ops.lead_flags(skey, 1).all()
    runs = torch.tensor([1, 2, 2, 2, 2, 2, 5, 5, 5, 5], dtype=torch.int32)
    assert sq8_ops.lead_flags(runs, 4).tolist() == [
        True, True, False, False, False, True, True, False, False, False]
    same = torch.full((70,), 3, dtype=torch.int32)    # windows of 64
    assert torch.nonzero(sq8_ops.lead_flags(same, 2)).flatten().tolist() == (
        list(range(0, 64, 2)) + [64, 66, 68])


@pytest.mark.parametrize("case, want", [
    ("h768", True),
    ("h16", True),
    ("h40", False),
    ("h8", False),
    ("offset_3_bytes", False),
    ("offset_16_bytes", True),
])
def test_sq8_vector_loads_eligibility(case, want):
    """16-byte row loads need h a multiple of 16 and a 16-byte aligned
    plane (every row then starts aligned); anything else takes the byte
    loads."""
    h = {"h16": 16, "h40": 40, "h8": 8}.get(case, 768)
    offset = {"offset_3_bytes": 3, "offset_16_bytes": 16}.get(case, 0)
    flat = torch.zeros(10 * h + 32, dtype=torch.uint8)
    assert flat.data_ptr() % 16 == 0
    plane = flat[offset:offset + 10 * h].view(10, h)
    assert sq8_ops.sq8_vector_loads(plane) is want


def test_sq8_kernel_args_follow_argtypes():
    """The wrapper's argument list matches the C entry's ctypes signature
    position by position: q, plane, ids, live, the sorted keys and item
    order, out, B, C, h, N, ``vec`` and the stream."""
    q = torch.zeros(3, 32)
    plane = torch.zeros(50, 32, dtype=torch.uint8)
    ids = torch.zeros(3, 700, dtype=torch.int32)
    live = torch.ones(3, 700, dtype=torch.bool)
    skey, order = sq8_ops.schedule(ids, live, 50, 512)
    out = torch.empty(3, 700)
    args = sq8_ops.kernel_args(q, plane, ids, live, skey, order, out, True,
                               11)
    assert len(args) == len(sq8_ops.ARGTYPES)
    assert args[:7] == [t.data_ptr() for t in (q, plane, ids, live, skey,
                                               order, out)]
    assert args[7:] == [3, 700, 32, 50, 1, 11]
    for ctype, arg in zip(sq8_ops.ARGTYPES, args):
        ctype(arg)


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


def _pq_view(n, m, dsub, offset=0):
    """PQ's (m, n, d_sub) view of an (n, m·d_sub) matrix starting
    ``offset`` elements into its storage."""
    flat = torch.zeros(n * m * dsub + offset)[offset:]
    return flat.view(n, m, dsub).transpose(0, 1)


@pytest.mark.parametrize("case, want", [
    ("kmeans_rows", True),
    ("pq_view_dsub8", True),
    ("pq_view_dsub4", True),
    ("pq_view_dsub12", True),
    ("pq_contiguous_fragments", True),
    ("h37", False),
    ("pq_view_dsub6", False),
    ("offset_one_element", False),
    ("row_stride_not_16_bytes", False),
    ("batch_stride_not_16_bytes", False),
    ("one_batch_odd_batch_stride", True),
])
def test_assign_vector_loads_eligibility(case, want):
    """The 16-byte cp.async copies need both bases 16-byte aligned, h
    and x's row stride a multiple of 4 floats, and so x's batch stride
    where there is more than one batch entry: the KMeans rows and PQ's
    strided views qualify, h 37, d_sub 6 and views off alignment take
    the 4-byte copies."""
    c = torch.zeros(1, 10, 768)
    if case == "kmeans_rows":
        x = torch.zeros(1, 513, 768)
    elif case.startswith("pq_view_dsub"):
        dsub = int(case.rsplit("dsub", 1)[1])
        x = _pq_view(50, 768 // dsub, dsub)
        c = torch.zeros(768 // dsub, 256, dsub)
    elif case == "pq_contiguous_fragments":
        x, c = torch.zeros(96, 50, 8), torch.zeros(96, 256, 8)
    elif case == "h37":
        x, c = torch.zeros(1, 9, 37), torch.zeros(1, 4, 37)
    elif case == "offset_one_element":
        x = _pq_view(50, 1, 768, offset=1)
        assert x.data_ptr() % 16
    elif case == "row_stride_not_16_bytes":    # 8 features of 18-wide rows
        x = torch.zeros(50, 18)[:, :8][None]
        c = torch.zeros(1, 4, 8)
    elif case == "batch_stride_not_16_bytes":
        x = torch.zeros(200).as_strided((2, 9, 8), (6, 20, 1))
        c = torch.zeros(2, 4, 8)
    else:
        x = torch.zeros(200).as_strided((1, 9, 8), (6, 20, 1))
        c = torch.zeros(1, 4, 8)
    assert at_ops.assign_vector_loads(x, c) is want


def test_assign_argmax_buffers_and_kernel_args_follow_argtypes():
    """The wrapper's argument list matches the C entry's ctypes signature
    position by position: x, c, the outputs and the ½‖c‖² scratch, x's
    batch and row strides, the sizes, ``vec`` and the stream."""
    x, c = _pq_view(50, 96, 8), torch.zeros(96, 256, 8)
    bufs = at_ops.assign_buffers(x, c)
    assert [(tuple(b.shape), b.dtype) for b in bufs] == [
        ((96, 50), torch.float32), ((96, 50), torch.int32),
        ((96, 256), torch.float32)]
    args = at_ops.assign_kernel_args(x, c, bufs, True, 7)
    assert len(args) == len(at_ops.ASSIGN_ARGTYPES)
    assert args[:5] == [t.data_ptr() for t in (x, c, *bufs)]
    assert args[5:] == [8, 768, 96, 50, 256, 8, 1, 7]
    for ctype, arg in zip(at_ops.ASSIGN_ARGTYPES, args):
        ctype(arg)


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


def _tc_emulation(q, k, v, causal, window, scale=None, tile=64):
    """The bf16 tensor-core kernel's arithmetic, written out blockwise in
    f32 on the CPU: 64-key tiles, the online softmax in f32 with scores
    in log2 units (the scale applied after the product), P rounded to
    bf16 before P·V, l summed from the f32 p, out rounded to bf16.
    q, k, v hold bf16 values (any float dtype)."""
    b, hq, sq, d = q.shape
    group, sk = hq // k.shape[1], k.shape[2]
    scale = 1.0 / np.sqrt(d) if scale is None else scale
    sc = torch.tensor(scale * np.log2(np.e), dtype=torch.float32)
    qf = q.float()
    kg = k.float().repeat_interleave(group, dim=1)
    vg = v.float().repeat_interleave(group, dim=1)
    m = torch.full((b, hq, sq), -torch.inf)
    l = torch.zeros((b, hq, sq))
    o = torch.zeros((b, hq, sq, d))
    qp = torch.arange(sq)[:, None]
    for k0 in range(0, sk, tile):
        s = qf @ kg[:, :, k0:k0 + tile].transpose(-1, -2)
        kp = torch.arange(k0, min(k0 + tile, sk))[None, :]
        ok = torch.ones((sq, kp.shape[1]), dtype=torch.bool)
        if causal:
            ok &= qp >= kp
        if window > 0:
            ok &= qp - kp < window
            if not causal:
                ok &= kp - qp < window
        s = torch.where(ok, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1) * sc)
        base = torch.where(m_new == -torch.inf, 0.0, m_new)
        alpha = torch.exp2(m - base)
        p = torch.exp2(s * sc - base[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + (p.to(torch.bfloat16).float()
                                    @ vg[:, :, k0:k0 + tile])
        m = m_new
    live = l > 0
    out = torch.where(live[..., None], o / torch.where(live, l, 1.0)[
        ..., None], 0.0).to(torch.bfloat16)
    lse = torch.where(live, m * float(np.log(2.0)) + torch.log(
        torch.where(live, l, 1.0)), fa_ref.NEG_INF)
    return out, lse


@pytest.mark.parametrize("case", [
    # name: (b, hq, hkv, sq, sk, d, causal, window)
    ("gqa4_d128", (1, 8, 2, 200, 200, 128, True, 0)),
    ("d80", (2, 4, 4, 150, 150, 80, True, 0)),
    ("causal_ragged_sq70_sk300", (2, 4, 2, 70, 300, 64, True, 0)),
    ("window32_dead_rows", (1, 4, 2, 300, 70, 32, False, 32)),
], ids=lambda c: c[0])
def test_flash_tensor_core_rounding_fits_the_contract(case):
    """The bf16 tensor-core kernel's design, emulated blockwise on the
    CPU (:func:`_tc_emulation`), agrees with the Pallas kernel (interpret
    mode, one block per sequence so no padding enters) and with the
    port's plain version within the kernel's own tolerances (out 2e-2,
    lse 1e-4), rows with no visible key zeros with lse -1e30: the bf16
    P and the scale after the product stay inside the contract."""
    _, (b, hq, hkv, sq, sk, d, causal, window) = case
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(sq * 7 + d, b, hq, hkv, sq, sk, d))
    out, lse = _tc_emulation(q, k, v, causal, window)
    jout, jlse = jfa_kernel.flash_attention(
        *(jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
          for t in (q, k, v)),
        causal=causal, window=window, blk_q=sq, blk_k=sk, interpret=True)
    pout, plse = fa_ref.flash_attention(q, k, v, causal, window)
    for want, wlse in ((np.asarray(jout, dtype=np.float32),
                        np.asarray(jlse)),
                       (pout.float().numpy(), plse.numpy())):
        np.testing.assert_allclose(out.float().numpy(), want, rtol=2e-2,
                                   atol=2e-2)
        np.testing.assert_allclose(lse.numpy(), wlse, rtol=1e-4, atol=1e-4)
    dead = (plse == fa_ref.NEG_INF).numpy()
    assert dead.any() == (case[0] == "window32_dead_rows")
    assert (lse.numpy()[dead] == fa_ref.NEG_INF).all()
    assert (out.float().numpy()[dead] == 0).all()


def _offset_view(shape, dtype, offset):
    """A contiguous (B, H, S, d) tensor starting ``offset`` elements into
    its storage."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


@pytest.mark.parametrize("case, want", [
    ("contiguous_bhsd", True),
    ("bshd_transposed_view", True),
    ("offset_one_element", False),
    ("bf16_d16", True),
    ("bf16_offset_one_element", False),
    ("row_stride_not_16_bytes", False),
])
def test_flash_attention_vector_loads_eligibility(case, want):
    """The 16-byte cp.async instance needs every base 16-byte aligned and
    every (b, h, s) stride a multiple of 16 bytes; the attention layer's
    (B, S, H, d) projections viewed as (B, H, S, d) qualify, a view one
    element off does not (it takes the element-wise instance)."""
    if case == "contiguous_bhsd":
        ts = [torch.zeros(2, 12, 64, 64) for _ in range(3)]
    elif case == "bshd_transposed_view":
        ts = [torch.zeros(2, 64, 12, 64).transpose(1, 2) for _ in range(3)]
    elif case == "offset_one_element":
        ts = [torch.zeros(2, 12, 64, 64),
              _offset_view((2, 12, 64, 64), torch.float32, 1),
              torch.zeros(2, 12, 64, 64)]
    elif case == "bf16_d16":
        ts = [torch.zeros(2, 3, 5, 16, dtype=torch.bfloat16)
              for _ in range(3)]
    elif case == "bf16_offset_one_element":
        ts = [_offset_view((2, 3, 5, 16), torch.bfloat16, 1)]
    else:   # features sliced out of wider rows: row stride 65 floats
        ts = [torch.zeros(2, 4, 8, 65)[..., :64]]
    assert fa_ops.vector_loads(*ts) is want
    # the offset views differ from an aligned one only in the base address
    if case.endswith("offset_one_element"):
        assert any(t.data_ptr() % 16 for t in ts)


def test_flash_attention_vector_loads_refuses_strided_features():
    q = torch.zeros(1, 2, 8, 32)[..., ::2]
    assert q.stride(3) == 2
    with pytest.raises(ValueError, match="unit-stride features"):
        fa_ops.vector_loads(q, torch.zeros(1, 2, 8, 16))


def test_flash_attention_kernel_args_follow_argtypes():
    """The wrapper's argument list matches the C entry's ctypes signature
    position by position: strides of q, k, v and the (B, S, H, d) output
    view, then the sizes, flags, scale, ``vec`` and the stream."""
    q = torch.zeros(2, 64, 12, 64).transpose(1, 2)
    k = v = torch.zeros(2, 40, 4, 64).transpose(1, 2)
    out, lse = fa_ops.outputs(q)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.stride() == (64 * 12 * 64, 64, 12 * 64, 1)
    assert lse.shape == (2, 12, 64) and lse.dtype == torch.float32
    args = fa_ops.kernel_args(q, k, v, out, lse, True, 5, 0.125, True, 7)
    assert len(args) == len(fa_ops.ARGTYPES)
    assert args[:5] == [t.data_ptr() for t in (q, k, v, out, lse)]
    assert args[5:17] == [s for t in (q, k, v, out) for s in t.stride()[:3]]
    assert args[17:] == [2, 12, 4, 64, 40, 64, 0, 1, 5, 0.125, 1, 7]
    for ctype, arg in zip(fa_ops.ARGTYPES, args):
        ctype(arg)


def test_flash_variants_arguments_and_parent_entry(tmp_path):
    """The parent-against-change tool reads from a ``flash_attention``
    parent's source whether its C entry takes ``vec``."""
    from repro_torch.benchmarks import kernel_variants as kv
    args = kv.parse_args(["--kernel", "flash_attention", "--parent",
                          "build/flash_parent.cu"])
    assert args.parent == pathlib.Path("build/flash_parent.cu")
    assert kv.takes_vec(_build.SOURCES["flash_attention"].read_text())
    assert not kv.takes_vec(
        "int flash_attention_fwd(const void* q, int d, int dtype,\n"
        "                        float scale, void* stream) {")
    with pytest.raises(ValueError, match="no flash_attention_fwd"):
        kv.takes_vec("int main() { return 0; }")


def test_flash_variants_hold_f32_bitwise_and_bf16_within_tolerance(
        monkeypatch):
    """``--kernel flash_attention`` holds the f32 instances (d 16, 32, 64,
    128; the FMA kernel, unchanged) to the parent bit for bit, in both
    load instances where the input allows, and every bf16 instance (d
    16, 32, 64, 80, 128; the tensor-core kernel, whose products sum in
    another order and whose P is bf16) of each build but the parent to
    the plain version within 2e-2 / 1e-4, a non-causal window with dead
    rows among them.  The launch is stood in for by the plain version
    on the CPU, so which builds, dtypes, head dims and load instances
    are checked is what the test sees."""
    from repro_torch.benchmarks import kernel_variants as kv
    calls = []

    def fake_call(lib, with_vec, q, k, v, causal, vec=True, window=0):
        calls.append((lib, q.dtype, q.shape[-1], vec, window))
        out, lse = fa_ref.flash_attention(q, k, v, causal, window)
        return (out + 1, lse) if lib == "bad" else (out, lse)

    monkeypatch.setattr(kv, "call_flash", fake_call)
    libs = {"parent": "parent", "new": "new", "variant0": "variant0"}
    with_vec = dict.fromkeys(libs, True)
    gen = torch.Generator().manual_seed(0)
    assert kv.flash_bitwise(libs, with_vec, gen) == []
    assert {c[:2] for c in calls} == {("new", torch.float32),
                                      ("parent", torch.float32)}
    assert sorted({c[2] for c in calls}) == [16, 32, 64, 128]
    # offset 0: both load instances; offset 1: the element-wise one
    assert sum(c[3] for c in calls) == 2 * 4 and len(calls) == 2 * 4 * 3
    calls.clear()
    assert kv.flash_tolerance(libs, gen) == []
    assert {c[:2] for c in calls} == {("new", torch.bfloat16),
                                      ("variant0", torch.bfloat16)}
    assert sorted({c[2] for c in calls}) == [16, 32, 64, 80, 128]
    assert {c[4] for c in calls} == {0, 32}       # 32: the dead-row case
    assert len(calls) == 2 * 5 * 2 * 3
    failed = kv.flash_tolerance({"parent": "parent", "new": "bad"}, gen)
    assert len(failed) == 5 * 2 * 3 and all("new" in f for f in failed)
    assert kv.flash_agrees(fa_ref.flash_attention(
        *(torch.ones(1, 2, 3, 16) for _ in range(3)), True, 0),
        *(torch.ones(1, 2, 3, 16) for _ in range(3)), True, 0) == (
        True, 0.0)


def test_flash_variants_shapes_bound_and_constants():
    """The LM shapes ``--kernel flash_attention`` checks and times (the
    three train_4k shapes, stablelm-3b at d 80, llama3-8b, Mixtral's
    window), their bound at the bf16 tensor-core peak, the SASS opcodes
    that show the tensor-core products, and ``--variant`` / ``--sass``
    on this checkout's source (its tile constants, each found once)."""
    from repro_torch.benchmarks import kernel_variants as kv
    assert kv.FLASH_LM_SHAPES == {
        "llama3_8b": (1, 4096, 32, 8, 128, 0),
        "internlm2_1_8b_train_4k": (10, 4096, 16, 8, 128, 0),
        "olmoe_1b_7b_train_4k": (10, 4096, 16, 16, 128, 0),
        "stablelm_3b_train_4k": (12, 4096, 32, 32, 80, 0),
        "mixtral_8x22b_window": (1, 8192, 48, 8, 128, 4096)}
    assert kv.PEAK_BF16_FLOPS == 989e12
    assert {"HMMA", "LDSM"} <= set(kv.SASS_OPS)
    flops, nbytes = fa_ops.work(10, 16, 8, 4096, 4096, 128, True, 0, 2)
    assert 1e3 * max(flops / kv.PEAK_BF16_FLOPS,
                     nbytes / kv.PEAK_BYTES) == pytest.approx(0.69500762)
    args = kv.parse_args(["--kernel", "flash_attention", "--parent", "p.cu",
                          "--variant", "kQRows=64,kWarps=4", "--sass", "s"])
    assert (args.variant, args.sass) == ([{"kQRows": "64", "kWarps": "4"}],
                                         pathlib.Path("s"))
    src = _build.SOURCES["flash_attention"].read_text()
    var = kv.variant_source(src, {"kQRows": "64", "kWarps": "4",
                                  "kKeys": "32", "kStages": "3"})
    for line in ("constexpr int kQRows = 64;", "constexpr int kWarps = 4;",
                 "constexpr int kKeys = 32;", "constexpr int kStages = 3;"):
        assert line in var
    assert "constexpr int kBQ = 64;" in var      # the f32 kernel's, as is
    with pytest.raises(ValueError, match="constant 'kRows'"):
        kv.variant_source(src, {"kRows": "64"})


@pytest.mark.parametrize("kernel", ["assign_argmax", "flash_attention",
                                    "pq_adc_fused", "sq8_dot_fused",
                                    "topk_scores"])
def test_kernel_variants_arguments_and_card(kernel, tmp_path):
    """The tool parses its arguments for either kernel, refuses another
    kernel, a missing parent or a malformed variant, and needs a card."""
    from repro_torch.benchmarks import kernel_variants as kv
    args = kv.parse_args(["--kernel", kernel, "--parent", "p.cu"])
    assert (args.kernel, args.reps, args.variant, args.gemm_only) == (
        kernel, 20, [], False)
    args = kv.parse_args(["--kernel", kernel, "--parent", "p.cu", "--reps",
                          "3", "--variant", "kHC=16,kMinBlocks=2",
                          "--variant", "kQWarps=1", "--gemm-only"])
    assert (args.reps, args.variant, args.gemm_only) == (
        3, [{"kHC": "16", "kMinBlocks": "2"}, {"kQWarps": "1"}], True)
    for bad in ([], ["--kernel", kernel], ["--parent", "p.cu"],
                ["--kernel", "pq_adc", "--parent", "p.cu"],
                ["--kernel", kernel, "--parent", "p.cu", "--variant",
                 "kHC"],
                ["--kernel", kernel, "--parent", "p.cu", "--variant",
                 "kHC=16,=2"]):
        with pytest.raises(SystemExit):
            kv.parse_args(bad)
    if not torch.cuda.is_available():
        parent = tmp_path / "parent.cu"
        parent.write_text(_build.SOURCES[kernel].read_text())
        with pytest.raises(SystemExit, match="needs an NVIDIA card"):
            kv.main(["--kernel", kernel, "--parent", str(parent)])


def test_kernel_variants_topk_parent_tiles_and_cuts():
    """A parent library without ``topk_scores_tiles`` is taken to have
    the (16, 64) tiles it was built with and is sliced as its wrapper
    sliced it (33 slices at the served shape on 132 SMs); a variant sets
    its tile constants and ``--gemm-only`` cuts the per-tile selection,
    each in a copy of the source, or refuses where its part is not there
    exactly once: between the selection marks where the source has
    them, else (a parent from before the marks) the merge call.  The
    sources here are stand-ins, so the kernel's own text is free to
    change; the checkout's own source must carry one pair of marks."""
    from repro_torch.benchmarks import kernel_variants as kv
    assert kv.topk_tiles(object()) == at_ops.Tiles(16, 64, 4)
    assert kv.topk_slices(object(), kv.PARENT_TILES, 256, 10_000, 132) == 33
    assert kv.topk_slices(object(), kv.PARENT_TILES, 1, 100, 132) == 2
    src = ("constexpr int kHC = 32;          // features per chunk\n"
           "constexpr int kMinBlocks = 1;\n"
           "constexpr int kRow = kHC + 4;\n"
           "      const float* row = sm.tile[q];\n"
           "      warp_merge(sm.ls[q], sm.li[q], cnt[u], n, k, lane,\n"
           "                 [&](int c, float& s, int& i) { s = row[c]; "
           "i = c0 + c; });\n"
           "    warp_merge(sm.ls[q], sm.li[q], c, n_slices * k, k, lane,\n")
    var = kv.variant_source(src, {"kHC": "16", "kMinBlocks": "2"})
    assert "constexpr int kHC = 16;          // features per chunk" in var
    assert "constexpr int kMinBlocks = 2;" in var
    assert "constexpr int kRow = kHC + 4;" in var
    gemm = kv.variant_source(src, gemm_only=True)
    assert gemm.count("warp_merge(") == 1          # the slice merge stays
    assert "n_slices * k, k, lane" in gemm
    assert kv.MERGE_STAND_IN in gemm
    with pytest.raises(ValueError, match="constant 'kTQ'"):
        kv.variant_source(src, {"kTQ": "8"})
    with pytest.raises(ValueError, match="per-tile merge: found 0"):
        kv.variant_source(gemm, gemm_only=True)
    begin, end = kv.SELECTION_MARKS
    marked = ("constexpr int kHC = 32;          // features per chunk\n"
              "    float acc[kTQ][kTC] = {};\n"
              f"    {begin}\n"
              "    offer(sm, acc, pend);\n"
              "    warp_merge(sm.ls[q], sm.li[q], cnt[u], n, k, lane,\n"
              "               [&](int c, float& s, int& i) { s = 0; });\n"
              f"    {end}\n"
              "    merge_slices(part_s, part_i);\n")
    gemm = kv.variant_source(marked, gemm_only=True)
    assert kv.SELECTION_STAND_IN in gemm and "warp_merge(" not in gemm
    assert "offer(" not in gemm and begin not in gemm and end not in gemm
    assert gemm.startswith("constexpr int kHC = 32;")
    assert gemm.endswith("merge_slices(part_s, part_i);\n")
    for bad in (marked.replace(end, ""), marked + begin + "\n",
                marked.replace(begin, "@").replace(end, begin)
                .replace("@", end)):
        with pytest.raises(ValueError, match="selection marks"):
            kv.variant_source(bad, gemm_only=True)
    own = _build.SOURCES["topk_scores"].read_text()
    assert kv.SELECTION_STAND_IN in kv.variant_source(own, gemm_only=True)


def test_kernel_variants_assign_entry_and_constants():
    """A parent ``assign_argmax.cu`` whose C entry takes no ½‖c‖² scratch
    (before it had one) is told apart from this checkout's, and a variant
    sets the wide and narrow instances' constants in a copy of the
    source, or refuses a constant it does not find exactly once.  The
    source here is a stand-in, so the kernel's own text is free to
    change."""
    from repro_torch.benchmarks import kernel_variants as kv
    assert kv.takes_scratch(_build.SOURCES["assign_argmax"].read_text())
    assert not kv.takes_scratch(
        "int assign_argmax_launch(const void* x, const void* c, void* out_s,"
        "\n                         void* out_i, long long x_batch,\n"
        "                         int h, void* stream) {")
    with pytest.raises(ValueError, match="no assign_argmax_launch"):
        kv.takes_scratch("int main() { return 0; }")
    src = ("constexpr int kHC = 32;          // features per chunk\n"
           "constexpr int kStages = 2;\n"
           "constexpr int kMinBlocks = 1;\n"
           "constexpr int kNarrowMax = 16;\n"
           "constexpr int kRow = kHC + 4;\n")
    var = kv.variant_source(src, {"kHC": "64", "kStages": "3",
                                  "kNarrowMax": "0"})
    assert "constexpr int kHC = 64;          // features per chunk" in var
    assert "constexpr int kStages = 3;" in var
    assert "constexpr int kMinBlocks = 1;" in var
    assert "constexpr int kNarrowMax = 0;" in var
    assert "constexpr int kRow = kHC + 4;" in var
    with pytest.raises(ValueError, match="constant 'kTP'"):
        kv.variant_source(src, {"kTP": "4"})
    assert set(kv.ASSIGN_SHAPES) >= {"kmeans", "pq", "h37_elementwise",
                                     "misaligned_view", "pq_dsub4",
                                     "pq_dsub12"}


def test_kernel_variants_sq8_entry_shapes_and_constants():
    """The tool tells a grouped ``sq8_dot_fused.cu`` (C entry
    ``sq8_dot_fused_launch``) from the per-lane one before it, parses
    ``--seed`` and ``--sass``, sets the schedule's constants in a copy of
    the source, and builds its edge shapes as the on-card test does."""
    from repro_torch.benchmarks import kernel_variants as kv
    args = kv.parse_args(["--kernel", "sq8_dot_fused", "--parent", "p.cu",
                          "--seed", "3", "--sass", "out",
                          "--variant", "kGroupMax=16,kRowVecs=2"])
    assert (args.kernel, args.seed, args.sass, args.variant) == (
        "sq8_dot_fused", 3, pathlib.Path("out"),
        [{"kGroupMax": "16", "kRowVecs": "2"}])
    assert kv.parse_args(["--kernel", "sq8_dot_fused", "--parent",
                          "p.cu"]).sass is None
    source = _build.SOURCES["sq8_dot_fused"].read_text()
    assert kv.grouped_entry(source)
    assert not kv.grouped_entry(
        "int sq8_dot_fused(const void* q_scaled, const void* plane,\n"
        "                  long long n_rows, void* stream) {")
    with pytest.raises(ValueError, match="no sq8_dot_fused"):
        kv.grouped_entry("int main() { return 0; }")
    var = kv.variant_source(source, {"kGroupMax": "16", "kTileSlots": "256",
                                     "kChunk": "64", "kStages": "3",
                                     "kMinBlocks": "2", "kThreads": "64"})
    for line in ("constexpr int kGroupMax = 16;",
                 "constexpr int kTileSlots = 256;",
                 "constexpr int kChunk = 64;",
                 "constexpr int kStages = 3;",
                 "constexpr int kMinBlocks = 2;",
                 "constexpr int kThreads = 64;",
                 "constexpr int kSums = 16;"):
        assert line in var
    assert set(kv.SQ8_SHAPES) >= {"h40_scalar", "unaligned_view",
                                  "shared_lists", "same_key_differs",
                                  "dedup_across_lists", "served_ragged"}
    with pytest.raises(ValueError, match="unknown id layout"):
        kv.sq8_layout(np.random.default_rng(0), 2, 10, 5, "zipf")


@pytest.mark.parametrize("kernel", ["flash_attention", "pq_adc_fused"])
def test_variants_tools_hand_build_source_paths(kernel, tmp_path,
                                                monkeypatch):
    """``flash_main`` and ``adc_main`` hand ``build`` a path to an
    existing source file for each build (``flash_main`` once handed it
    (path, ()) tuples, which nvcc took for a file name)."""
    from repro_torch.benchmarks import kernel_variants as kv
    seen = {}

    class Stop(Exception):
        pass

    def record(sources):
        seen.update(sources)
        raise Stop

    monkeypatch.setattr(kv, "build", record)
    parent = tmp_path / "parent.cu"
    parent.write_text(_build.SOURCES[kernel].read_text())
    args = kv.parse_args(["--kernel", kernel, "--parent", str(parent)])
    main = {"flash_attention": kv.flash_main,
            "pq_adc_fused": kv.adc_main}[kernel]
    with pytest.raises(Stop):
        main(args)
    assert set(seen) == {"parent", "new"}
    for src in seen.values():
        assert isinstance(src, pathlib.Path) and src.is_file()
    assert seen["new"] == _build.SOURCES[kernel]


def test_kernel_variants_adc_entry_shapes_and_constants():
    """The tool tells a persistent ``pq_adc_fused.cu`` (C entry
    ``pq_adc_fused_launch``) from the per-dtype entries before it, sets
    the kernel's constants in a copy of the source, and builds its edge
    shapes: the old on-card cases, a served-like plane with shared
    lists, B above one wave, an all-dead query, m = 1, int32 at k = 300,
    misaligned planes and a LUT that leaves no room for the ring."""
    from repro_torch.benchmarks import kernel_variants as kv
    args = kv.parse_args(["--kernel", "pq_adc_fused", "--parent", "p.cu",
                          "--seed", "3", "--sass", "out",
                          "--variant", "kStages=3,kMinSlots=4096"])
    assert (args.kernel, args.seed, args.sass, args.variant) == (
        "pq_adc_fused", 3, pathlib.Path("out"),
        [{"kStages": "3", "kMinSlots": "4096"}])
    source = _build.SOURCES["pq_adc_fused"].read_text()
    assert kv.persistent_entry(source)
    assert not kv.persistent_entry(
        "int pq_adc_fused_u8(const void* lut, const void* plane,\n"
        "                    long long n_rows, void* stream) {")
    with pytest.raises(ValueError, match="no pq_adc_fused"):
        kv.persistent_entry("int main() { return 0; }")
    var = kv.variant_source(source, {"kStages": "3", "kMinSlots": "4096",
                                     "kThreads": "256", "kMinBlocks": "2"})
    for line in ("constexpr int kStages = 3;",
                 "constexpr int kMinSlots = 4096;",
                 "constexpr int kThreads = 256;",
                 "constexpr int kMinBlocks = 2;",
                 "constexpr int kWarps = kThreads / 32;"):
        assert line in var
    for pattern, _ in kv.ADC_CUTS.values():     # --cut finds its parts
        assert len(pattern.findall(source)) == 1
    assert kv.parse_args(["--kernel", "pq_adc_fused", "--parent", "p.cu",
                          "--cut"]).cut
    assert set(kv.ADC_SHAPES) >= {"c_ragged", "c_below_tile",
                                  "int32_dup_masked", "scalar_rows",
                                  "served_lists", "one_slot_dead", "m_one",
                                  "int32_k300", "b_above_wave",
                                  "misaligned_u8", "lut_fills_smem"}
    assert kv.ADC_SHAPES["b_above_wave"][0] > 132
    lut, plane, ids, live = kv.adc_case("misaligned_u8", "cpu")
    assert not adc_ops.rows_vectorizable(plane)
    assert plane.shape == (kv.ADC_ROWS, 96) and lut.shape == (3, 96, 256)
    lut, plane, ids, live = kv.adc_case("one_slot_dead", "cpu")
    assert ids.shape == (1, 1) and not live.any()
    lut, plane, ids, live = kv.adc_case("served_lists", "cpu")
    assert adc_ops.rows_vectorizable(plane) and live.any()
    assert int(ids.max()) < kv.ADC_ROWS and int(ids.min()) >= 0
    b, m, k, n, c = kv.ADC_BENCH
    lut, plane, ids, live = kv.adc_bench_shape("cpu")
    assert (lut.shape, plane.shape, ids.shape) == ((b, m, k), (n, m), (b, c))


def test_sq8_layouts_shape_the_served_plane():
    """``lists`` gives each query whole inverted lists, PAD tails clipped
    to row 0 and dead; ``same_key_differs`` one live first row for every
    tile and other rows after it."""
    from repro_torch.benchmarks import kernel_variants as kv
    rng = np.random.default_rng(0)
    ids, live = kv.sq8_layout(rng, 6, 2 * 1024 + 300, 700, "lists")
    assert ids.shape == live.shape == (6, 2348) and ids.dtype == np.int32
    assert ids.min() >= 0 and ids.max() < 700
    assert (ids[~live] >= 0).all() and not live.all()
    ids, live = kv.sq8_layout(rng, 4, 1064, 700, "same_key_differs")
    assert (ids[:, ::512] == 7).all() and live[:, ::512].all()
    assert len(np.unique(ids[:, 1:512])) > 100


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
    before = (adc_ops.launches, adc_ops.unfused_launches, at_ops.launches,
              sq8_ops.launches, at_ops.assign_launches, fa_ops.launches)
    lut, plane, ids, live = _adc_case(0, 2, 40, 4, 64, 50, np.uint8, None,
                                      False)
    adc_ops.pq_adc_fused(torch.from_numpy(lut), torch.from_numpy(plane),
                         torch.from_numpy(ids),
                         torch.from_numpy(live.astype(bool)))
    adc_ops.pq_adc(torch.from_numpy(lut), torch.from_numpy(plane)[
        torch.from_numpy(ids).long()])
    at_ops.topk_scores(torch.randn(4, 8), torch.randn(20, 8), 3)
    q, plane, ids, live = _sq8_case(0, 2, 40, 16, 50, None)
    sq8_ops.sq8_dot_fused(torch.from_numpy(q), torch.from_numpy(plane),
                          torch.from_numpy(ids),
                          torch.from_numpy(live.astype(bool)))
    at_ops.assign_argmax(torch.randn(2, 9, 8), torch.randn(2, 4, 8))
    fa_ops.flash_attention(torch.randn(1, 2, 5, 16), torch.randn(1, 1, 7, 16),
                           torch.randn(1, 1, 7, 16))
    assert (adc_ops.launches, adc_ops.unfused_launches, at_ops.launches,
            sq8_ops.launches, at_ops.assign_launches,
            fa_ops.launches) == before


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


@pytest.mark.parametrize("bad", ["lut_f64", "codes_i64", "codes_f32",
                                 "codes_m", "codes_b", "codes_2d",
                                 "device_mix"])
def test_pq_adc_rejects_what_the_kernel_does_not_take(bad):
    lut = torch.zeros(2, 4, 16)
    codes = torch.zeros(2, 5, 4, dtype=torch.uint8)
    if bad == "lut_f64":
        lut = lut.double()
    elif bad == "codes_i64":
        codes = codes.long()
    elif bad == "codes_f32":
        codes = codes.float()
    elif bad == "codes_m":
        codes = torch.zeros(2, 5, 3, dtype=torch.uint8)
    elif bad == "codes_b":
        codes = torch.zeros(3, 5, 4, dtype=torch.uint8)
    elif bad == "codes_2d":
        codes = torch.zeros(10, 4, dtype=torch.uint8)
    else:
        codes = codes.to("meta")
    with pytest.raises(ValueError):
        adc_ops.pq_adc(lut, codes)


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

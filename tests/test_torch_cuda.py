"""On-card tests of the port: each CUDA kernel against its plain PyTorch
version, and search on the card against search on the CPU over the same
index.  They skip without a card; on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports only the port (the card's machine has no JAX).  Tolerances:
ADC scores rtol=atol=1e-4 with identical ``-inf`` lanes, and the
unfused ``pq_adc`` bitwise equal to ``pq_adc_fused`` on live lanes;
fused search bitwise against the CPU's sparse path and fusion; top-k ids
identical except swaps between plain scores within 1e-5, scores within
rtol=atol=1e-5 (the kernel and cuBLAS sum the h products in different
orders); SQ8 dots rtol 1e-4, atol 1e-2 (the JAX kernel test's own) with
identical ``-inf`` lanes; assignment ids identical except where the
plain scores of the two ids lie within 1e-5, and identical on
constructed ties (duplicate centroids), scores rtol=atol=1e-5; attention
outputs and ``lse`` rtol=atol=1e-4 in f32 (exp and the sum order) and
2e-2 in bf16 (one bf16 rounding of the output).  Two builds on the card
with one seed are equal leaf for leaf, as are ``compact()`` and a
rebuild; mutable search on the card is held to the CPU as search is.
The serving runtime captures one CUDA graph per bucket, and each bucket's
replayed rows equal ``Server.query``'s bit for bit for every codec, dense
and fused; mutations between batches capture nothing, ``compact()`` and
``set_fusion_weight`` capture every bucket again.  Over a two-rung tuned
ladder (DESIGN.md §14) it captures one graph per (bucket, rung) in one
pool, each row equals the direct search at its resolved rung's widths,
and no row replays across rungs; a tuned index saved from the card loads
back onto it leaf for leaf, and serves the same rows.  Sharded search on
two and four mesh positions of the card equals the single-device search
bit for bit for every codec, dense and fused, and a (2, 2) MeshServer
equals Server and survives the shard-loss drill.  Behind the runtime,
S = 4 and (2, 2) on the card capture one CUDA graph per bucket per mesh
(across the positions' streams), whose rows equal ``query``'s bit for
bit, with every replica dispatched and every row of a degraded mesh
``partial``; the sharded mutable server equals the single-device
mutable search and its graphs follow add/delete without a capture.  On
a host with several cards, one position a card (groups that span cards)
gives the same bits, and the runtime runs such a mesh eagerly; those
tests skip on a host with one.  The training mesh's collectives on four
positions of the card (flat and hierarchical all-reduce, tiled
psum_scatter / all_gather, pmean_metrics) give the CPU's bits on every
position, captured in a CUDA graph too; the sharded KMeans agrees on
every position; int8 compression and a three-way pmean equal the CPU's
bit for bit.  Attention at head dims outside {16, 32, 64, 128} (SASRec's
50, and 40) runs ragged in the next instance up, within the same
tolerances; SASRec's users on the card (two flash launches) are the
CPU's within 1e-4 and its retrieval's constructed ties go to the lower
id, as on the CPU.  One training-cell step (value and grad, clip 1.0,
AdamW) of each recsys arch and of GatedGCN on a full graph, a molecule
batch and a sampled minibatch is the CPU's within 1e-4, and the
partitioned GatedGCN over 2 and 4 positions of the card gives
``loss_fn``'s loss within 1e-5 and its gradients within 1e-4, under a
timeout (a hang fails the test).  The dense LMs' attention (GQA 4:1 and
2:1 at d 128, 1:1 at d 80, bf16 causal) is held as the other flash
cases; ``decode_step`` and ``serve_step`` (after ``prefill_step``, past
a window) on the card are the CPU's within 1e-4 with equal
``cache_pos``; one cell step of internlm2-1.8b at full width and 2
layers is the CPU's as the smoke holds a step (loss, grad norm and
leaves within 1e-4, moments within 1% in norm, each update against
AdamW's formula).  The MoE layer at OLMoE's width (d 2,048, 64 experts
top-8) routes every token as the CPU does (expert, position, kept; a
differing route fails unless its router logits tie within 1e-5) with
outputs and gradients within 1e-4; two forward and backward runs on the
card are equal bit for bit, so a remat step's recompute routes as its
forward and its gradients equal a step without remat bit for bit; an MoE
``serve_step`` after ``prefill_step`` is the CPU's within 1e-4.
"""
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import hybrid_index as hi
from repro_torch.core import inverted_lists as il
from repro_torch.kernels import _build
from repro_torch.kernels.assign_topk import ops as at_ops
from repro_torch.kernels.assign_topk import ref as at_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.pq_adc import ops as adc_ops
from repro_torch.kernels.pq_adc import ref as adc_ref
from repro_torch.kernels.sq8_dot import ops as sq8_ops
from repro_torch.kernels.sq8_dot import ref as sq8_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", torch.cuda.current_device())


class AdcCase(NamedTuple):
    b: int
    c: int
    m: int
    k: int
    dtype: type
    dup: bool                   # every id at least twice a row
    mask_row: object            # a fully masked row, "all", or None
    instance: str               # the instance the wrapper must choose
    offset: int = 0             # bytes the plane lies past 16-byte alignment
    layout: str = "random"      # ids: random, or kernel_variants' "lists"
    rows: int = 700             # plane rows


ADC_CASES = {
    "c_ragged": AdcCase(2, 8192 + 77, 96, 256, np.uint8, False, None,
                        "served"),
    "c_below_tile": AdcCase(3, 5, 8, 128, np.uint8, False, 1, "scalar"),
    "int32_dup_masked": AdcCase(2, 600, 8, 512, np.int32, True, 0, "vector"),
    "scalar_rows": AdcCase(2, 333, 3, 64, np.uint8, True, 1, "scalar"),
    # inverted lists shared across queries, as the served plane holds them
    "served_lists": AdcCase(24, 3 * 1024 + 100, 96, 256, np.uint8, False,
                            None, "served", layout="lists"),
    "b_above_wave": AdcCase(600, 200, 96, 256, np.uint8, False, 7, "served",
                            layout="lists"),
    "all_dead_query": AdcCase(1, 1, 96, 256, np.uint8, False, "all",
                              "served"),
    "m_one": AdcCase(3, 700, 1, 64, np.uint8, False, None, "scalar"),
    "misaligned_plane": AdcCase(3, 2000, 96, 256, np.uint8, False, None,
                                "scalar", offset=1),
    "u8_m16_k128": AdcCase(4, 700, 16, 128, np.uint8, True, 3, "vector"),
    "int32_k300_no_ring": AdcCase(4, 3000, 96, 300, np.int32, True, 2,
                                  "scalar"),
    "kernel_bench": AdcCase(64, 2048, 8, 256, np.uint8, False, None,
                            "scalar", rows=100_000),
    # the width tuner's narrowest sweep point (kc 1, k2 2) at the served
    # capacities: 3,072 candidate slots a query
    "sweep_narrowest": AdcCase(256, 3 * 1024, 96, 256, np.uint8, False,
                               None, "served", layout="lists"),
}


def _adc_inputs(cuda, name):
    cs = ADC_CASES[name]
    rng = np.random.default_rng(len(name))
    lut = torch.tensor(rng.normal(size=(cs.b, cs.m, cs.k)),
                       dtype=torch.float32, device=cuda)
    codes = rng.integers(0, cs.k, (cs.rows, cs.m)).astype(cs.dtype)
    per = cs.offset // codes.itemsize
    flat = torch.zeros(codes.size + per + 16, dtype=torch.from_numpy(
        codes).dtype, device=cuda)
    plane = flat[per:per + codes.size].view(codes.shape)
    plane.copy_(torch.from_numpy(codes))
    if cs.layout == "lists":
        from repro_torch.benchmarks import kernel_variants as kv
        ids, live = kv.sq8_layout(rng, cs.b, cs.c, cs.rows, "lists")
    else:
        ids = rng.integers(-3, cs.rows + 3, (cs.b, cs.c)).astype(np.int32)
        live = rng.random((cs.b, cs.c)) < 0.8
    if cs.dup:
        ids = np.concatenate([ids[:, : (cs.c + 1) // 2]] * 2, -1)[:, :cs.c]
    if cs.mask_row == "all":
        live[:] = False
    elif cs.mask_row is not None:
        live[cs.mask_row] = False
    return (lut, plane, torch.tensor(ids, device=cuda),
            torch.tensor(live, device=cuda))


@pytest.mark.parametrize("name", sorted(ADC_CASES))
def test_pq_adc_fused_kernel_matches_plain(cuda, name):
    """Each case against the plain version, launched through the
    instance the case names (the wrapper's choice, held here)."""
    lut, plane, ids, live = _adc_inputs(cuda, name)
    lib = _build.library("pq_adc_fused")
    vec, plan = adc_ops.choose(lib, lut, plane)
    assert adc_ops.INSTANCES[plan.instance] == ADC_CASES[name].instance
    assert vec == (ADC_CASES[name].instance != "scalar")
    before = adc_ops.launches
    got = adc_ops.pq_adc_fused(lut, plane, ids, live)
    want = adc_ref.pq_adc_fused(lut, plane, ids, live)
    torch.cuda.synchronize()
    assert adc_ops.launches == before + 1
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(n for n, cs in ADC_CASES.items()
                                        if cs.instance != "scalar"))
def test_pq_adc_fused_instances_agree_bit_for_bit(cuda, name):
    """The scalar instance, forced where the wrapper takes a vector one,
    adds the same fragments in the same order: equal scores bit for bit,
    ``-inf`` lanes included.  The C entry refuses ``vec`` on a
    misaligned plane."""
    lut, plane, ids, live = _adc_inputs(cuda, name)
    lib = _build.library("pq_adc_fused")
    vec_out = adc_ops.launch(lib, lut, plane, ids, live, True)
    scalar_out = adc_ops.launch(lib, lut, plane, ids, live, False)
    torch.cuda.synchronize()
    assert torch.equal(vec_out, scalar_out)
    flat = torch.empty(plane.numel() + 16, dtype=plane.dtype, device=cuda)
    skip = (-flat.data_ptr() % 16) // plane.element_size() + 1
    shifted = flat[skip:skip + plane.numel()].view(plane.shape)
    with pytest.raises(RuntimeError, match="launch failed"):
        adc_ops.launch(lib, lut, shifted, ids, live, True)


UNFUSED_CASES = {
    # name: (b, c, m, k, code dtype, codes a view off 16-byte alignment)
    "paper_u8": (3, 8192 + 300, 96, 256, np.uint8, False),
    "paper_i32": (2, 5000, 96, 256, np.int32, False),
    "c_one": (2, 1, 8, 128, np.uint8, False),
    "m_one": (3, 700, 1, 64, np.uint8, False),
    "odd_k": (2, 999, 12, 77, np.int32, False),
    "unaligned_view": (2, 500, 96, 256, np.uint8, True),
}


def _unfused_inputs(cuda, name):
    b, c, m, k, dtype, unaligned = UNFUSED_CASES[name]
    rng = np.random.default_rng(len(name))
    lut = torch.tensor(rng.normal(size=(b, m, k)), dtype=torch.float32,
                       device=cuda)
    flat = torch.tensor(rng.integers(0, k, b * c * m + 3).astype(dtype),
                        device=cuda)
    codes = (flat[3:] if unaligned else flat[:-3]).view(b, c, m)
    return lut, codes


@pytest.mark.parametrize("name", sorted(UNFUSED_CASES))
def test_pq_adc_kernel_matches_plain(cuda, name):
    lut, codes = _unfused_inputs(cuda, name)
    before = adc_ops.unfused_launches
    got = adc_ops.pq_adc(lut, codes)
    want = adc_ref.pq_adc(lut, codes)
    torch.cuda.synchronize()
    assert adc_ops.unfused_launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_pq_adc_kernel_equals_pq_adc_fused_on_live_lanes(cuda):
    """Both kernels add the m fragments in the order j = 0..m-1, so the
    unfused score of gathered codes equals the fused score bit for bit
    on every live lane, for uint8 and int32 planes."""
    rng = np.random.default_rng(11)
    for dtype, k in ((np.uint8, 256), (np.int32, 300)):
        lut = torch.tensor(rng.normal(size=(4, 96, k)), dtype=torch.float32,
                           device=cuda)
        plane = torch.tensor(rng.integers(0, k, (5000, 96)).astype(dtype),
                             device=cuda)
        ids = torch.tensor(rng.integers(0, 5000, (4, 9000)).astype(np.int32),
                           device=cuda)
        live = torch.tensor(rng.random((4, 9000)) < 0.7, device=cuda)
        fused = adc_ops.pq_adc_fused(lut, plane, ids, live)
        unfused = adc_ops.pq_adc(lut, plane[ids.long()])
        assert torch.equal(fused[live], unfused[live]), dtype


TOPK_CASES = {
    # name: (n, l, h, k, centroid layout, elements off alignment); layouts
    # as kernel_variants.topk_inputs: "ties" duplicates the first half of
    # the rows, "ascending" makes every query's scores rise with the id
    # (every candidate beats the running k-th, so the buffers overflow),
    # "equal" repeats one row (ids decide)
    "ties": (33, 300, 32, 12, "ties", 0),
    "ragged_tiles": (17, 129, 40, 8, "ties", 0),
    "k_max": (3, 2000, 96, at_ops.MAX_K, "random", 0),
    "many_slices": (300, 5000, 64, 30, "random", 0),
    "served": (256, 10_000, 768, 30, "random", 0),
    "h37_elementwise": (40, 1000, 37, 30, "random", 0),
    "misaligned_view": (64, 3000, 768, 30, "random", 1),
    "n33_ragged_query_tile": (33, 2000, 768, 30, "random", 0),
    "ties_k128": (20, 1000, 64, 128, "ties", 0),
    # the width tuner's sweep dispatches k = kc = 1 .. 12 (WIDTH_GRID)
    "sweep_k1": (256, 10_000, 768, 1, "random", 0),
    "sweep_k1_ties": (33, 300, 32, 1, "ties", 0),
    "sweep_k2_misaligned": (64, 3000, 768, 2, "random", 1),
    # the selection's adversarial orders, and the runtime's buckets 1 and
    # 8 (one query tile, 40 slices)
    "ascending": (64, 3000, 768, 30, "ascending", 0),
    "all_equal": (40, 1000, 64, 30, "equal", 0),
    "k128_l129": (5, 129, 40, 128, "random", 0),
    "bucket1": (1, 10_000, 768, 30, "random", 0),
    "bucket8": (8, 10_000, 768, 30, "random", 0),
}


def topk_layout(rng, n, l, h, layout):
    """Unit-norm queries and centroids in ``layout`` (numpy, float64)."""
    x = rng.normal(size=(n, h))
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    emb = rng.normal(size=(l, h))
    if layout == "ties":
        emb = np.concatenate([emb[: (l + 1) // 2]] * 2)[:l]
    elif layout == "ascending":
        x *= np.where(x @ emb[0] < 0, -1.0, 1.0)[:, None]
        emb = (np.arange(1, l + 1) / l)[:, None] * emb[0]
    elif layout == "equal":
        emb = np.repeat(emb[:1], l, axis=0)
    return x, emb


@pytest.mark.parametrize("name", sorted(TOPK_CASES))
def test_topk_scores_kernel_matches_plain(cuda, name):
    """h = 37 and a contiguous view one element past a 16-byte boundary
    take the kernel's element-wise copies, the rest the 16-byte ones."""
    n, l, h, k, layout, offset = TOPK_CASES[name]
    rng = np.random.default_rng(n + l)
    x, emb = topk_layout(rng, n, l, h, layout)
    flat = torch.zeros(n * h + offset, dtype=torch.float32, device=cuda)
    x = flat[offset:].view(n, h).copy_(torch.tensor(x))
    assert x.is_contiguous() and (x.data_ptr() % 16 == 0) == (offset == 0)
    emb = torch.tensor(emb, dtype=torch.float32, device=cuda)
    before = at_ops.launches
    gs, gi = at_ops.topk_scores(x, emb, k)
    ws, wi = at_ref.topk_scores(x, emb, k)
    torch.cuda.synchronize()
    assert at_ops.launches == before + 1
    torch.testing.assert_close(gs, ws, rtol=1e-5, atol=1e-5)
    diff = gi != wi
    own = torch.gather(x @ emb.T, 1, gi.long())
    assert ((own - ws).abs()[diff] <= 1e-5 + 1e-5 * ws.abs()[diff]).all()
    assert all(len(set(row)) == len(row) for row in gi.tolist())



def test_topk_scores_tiles_and_residency(cuda):
    """The built kernel reports its 32 × 256 tile and one block an SM
    (occupancy API: 145 KB of shared memory), and the served shape's
    slices fill one wave."""
    from repro_torch.kernels import _build
    tl = at_ops.tiles(_build.library("topk_scores"))
    assert tl == at_ops.Tiles(32, 256, 1)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    s = at_ops.n_slices(256, 10_000, sms, tl)
    assert 1 <= s <= 33 and 8 * s <= tl.blocks_per_sm * sms

SQ8_CASES = {
    # name: (b, c, h, duplicate ids, masked row, byte offset of the plane,
    # id layout, 16-byte row copies).  Layouts other than random ids
    # (kernel_variants.sq8_layout): queries holding whole inverted lists of
    # 1,024 slots, many of them sharing one list, more than a group holds
    # ("lists"); every 512th id one live row and the ids between differing
    # ("same_key_differs"); two lists held by every query, half the lanes
    # dead, so one row is live for one query and dead for another of a
    # group ("dedup")
    "c_below_tile": (3, 5, 768, False, 1, 0, "random", True),
    "c_ragged": (2, 3 * 512 + 77, 768, True, None, 0, "random", True),
    "h16_masked": (4, 700, 16, False, 3, 0, "random", True),
    "h40_scalar": (2, 333, 40, True, 0, 0, "random", False),
    "unaligned_view": (2, 600, 768, False, None, 3, "random", False),
    "all_masked": (2, 100, 64, False, "all", 0, "random", True),
    "shared_lists": (20, 3 * 1024, 768, False, None, 0, "lists", True),
    "same_key_differs": (12, 2 * 512 + 40, 768, False, None, 0,
                         "same_key_differs", True),
    "dedup_across_lists": (6, 2 * 1024, 64, False, None, 0, "dedup", True),
    "served_ragged": (12, 2 * 1024 + 300, 768, False, None, 0, "lists",
                      True),
    "shared_lists_h40": (10, 2 * 1024, 40, False, 2, 0, "lists", False),
    # the width tuner's narrowest sweep point (kc 1, k2 2)
    "sweep_narrowest": (256, 3 * 1024, 768, False, None, 0, "lists", True),
}


@pytest.mark.parametrize("name", sorted(SQ8_CASES))
def test_sq8_dot_fused_kernel_matches_plain(cuda, name):
    from repro_torch.benchmarks import kernel_variants as kv
    b, c, h, dup, mask, offset, layout, vec = SQ8_CASES[name]
    rng = np.random.default_rng(len(name) + 100)
    q = torch.tensor(rng.normal(size=(b, h)), dtype=torch.float32,
                     device=cuda)
    flat = torch.tensor(rng.integers(0, 256, 700 * h + offset),
                        dtype=torch.uint8, device=cuda)
    plane = flat[offset:].view(700, h)
    if layout == "random":
        ids = rng.integers(-3, 703, (b, c)).astype(np.int32)    # clipped
        if dup:
            ids = np.concatenate([ids[:, : (c + 1) // 2]] * 2, -1)[:, :c]
        live = rng.random((b, c)) < 0.8
    else:
        ids, live = kv.sq8_layout(rng, b, c, 700, layout)
    assert sq8_ops.sq8_vector_loads(plane) is vec
    if mask == "all":
        live[:] = False
    elif mask is not None:
        live[mask] = False
    ids, live = torch.tensor(ids, device=cuda), torch.tensor(live,
                                                            device=cuda)
    before = sq8_ops.launches
    got = sq8_ops.sq8_dot_fused(q, plane, ids, live)
    want = sq8_ref.sq8_dot_fused(q, plane, ids, live)
    torch.cuda.synchronize()
    assert sq8_ops.launches == before + 1
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-4, atol=1e-2)


def _random_index_leaves(rng):
    n, h, l, v, m, k = 6000, 64, 40, 300, 8, 256
    zipf = 1.0 / np.arange(1, v + 1) ** 1.07
    zipf /= zipf.sum()
    cl = il.build(np.arange(n), rng.integers(0, l, n), None, l, 256,
                  device="cpu")
    terms = rng.choice(v, size=3 * n, p=zipf)
    tl = il.build(np.repeat(np.arange(n), 3), terms, rng.random(3 * n), v,
                  64, device="cpu")
    rot, _ = np.linalg.qr(rng.normal(size=(h, h)))
    return {
        ".cluster_sel.embeddings": rng.normal(size=(l, h)).astype(
            np.float32),
        ".term_sel.avg_scores": (rng.random(v) + 0.1).astype(np.float32),
        ".cluster_lists.entries": cl.entries.numpy(),
        ".cluster_lists.lengths": cl.lengths.numpy(),
        ".term_lists.entries": tl.entries.numpy(),
        ".term_lists.lengths": tl.lengths.numpy(),
        ".codec_params.rotation": rot.astype(np.float32),
        ".codec_params.codebook.codewords": rng.normal(
            size=(m, k, h // m)).astype(np.float32),
        ".doc_planes['codes']": rng.integers(0, k, (n, m), dtype=np.uint8),
        ".doc_assign": rng.integers(0, l, n).astype(np.int32),
    }


def test_search_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(7)
    leaves = _random_index_leaves(rng)
    qe = rng.normal(size=(24, 64))
    qe = (qe / np.linalg.norm(qe, axis=-1, keepdims=True)).astype(
        np.float32)
    qt = rng.integers(-1, 300, (24, 12)).astype(np.int32)
    kw = dict(kc=6, k2=8, top_r=100)
    want = hi.search(ckpt.index_from_numpy(leaves, "opq", device="cpu"),
                     qe, qt, device="cpu", **kw)
    before = (adc_ops.launches, at_ops.launches)
    got = hi.search(ckpt.index_from_numpy(leaves, "opq", device=cuda),
                    qe, qt, device=cuda, **kw)
    torch.cuda.synchronize()
    assert (adc_ops.launches, at_ops.launches) == (before[0] + 1,
                                                   before[1] + 1)
    assert torch.equal(got.n_candidates.cpu(), want.n_candidates)
    torch.testing.assert_close(got.scores.cpu(), want.scores, rtol=1e-4,
                               atol=1e-4)
    gi, wi = got.doc_ids.cpu(), want.doc_ids
    ws = want.scores
    for b, p in torch.nonzero(gi != wi).tolist():
        where = torch.nonzero(wi[b] == gi[b, p]).flatten()
        ref = ws[b, where[0]] if where.numel() else ws[b, -1]
        assert abs(float(ref - got.scores[b, p])) <= 1e-4 + 1e-4 * abs(
            float(ref))


def test_fused_search_on_the_card_matches_the_cpu(cuda):
    """Hybrid search over an impact plane: the sparse top-R and its
    count bitwise equal to the CPU's, the fused top-R bitwise equal to
    the CPU's fusion of the card's own dense and sparse lists (the dense
    half is held to the CPU by the test above), weight 1.0 ids bitwise
    equal to dense-only."""
    from repro_torch.core import exec as qexec
    rng = np.random.default_rng(9)
    leaves = _random_index_leaves(rng)
    entries = leaves[".term_lists.entries"]
    leaves[".sparse_weights"] = np.where(
        entries >= 0, rng.random(entries.shape) + 0.05, 0.0).astype(
            np.float32)
    qe = rng.normal(size=(24, 64))
    qe = (qe / np.linalg.norm(qe, axis=-1, keepdims=True)).astype(
        np.float32)
    qt = rng.integers(-1, 300, (24, 12)).astype(np.int32)
    kw = dict(kc=6, k2=8, top_r=100)
    cpu_index = ckpt.index_from_numpy(leaves, "opq", device="cpu")
    index = ckpt.index_from_numpy(leaves, "opq", device=cuda)
    _, cpu_terms = qexec.dispatch(cpu_index.cluster_sel, cpu_index.term_sel,
                                  torch.from_numpy(qe),
                                  torch.from_numpy(qt).long(), 6, 8)
    want_sp = qexec.sparse_topk([hi.base_source(cpu_index)], cpu_terms, 100,
                                None)
    got_sp = qexec.sparse_topk([hi.base_source(index)], cpu_terms.to(cuda),
                               100, None)
    for g, w in zip(got_sp, want_sp):
        assert torch.equal(g.cpu(), w)
    dense = hi.search(index, qe, qt, device=cuda, **kw)
    for weight in (0.0, 0.5, 1.0):
        fus = qexec.FusionSpec(weight=weight)
        got = hi.search(index, qe, qt, device=cuda, fusion=fus, **kw)
        d_s = torch.where(dense.doc_ids >= 0, dense.scores,
                          -torch.inf).cpu()
        want_s, want_ids = qexec.fuse(d_s, dense.doc_ids.cpu(), *want_sp[:2],
                                      fus, 100)
        valid = torch.isfinite(want_s)
        assert torch.equal(got.doc_ids.cpu(),
                           torch.where(valid, want_ids, il.PAD_DOC).int())
        assert torch.equal(got.scores.cpu(),
                           torch.where(valid, want_s, 0.0))
        assert torch.equal(got.n_candidates.cpu(),
                           dense.n_candidates.cpu() + want_sp[2])
        if weight == 1.0:
            assert torch.equal(got.doc_ids, dense.doc_ids)


def test_refine_sq8_search_on_the_card_matches_the_cpu(cuda):
    """The refine:sq8:4 setting over the same random lists: SQ8 codes of
    an fp16 refine plane, built by the codec itself."""
    import dataclasses

    from repro_torch.core.codecs import sq8
    rng = np.random.default_rng(8)
    leaves = _random_index_leaves(rng)
    base = ckpt.index_from_numpy(leaves, "opq", device="cpu")
    emb = torch.tensor(rng.normal(size=(6000, 64)) / 8.0,
                       dtype=torch.float16)
    codec = sq8.SQ8Codec()
    params = codec.train(None, emb)
    cpu_index = dataclasses.replace(
        base, codec="refine:sq8:4", codec_params=params,
        doc_planes={"codes": codec.encode(params, emb)["codes"],
                    "refine_emb": emb})
    qe = rng.normal(size=(24, 64))
    qe = (qe / np.linalg.norm(qe, axis=-1, keepdims=True)).astype(
        np.float32)
    qt = rng.integers(-1, 300, (24, 12)).astype(np.int32)
    kw = dict(kc=6, k2=8, top_r=50)
    want = hi.search(cpu_index, qe, qt, device="cpu", **kw)
    before = (sq8_ops.launches, at_ops.launches)
    got = hi.search(cpu_index.to(cuda), qe, qt, device=cuda, **kw)
    torch.cuda.synchronize()
    assert (sq8_ops.launches, at_ops.launches) == (before[0] + 1,
                                                   before[1] + 1)
    assert torch.equal(got.n_candidates.cpu(), want.n_candidates)
    torch.testing.assert_close(got.scores.cpu(), want.scores, rtol=1e-4,
                               atol=1e-4)
    gi, wi, ws = got.doc_ids.cpu(), want.doc_ids, want.scores
    for b, p in torch.nonzero(gi != wi).tolist():
        where = torch.nonzero(wi[b] == gi[b, p]).flatten()
        ref = ws[b, where[0]] if where.numel() else ws[b, -1]
        assert abs(float(ref - got.scores[b, p])) <= 1e-4 + 1e-4 * abs(
            float(ref))


def test_build_on_the_card_matches_the_cpu_where_it_is_deterministic(cuda):
    """The build on the card: BM25, term lists, φ(D) given the same
    centroids, and SQ8 codes equal the CPU build's."""
    from repro_torch.core import cluster_selector as cs
    from repro_torch.data import synthetic
    c = synthetic.generate(seed=1, n_docs=3000, n_queries=8, hidden=64,
                           vocab_size=1024)
    kw = dict(n_clusters=32, k1_terms=4, codec="sq8", cluster_capacity=256,
              term_capacity=64, kmeans_iters=4)
    cpu = hi.build(0, c.doc_emb, c.doc_tokens, c.vocab_size, device="cpu",
                   **kw)
    card = hi.build(0, c.doc_emb, c.doc_tokens, c.vocab_size, device=cuda,
                    cluster_sel=cs.ClusterSelector(
                        cpu.cluster_sel.embeddings),
                    doc_assign=cpu.doc_assign, **kw)
    for g, w in ((card.term_lists.entries, cpu.term_lists.entries),
                 (card.doc_planes["codes"], cpu.doc_planes["codes"]),
                 (card.codec_params["lo"], cpu.codec_params["lo"]),
                 (card.codec_params["scale"], cpu.codec_params["scale"])):
        assert torch.equal(g.cpu(), w)
    torch.testing.assert_close(card.term_sel.avg_scores.cpu(),
                               cpu.term_sel.avg_scores, rtol=1e-5,
                               atol=1e-6)
    same = (cs.select_for_doc(cpu.cluster_sel.to(cuda),
                              torch.from_numpy(c.doc_emb).to(cuda)).cpu()
            == cpu.doc_assign)
    assert float(same.float().mean()) > 0.999


ASSIGN_CASES = {
    # name: (m, n, l, h, duplicated centroid rows, elements off 16-byte
    # alignment, x the (n, m·h) matrix's strided (m, n, h) view)
    "ragged": (1, 513, 7, 40, False, 0, False),
    "one_point": (1, 1, 10_000, 768, False, 0, False),
    "ties": (1, 300, 1030, 64, True, 0, False),
    "pq_batch": (96, 700, 256, 8, True, 0, False),
    # the 4-byte copies (h % 4 != 0; a base off alignment), and the narrow
    # instance at d_sub 4 through PQ's strided view
    "h37_elementwise": (1, 1000, 300, 37, False, 0, False),
    "misaligned_view": (1, 777, 500, 768, False, 1, False),
    "pq_dsub4": (192, 3000, 256, 4, True, 0, True),
}


@pytest.mark.parametrize("name", sorted(ASSIGN_CASES))
def test_assign_argmax_kernel_matches_plain(cuda, name):
    m, n, l, h, ties, offset, view = ASSIGN_CASES[name]
    rng = np.random.default_rng(n + l)
    flat = torch.tensor(rng.normal(size=m * n * h + offset),
                        dtype=torch.float32, device=cuda)
    x = (flat.view(n, m, h).transpose(0, 1) if view
         else flat[offset:].view(m, n, h))
    assert (x.data_ptr() % 16 != 0) == (offset != 0)
    assert at_ops.assign_vector_loads(x, x.new_empty(1, 1, h)) == (
        h % 4 == 0 and offset == 0)
    c = rng.normal(size=(m, l, h))
    if ties:
        c = np.concatenate([c[:, : (l + 1) // 2]] * 2, axis=1)[:, :l]
    c = torch.tensor(c, dtype=torch.float32, device=cuda)
    before = at_ops.assign_launches
    gs, gi = at_ops.assign_argmax(x, c)
    ws, wi = at_ref.assign_argmax(x, c)
    torch.cuda.synchronize()
    assert at_ops.assign_launches == before + 1
    torch.testing.assert_close(gs, ws, rtol=1e-5, atol=1e-5)
    full = x @ c.transpose(1, 2) - 0.5 * (c * c).sum(-1)[:, None, :]
    own = torch.gather(full, 2, gi.long()[..., None])[..., 0]
    diff = gi != wi
    assert ((own - ws).abs()[diff] <= 1e-5 + 1e-5 * ws.abs()[diff]).all()
    if ties:                           # the lower twin wins every tie
        assert bool((gi < (l + 1) // 2).all())


def test_kmeans_assign_is_one_launch_over_the_batch(cuda):
    """PQ's (m, n, d_sub) strided view of (n, h) data goes to the kernel
    whole: one launch, no copy, the CPU's codes."""
    from repro_torch.core import kmeans
    from repro_torch.core.codecs import pq
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(20_000, 64)), dtype=torch.float32)
    cb = pq.PQCodebook(torch.tensor(rng.normal(size=(8, 256, 8)),
                                    dtype=torch.float32))
    want = pq.pq_encode(cb, x)
    before = at_ops.assign_launches
    got = pq.pq_encode(cb.to(cuda), x.to(cuda))
    torch.cuda.synchronize()
    assert at_ops.assign_launches == before + 1
    assert float((got.cpu() == want).float().mean()) > 0.9999
    before = at_ops.assign_launches
    kmeans.kmeans_fit(torch.Generator(device=cuda).manual_seed(0),
                      x[:4000].to(cuda), n_clusters=16, n_iters=3)
    assert at_ops.assign_launches == before + 4


FLASH_CASES = {
    # name: (dtype, b, hq, hkv, sq, sk, d, causal, window, element offset
    # of every input's storage: 1 misaligns it and takes the element-wise
    # load instance)
    "f32_encoder_d64": (torch.float32, 3, 12, 12, 64, 64, 64, False, 0, 0),
    "f32_d16_gqa_ragged": (torch.float32, 2, 4, 2, 63, 63, 16, True, 0, 0),
    "f32_d128_window": (torch.float32, 1, 8, 1, 200, 200, 128, True, 32, 0),
    "f32_dead_rows": (torch.float32, 2, 4, 4, 384, 63, 32, False, 32, 0),
    "bf16_d128_gqa": (torch.bfloat16, 1, 32, 8, 384, 384, 128, True, 0, 0),
    "bf16_one_row": (torch.bfloat16, 2, 4, 2, 1, 200, 64, False, 0, 0),
    # one full HI²_sup encoder chunk (4,096 docs x 12 heads x 64 tokens)
    "f32_encoder_chunk_full": (torch.float32, 4096, 12, 12, 64, 64, 64,
                               False, 0, 0),
    # 828 items over 23 batches: more than one wave of the 132 x 4 blocks
    # resident at d = 64, with a ragged last q tile
    "f32_many_items_ragged": (torch.float32, 23, 12, 12, 130, 130, 64,
                              False, 0, 0),
    "f32_misaligned_view": (torch.float32, 2, 4, 2, 100, 100, 64, True, 0,
                            1),
    "bf16_misaligned_view": (torch.bfloat16, 2, 4, 2, 70, 90, 32, False, 0,
                             1),
    # a window of 300 over 1,000 causal keys: each q tile walks only the
    # kv tiles its window reaches, and skips those below it
    "f32_causal_window_skips": (torch.float32, 1, 4, 4, 1000, 1000, 64,
                                True, 300, 0),
    "bf16_d128_s1000": (torch.bfloat16, 1, 8, 2, 1000, 1000, 128, False, 0,
                        0),
    # head dims outside {16, 32, 64, 128} run ragged in the next instance
    # up: SASRec's d = 50 (200-byte f32 rows, the element-wise loads) and
    # d = 40 (160-byte f32 rows, the 16-byte copies, short at column 40)
    "f32_d50_sasrec": (torch.float32, 64, 1, 1, 50, 50, 50, True, 0, 0),
    "bf16_d50_gqa_ragged": (torch.bfloat16, 2, 4, 2, 130, 70, 50, False, 0,
                            0),
    "f32_d50_misaligned_one_row": (torch.float32, 3, 1, 1, 1, 1, 50, True,
                                   0, 1),
    "f32_d40_window": (torch.float32, 2, 4, 2, 130, 130, 40, True, 32, 0),
    "bf16_d40": (torch.bfloat16, 2, 2, 2, 100, 100, 40, False, 0, 0),
    # the dense LMs' attention, bf16 causal: llama3-8b (GQA 4:1, d 128),
    # internlm2-1.8b (2:1, d 128), stablelm-3b (1:1, d 80, ragged in the
    # d 128 instance)
    "bf16_llama3_gqa4_d128": (torch.bfloat16, 1, 32, 8, 2048, 2048, 128,
                              True, 0, 0),
    "bf16_internlm2_gqa2_d128": (torch.bfloat16, 2, 16, 8, 2048, 2048, 128,
                                 True, 0, 0),
    "bf16_stablelm_d80": (torch.bfloat16, 1, 32, 32, 2048, 2048, 80, True,
                          0, 0),
    # the bf16 tensor-core kernel: d 80 (its own instance) with GQA 6:1
    # under a causal window; a causal Sq < Sk (absolute positions); q and
    # k scaled x8 (FLASH_SCALED: scores ~64x, so the online rescale
    # moves); d 16; 384 items, more than one wave of the 132 blocks
    # resident at d 128, with a ragged last q tile
    "bf16_d80_gqa6_window": (torch.bfloat16, 1, 12, 2, 300, 300, 80, True,
                             64, 0),
    "bf16_causal_sq70_sk300": (torch.bfloat16, 2, 4, 2, 70, 300, 64, True,
                               0, 0),
    "bf16_large_scores_x8": (torch.bfloat16, 2, 8, 2, 500, 500, 128, True,
                             0, 0),
    "bf16_d16": (torch.bfloat16, 2, 4, 2, 130, 130, 16, True, 0, 0),
    "bf16_many_items_ragged": (torch.bfloat16, 3, 16, 8, 1000, 1000, 128,
                               False, 0, 0),
}
#: cases whose q and k are multiplied by this factor (exact in bf16)
FLASH_SCALED = {"bf16_large_scores_x8": 8.0}


def _bshd_at(g, dev, b, s, h, d, dtype, offset):
    """A (B, H, S, d) view of (B, S, H, d) memory that starts ``offset``
    elements into its storage."""
    n = b * s * h * d
    flat = torch.randn(n + offset, generator=g, device=dev).to(dtype)
    return flat[offset:].view(b, s, h, d).transpose(1, 2)


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_attention_kernel_matches_plain(cuda, name):
    dtype, b, hq, hkv, sq, sk, d, causal, window, offset = FLASH_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(len(name))
    # q, k, v as (B, H, S, d) views of (B, S, H, d) memory
    q = _bshd_at(g, cuda, b, sq, hq, d, dtype, offset)
    k, v = (_bshd_at(g, cuda, b, sk, hkv, d, dtype, offset)
            for _ in range(2))
    if name in FLASH_SCALED:
        q, k = (t * FLASH_SCALED[name] for t in (q, k))
    assert fa_ops.vector_loads(q, k, v) is (
        offset == 0 and d * q.element_size() % 16 == 0)
    before = fa_ops.launches
    out, lse = fa_ops.flash_attention(q, k, v, causal, window)
    want, wlse = fa_ref.flash_attention(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    assert out.dtype == dtype and out.shape == (b, hq, sq, d)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, wlse, rtol=1e-4, atol=1e-4)
    dead = wlse == fa_ref.NEG_INF
    assert torch.equal(lse == fa_ref.NEG_INF, dead)
    assert bool((out[dead] == 0).all())
    if name == "f32_dead_rows":
        assert bool(dead.any())


def test_flash_attention_bf16_negative_scale_matches_plain(cuda):
    """A negative scale: the tensor-core kernel negates Q's fragments
    (exactly) and scales by |scale|, so its row max is still the max."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q = _bshd_at(g, cuda, 2, 200, 4, 64, torch.bfloat16, 0)
    k, v = (_bshd_at(g, cuda, 2, 200, 2, 64, torch.bfloat16, 0)
            for _ in range(2))
    out, lse = fa_ops.flash_attention(q, k, v, True, 0, scale=-0.125)
    want, wlse = fa_ref.flash_attention(q, k, v, True, 0, scale=-0.125)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(lse, wlse, rtol=1e-4, atol=1e-4)


def test_sasrec_user_embedding_on_the_card_matches_the_cpu(cuda):
    """SASRec at its published width (d 50, 1 head, 2 blocks, S 50) on
    1,000 items: each block one flash launch at d = 50, the users within
    1e-4 of the CPU on the same weights; retrieval over the item table
    gives the CPU's ids, ties (every item twinned) to the lower id."""
    from repro_torch import tree
    from repro_torch.data import recsys as rdata
    from repro_torch.models import recsys
    cfg = recsys.SASRecConfig(n_items=1_000)
    params = recsys.sasrec_init(torch.Generator().manual_seed(0), cfg)
    table = params["item_embed"]["table"]
    table[500:] = table[:500]                    # items i and i + 500 tie
    on_card = tree.to(params, cuda)
    items = rdata.sasrec_batch(0, 300, n_items=cfg.n_items, device="cpu"
                               ).items
    items[:3, :20] = recsys.PAD_ID
    before = fa_ops.launches
    got = recsys.sasrec_user_embedding(on_card, cfg, items.to(cuda))
    torch.cuda.synchronize()
    assert fa_ops.launches == before + cfg.n_blocks
    want = recsys.sasrec_user_embedding(params, cfg, items)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for row in range(4):
        gs, gi = recsys.sasrec_retrieval(on_card, cfg,
                                         items[row:row + 1].to(cuda), 40)
        ws, wi = recsys.sasrec_retrieval(params, cfg, items[row:row + 1], 40)
        torch.testing.assert_close(gs.cpu(), ws, rtol=1e-4, atol=1e-4)
        assert torch.equal(gi.cpu(), wi)
        ids = gi[0].tolist()
        assert all(ids[j + 1] == ids[j] + 500 for j in range(0, 40, 2))


def test_sup_position_scores_on_the_card_match_the_cpu(cuda):
    """The HI²_sup term scorer on the card: every layer's attention is
    one flash launch, and the scores are the CPU's within 1e-4."""
    from repro_torch.core import distill, term_selector as ts
    from repro_torch.launch import train
    from repro_torch.models import transformer as tfm
    rng = np.random.default_rng(4)
    cfg = tfm.TransformerConfig(n_layers=2, d_model=64, n_heads=4,
                                n_kv_heads=4, d_ff=256, vocab_size=300,
                                causal=False, compute_dtype=torch.float32)

    def w(*shape, scale=1.0):
        return torch.tensor(rng.normal(size=shape) * scale,
                            dtype=torch.float32)

    d, f, L = 64, 256, 2
    enc = {"embed": {"table": w(300, d, scale=0.02)},
           "final_norm": {"scale": torch.ones(d)},
           "unembed": {"w": w(d, 300, scale=d ** -0.5)},
           "layers": {"attn_norm": {"scale": torch.ones(L, d)},
                      "mlp_norm": {"scale": torch.ones(L, d)},
                      "attn": {k: {"w": w(L, d, d, scale=d ** -0.5)}
                               for k in ("wq", "wk", "wv", "wo")},
                      "mlp": {"w_gate": {"w": w(L, d, f, scale=d ** -0.5)},
                              "w_up": {"w": w(L, d, f, scale=d ** -0.5)},
                              "w_down": {"w": w(L, f, d, scale=f ** -0.5)}}}}
    params = distill.DistillParams(
        w(16, 32), ts.TermMLP(w(d, d, scale=0.125), torch.zeros(d),
                              w(d, 1, scale=0.125), torch.zeros(1)), enc)
    tokens = rng.integers(0, 300, (100, 64)).astype(np.int32)
    tokens[::4, 40:] = -1
    want = train.SupSelectors(params, cfg, encode_batch=64,
                              device="cpu").position_scores(tokens)
    before = fa_ops.launches
    got = train.SupSelectors(params, cfg, encode_batch=64,
                             device=cuda).position_scores(tokens)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 2 * 2      # 2 chunks x 2 layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# HI²_sup training on the card: flash_attention under autograd, a step
# against the CPU, repeatable runs and resume
# --------------------------------------------------------------------------

FLASH_GRAD_CASES = {   # b, h, s, d, causal, window
    "docs": (384, 12, 64, 64, False, 0),
    "queries": (32, 12, 8, 64, False, 0),
    "ragged": (3, 4, 37, 64, False, 0),
    "window": (2, 4, 100, 32, True, 16),
}


@pytest.mark.parametrize("name", sorted(FLASH_GRAD_CASES))
def test_flash_attention_gradients_on_the_card_match_plain_autograd(cuda,
                                                                    name):
    """The Function (kernel forward, recompute backward) against autograd
    through the plain version on the card: one launch, none in the
    backward, dq, dk, dv within rtol = atol = 1e-4 under a loss that
    depends on the forward (Σ w·out²)."""
    b, h, s, d, causal, window = FLASH_GRAD_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(len(name))
    q, k, v, w = (_bshd_at(g, cuda, b, s, h, d, torch.float32, 0)
                  for _ in range(4))
    grads = []
    for kernel in (True, False):
        inputs = [t.detach().requires_grad_(True) for t in (q, k, v)]
        before = fa_ops.launches
        if kernel:
            out = fa_ops.flash_attention(*inputs, causal, window)[0]
        else:
            out = fa_ref.attention(*inputs, causal=causal, window=window)
        (w * out * out).sum().backward()
        torch.cuda.synchronize()
        assert fa_ops.launches == before + kernel
        grads.append([t.grad for t in inputs])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _train_setup(cuda):
    from repro_torch.data import synthetic
    from repro_torch.launch import train
    corpus = synthetic.generate(seed=0, n_docs=2000, n_queries=64,
                                hidden=32, vocab_size=512, n_topics=16,
                                make_model_b=False)
    cfg = train.SupTrainConfig(n_clusters=16, encoder_layers=2,
                               encoder_dim=64, encoder_heads=4, n_steps=6,
                               batch_queries=8, n_negatives=3, n_inbatch=4,
                               refine_weight=0.5, kmeans_iters=4)
    return corpus, cfg


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One value-and-grad of the distillation loss on the card against
    the CPU plain path from the same parameters and batch: the loss, its
    aux terms and every gradient leaf within rtol = atol = 1e-4."""
    from repro_torch import optim
    from repro_torch import tree as tree_mod
    from repro_torch.data import synthetic
    from repro_torch.launch import train
    corpus, cfg = _train_setup(cuda)
    params, enc_cfg, assign = train.init_sup(corpus, cfg, device=cuda)
    batch = train.sup_batches(corpus, cfg, synthetic.hard_negatives(
        corpus, cfg.n_negatives), assign)(0)
    loss = train.sup_loss(enc_cfg, corpus.vocab_size, cfg.refine_weight)
    before = fa_ops.launches
    (value, aux), grads = optim.value_and_grad(
        loss, params, tree_mod.to(batch, cuda), has_aux=True)
    assert fa_ops.launches == before + 2 * cfg.encoder_layers
    (c_value, c_aux), c_grads = optim.value_and_grad(
        loss, params.to("cpu"), batch, has_aux=True)
    for key in aux:
        torch.testing.assert_close(aux[key].cpu(), c_aux[key], rtol=1e-4,
                                   atol=1e-4)
    for (path, got), want in zip(hi.index_leaves(grads),
                                 tree_mod.leaves(c_grads)):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4,
                                   msg=path)


def test_train_hi2_sup_on_the_card_is_repeatable_and_resumes(cuda,
                                                             tmp_path):
    """Two train_hi2_sup runs from one seed are equal bit for bit (4
    flash launches a step), and a fit saved at step 3 and resumed equals
    the straight run bit for bit — the gradient gathers sum in row
    order, not by atomics."""
    from repro_torch import optim
    from repro_torch import tree as tree_mod
    from repro_torch.launch import train
    corpus, cfg = _train_setup(cuda)
    runs = []
    for _ in range(2):
        before = fa_ops.launches
        runs.append(train.train_hi2_sup(corpus, cfg, log_every=0,
                                        device=cuda))
        assert fa_ops.launches == before + 4 * cfg.n_steps
    (p1, _, a1, l1), (p2, _, a2, l2) = runs
    assert l1 == l2 and torch.equal(a1, a2)
    for x, y in zip(tree_mod.leaves(p1), tree_mod.leaves(p2)):
        assert torch.equal(x, y)

    params, enc_cfg, assign = train.init_sup(corpus, cfg, device=cuda)
    loss = train.sup_loss(enc_cfg, corpus.vocab_size, cfg.refine_weight)
    batches = train.sup_batches(corpus, cfg, train.negative_pool(corpus,
                                                                 cfg),
                                assign)

    def run(n, **kw):
        return train.fit(loss, params, batches, n,
                         adam=optim.AdamConfig(lr=cfg.lr),
                         schedule=optim.warmup_cosine(cfg.warmup_steps, 6),
                         log_every=0, device=cuda, **kw)

    straight, losses = run(6)
    assert losses == l1            # train_hi2_sup is init_sup + this fit
    ckpt_dir = str(tmp_path / "ckpt")
    run(3, ckpt_dir=ckpt_dir, save_every=3)
    resumed, tail = run(6, ckpt_dir=ckpt_dir, save_every=3)
    assert tail == losses[3:]
    for x, y in zip(tree_mod.leaves(straight), tree_mod.leaves(resumed)):
        assert torch.equal(x, y)


# --------------------------------------------------------------------------
# the mutable index on the card (DESIGN.md §8) and a repeatable build
# --------------------------------------------------------------------------

def _assert_same_index(a, b):
    la, lb = hi.index_leaves(a), hi.index_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb] and la
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), p


def _build_corpus():
    from repro_torch.data import synthetic
    return synthetic.generate(seed=1, n_docs=3000, n_queries=16, hidden=64,
                              vocab_size=1024)


BUILD_KW = dict(n_clusters=32, k1_terms=4, pq_m=8, cluster_capacity=256,
                term_capacity=64, kmeans_iters=4, sparse=True)


@pytest.mark.parametrize("codec", ["opq", "sq8", "refine:sq8:4", "flat"])
def test_two_builds_on_the_card_are_equal_leaf_for_leaf(cuda, codec):
    """hybrid_index.build is a function of (seed, corpus) on the card too:
    KMeans' centroid sums and the term selector's s̄ are summed in an
    order fixed by the data, not by the atomics of index_add_."""
    c = _build_corpus()
    a, b = (hi.build(0, c.doc_emb, c.doc_tokens, c.vocab_size, codec=codec,
                     device=cuda, **BUILD_KW) for _ in range(2))
    _assert_same_index(a, b)


def _mutable_kw():
    return dict(delta_capacity=256, delta_cluster_capacity=8,
                delta_term_capacity=8, codec="opq", **BUILD_KW)


def test_compact_on_the_card_equals_a_rebuild(cuda):
    from repro_torch.core import exec as qexec
    from repro_torch.core import segments as seg
    c = _build_corpus()
    mut = seg.MutableHybridIndex.create(0, c.doc_emb[:-200],
                                        c.doc_tokens[:-200], c.vocab_size,
                                        device=cuda, **_mutable_kw())
    ids = mut.add_docs(c.doc_emb[-200:], c.doc_tokens[-200:])
    mut.delete_docs(np.r_[ids[:50], 3, 4, 7])
    compacted = mut.compact()
    emb, tok = mut.surviving_corpus()
    rebuilt = hi.build(0, emb, tok, c.vocab_size, codec="opq", device=cuda,
                       **BUILD_KW)
    _assert_same_index(compacted.base, rebuilt)
    for f in (None, qexec.FusionSpec(weight=0.5)):
        a = compacted.search(c.query_emb, c.query_tokens, kc=6, k2=8,
                             top_r=50, fusion=f)
        b = hi.search(rebuilt, c.query_emb, c.query_tokens, kc=6, k2=8,
                      top_r=50, fusion=f, device=cuda)
        for x, y in ((a.doc_ids, b.doc_ids), (a.scores, b.scores),
                     (a.n_candidates, b.n_candidates)):
            assert torch.equal(x, y), f


def test_mutable_search_on_the_card_matches_the_cpu(cuda):
    """The same base + delta + tombstones on both devices (the CPU
    index's state moved to the card) at fills 0, partial and full: the
    card's dense and fused searches against the CPU plain path, and the
    card's own add_docs gives the CPU's delta planes."""
    from repro_torch.core import exec as qexec
    from repro_torch.core import segments as seg
    c = _build_corpus()
    cpu = seg.MutableHybridIndex.create(0, c.doc_emb[:-256],
                                        c.doc_tokens[:-256], c.vocab_size,
                                        device="cpu", **_mutable_kw())

    def on_card(mut):
        tree = dict(mut.state_tree(), base=mut.base.to(cuda))
        return seg.MutableHybridIndex.from_state(tree, mut.state_extra(),
                                                 seed=mut.seed)

    card = on_card(cpu)
    for lo, hi_ in ((0, 0), (0, 100), (100, 256)):
        if hi_ > lo:
            tail = slice(len(c.doc_emb) - 256 + lo, len(c.doc_emb) - 256 + hi_)
            want_ids = cpu.add_docs(c.doc_emb[tail], c.doc_tokens[tail])
            got_ids = card.add_docs(c.doc_emb[tail], c.doc_tokens[tail])
            np.testing.assert_array_equal(got_ids, want_ids)
            dw, dg = cpu.state_tree()["delta"], card.state_tree()["delta"]
            for k in ("cluster_entries", "term_entries", "assign"):
                np.testing.assert_array_equal(dg[k], dw[k], k)
            np.testing.assert_array_equal(dg["planes"]["codes"],
                                          dw["planes"]["codes"])
            cpu.delete_docs(want_ids[::5])
            card = on_card(cpu)                  # identical planes
        assert card.delta_fill == hi_ / 256
        for f in (None, qexec.FusionSpec(weight=0.5)):
            kw = dict(kc=6, k2=8, top_r=100, fusion=f)
            want = cpu.search(c.query_emb, c.query_tokens, **kw)
            before = adc_ops.launches
            got = card.search(c.query_emb, c.query_tokens, **kw)
            torch.cuda.synchronize()
            assert adc_ops.launches == before + 2   # base and delta
            assert not cpu.is_deleted(
                got.doc_ids.cpu()[got.doc_ids.cpu() >= 0]).any()
            assert torch.equal(got.n_candidates.cpu(), want.n_candidates)
            torch.testing.assert_close(got.scores.cpu(), want.scores,
                                       rtol=1e-4, atol=1e-4)
            gi, wi, ws = got.doc_ids.cpu(), want.doc_ids, want.scores
            for b, p in torch.nonzero(gi != wi).tolist():
                where = torch.nonzero(wi[b] == gi[b, p]).flatten()
                ref = ws[b, where[0]] if where.numel() else ws[b, -1]
                assert abs(float(ref - got.scores[b, p])) <= (
                    1e-4 + 1e-4 * abs(float(ref)))


@pytest.mark.parametrize("live_lanes", [0, 5])
@pytest.mark.parametrize("kernel", ["pq_adc_fused", "sq8_dot_fused"])
def test_score_kernels_over_a_delta_plane(cuda, kernel, live_lanes):
    """The delta source's plane at the served widths: (256, 1,736)
    candidate slots (K^C 30 × 28 + K₂ᵀ 32 × 28) over a 65,536-row delta,
    PAD ids (row 0) and dead everywhere but ``live_lanes`` lanes a
    query."""
    rng = np.random.default_rng(11 + live_lanes)
    b, c, rows = 256, 30 * 28 + 32 * 28, 65_536
    ids = np.zeros((b, c), np.int32)
    live = np.zeros((b, c), bool)
    for q in range(b):
        pos = rng.choice(c, live_lanes, replace=False)
        ids[q, pos] = rng.integers(0, 4096, live_lanes)
        live[q, pos] = True
    ids, live = torch.tensor(ids, device=cuda), torch.tensor(live,
                                                            device=cuda)
    if kernel == "pq_adc_fused":
        lut = torch.tensor(rng.normal(size=(b, 96, 256)),
                           dtype=torch.float32, device=cuda)
        plane = torch.tensor(rng.integers(0, 256, (rows, 96)),
                             dtype=torch.uint8, device=cuda)
        before = adc_ops.launches
        got = adc_ops.pq_adc_fused(lut, plane, ids, live)
        want = adc_ref.pq_adc_fused(lut, plane, ids, live)
        count = adc_ops.launches - before
        tol = dict(rtol=1e-4, atol=1e-4)
    else:
        q = torch.tensor(rng.normal(size=(b, 768)), dtype=torch.float32,
                         device=cuda)
        plane = torch.tensor(rng.integers(0, 256, (rows, 768)),
                             dtype=torch.uint8, device=cuda)
        before = sq8_ops.launches
        got = sq8_ops.sq8_dot_fused(q, plane, ids, live)
        want = sq8_ref.sq8_dot_fused(q, plane, ids, live)
        count = sq8_ops.launches - before
        tol = dict(rtol=1e-4, atol=1e-2)
    torch.cuda.synchronize()
    assert count == 1
    assert torch.equal(torch.isneginf(got), ~live)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    assert int(fin.sum()) == b * live_lanes
    torch.testing.assert_close(got[fin], want[fin], **tol)


# --------------------------------------------------------------------------
# the serving runtime: one captured CUDA graph per bucket
# --------------------------------------------------------------------------

RT_CODECS = ("opq", "pq", "sq8", "refine:sq8:4", "flat")
RT_WAIT = 120                     # seconds any one future may take


@pytest.fixture(scope="module")
def rt_indexes():
    """One sparse index per codec on the card, over one KMeans."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    dev = torch.device("cuda", torch.cuda.current_device())
    c = _build_corpus()
    base = hi.build(0, c.doc_emb, c.doc_tokens, c.vocab_size, codec="opq",
                    device=dev, **BUILD_KW)
    out = {"opq": base}
    for codec in RT_CODECS[1:]:
        out[codec] = hi.build(0, c.doc_emb, c.doc_tokens, c.vocab_size,
                              codec=codec, cluster_sel=base.cluster_sel,
                              doc_assign=base.doc_assign, device=dev,
                              **BUILD_KW)
    return c, out


def _rt_rows_equal(rows, direct):
    """Runtime rows (numpy) against ``Server.query`` rows (card), bit for
    bit."""
    ids, scores, n_cand = (x.cpu().numpy() for x in
                           (direct.doc_ids, direct.scores,
                            direct.n_candidates))
    for i, row in enumerate(rows):
        np.testing.assert_array_equal(row.doc_ids, ids[i])
        np.testing.assert_array_equal(row.scores, scores[i])
        assert int(row.n_candidates) == int(n_cand[i])


def _rt_bucket(rt, c, n):
    """n queries submitted together (the linger holds them) → their rows
    from one batch."""
    futures = [rt.submit(c.query_emb[i], c.query_tokens[i])
               for i in range(n)]
    return [f.result(timeout=RT_WAIT) for f in futures]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("codec", RT_CODECS)
def test_runtime_captures_one_graph_per_bucket_bit_identical(
        rt_indexes, codec, fused):
    """One capture per bucket at warmup and none while serving; every
    bucket's rows equal ``Server.query``'s max_batch rows bit for bit."""
    from repro_torch.core import exec as qexec
    from repro_torch.launch import runtime as rt_mod
    from repro_torch.launch import serve
    c, indexes = rt_indexes
    server = serve.make_server(indexes[codec], serve.ServeConfig(
        kc=6, k2=8, top_r=100, max_batch=16,
        fusion_weight=0.5 if fused else None), device=indexes[codec].device)
    rt = rt_mod.ServingRuntime(server, rt_mod.RuntimeConfig(linger_ms=100.0))
    before = qexec.trace_count()
    rt.warmup(c.query_emb.shape[1], c.query_tokens.shape[1])
    assert qexec.trace_count() - before == len(rt.buckets) == 5
    assert all(p.graph is not None for p in rt._programs.values())
    direct = server.query(c.query_emb[:16], c.query_tokens[:16])
    with rt:
        for b in rt.buckets:
            _rt_rows_equal(_rt_bucket(rt, c, b), direct)
        assert rt.bucket_counts == {b: 1 for b in rt.buckets}
        assert rt.serve_traces == 0
        rt.assert_one_compile_per_bucket()
    assert rt.pool_bytes > 0


def test_runtime_graphs_follow_mutations_and_recapture_on_compact(cuda):
    """On a mutable index: add_docs / delete_docs between batches capture
    nothing and the replayed rows equal ``MutableServer.query``'s;
    ``compact()`` and ``set_fusion_weight`` capture once per bucket."""
    from repro_torch.core import exec as qexec
    from repro_torch.core import segments as seg
    from repro_torch.launch import runtime as rt_mod
    from repro_torch.launch import serve
    c = _build_corpus()
    mut = seg.MutableHybridIndex.create(0, c.doc_emb[:-256],
                                        c.doc_tokens[:-256], c.vocab_size,
                                        device=cuda, **_mutable_kw())
    server = serve.make_mutable_server(mut, serve.ServeConfig(
        kc=6, k2=8, top_r=100, max_batch=8, mutable=True,
        fusion_weight=0.5), device=cuda)
    rt = rt_mod.ServingRuntime(server, rt_mod.RuntimeConfig(linger_ms=50.0))
    rt.warmup(c.query_emb.shape[1], c.query_tokens.shape[1])
    n_buckets = len(rt.buckets)

    def check(n):
        _rt_rows_equal(_rt_bucket(rt, c, n),
                       server.query(c.query_emb[:n], c.query_tokens[:n]))

    with rt:
        check(8)
        before = qexec.trace_count()
        ids = rt.add(c.doc_emb[-256:-128], c.doc_tokens[-256:-128])
        check(8)
        rt.delete(np.r_[ids[:20], 0, 1, 2])
        check(3)
        rt.add(c.doc_emb[-128:], c.doc_tokens[-128:])
        check(1)
        assert qexec.trace_count() == before      # no new capture
        rt.compact()
        assert qexec.trace_count() - before == n_buckets
        check(5)
        rt.set_fusion_weight(0.25)
        assert qexec.trace_count() - before == 2 * n_buckets
        check(8)
        assert rt.serve_traces == 0
        rt.assert_one_compile_per_bucket()


# --------------------------------------------------------------------------
# the width tuner on the card: adaptive graphs, tuned checkpoints
# --------------------------------------------------------------------------

def _two_rung(index, c):
    from repro_torch.core.exec import frontier
    m = frontier.margins(index.cluster_sel.embeddings, c.query_emb)
    return frontier.TunedWidths(
        kc=6, k2=8, refine_mult=None, recall_target=0.9, recall=0.9,
        cost=int(hi.candidate_budget(index, 6, 8)),
        rungs=((2, 4), (6, 8)), margin_cuts=(float(np.median(m)),))


@pytest.mark.parametrize("codec", ["opq", "refine:sq8:4"])
def test_runtime_captures_one_graph_per_bucket_and_rung(rt_indexes, codec):
    """Adaptive serving: one capture per (bucket, rung) at warmup, all in
    the runtime's one pool, none while serving; each row equals the
    direct search at its resolved rung's widths bit for bit; both rungs
    dispatched, and a row cached at one rung never serves the other."""
    from repro_torch.core import exec as qexec
    from repro_torch.core.exec import frontier
    from repro_torch.launch import runtime as rt_mod
    from repro_torch.launch import serve
    c, indexes = rt_indexes
    index = hi.with_tuned(indexes[codec], _two_rung(indexes[codec], c))
    server = serve.make_server(index, serve.ServeConfig(
        top_r=100, max_batch=16, adaptive=True), device=index.device)
    assert server.width_source == "tuned" and len(server.rungs) == 2
    rt = rt_mod.ServingRuntime(server, rt_mod.RuntimeConfig(
        linger_ms=50.0, cache_size=64))
    before = qexec.trace_count()
    rt.warmup(c.query_emb.shape[1], c.query_tokens.shape[1])
    assert qexec.trace_count() - before == 2 * len(rt.buckets) == 10
    assert set(rt._programs) == {(b, r) for b in rt.buckets
                                 for r in range(2)}
    assert all(p.graph is not None for p in rt._programs.values())
    n = len(c.query_emb)
    rung = frontier.resolve_rung(
        frontier.margins(index.cluster_sel.embeddings, c.query_emb[:n]),
        server.margin_cuts)
    with rt:
        rows = _rt_bucket(rt, c, n)
        assert rt.serve_traces == 0
        assert all(v > 0 for v in rt.rung_dispatch.values())
        for r, (kc, k2) in enumerate(server.rungs):
            direct = hi.search(index, c.query_emb[:n], c.query_tokens[:n],
                               kc=kc, k2=k2, top_r=100, device=index.device)
            sel = np.nonzero(rung == r)[0]
            _rt_rows_equal([rows[i] for i in sel],
                           hi.SearchResult(direct.doc_ids[sel],
                                           direct.scores[sel],
                                           direct.n_candidates[sel],
                                           False))
        q0, t0 = c.query_emb[0], c.query_tokens[0].astype(np.int64)
        assert rt._key(q0, t0, None, 0) != rt._key(q0, t0, None, 1)
        hits = rt.cache.hits
        again = rt.submit(q0, t0).result(timeout=RT_WAIT)
        assert rt.cache.hits == hits + 1
        np.testing.assert_array_equal(again.doc_ids, rows[0].doc_ids)
        rt.assert_one_compile_per_bucket()
    assert rt.pool_bytes > 0


def test_tuned_index_saved_from_the_card_loads_back_onto_it(rt_indexes,
                                                            tmp_path):
    """save_index from the card, load_index and restore_index onto it:
    every leaf equal, the tuned record attached, a default-config server
    serving the tuned widths with the rows of the saved index."""
    from repro_torch.launch import serve, tune
    c, indexes = rt_indexes
    index = tune.apply_tuned(indexes["refine:sq8:4"],
                             _two_rung(indexes["refine:sq8:4"], c)
                             ._replace(refine_mult=2))
    assert index.codec == "refine:sq8:2"
    path = ckpt.save_index(str(tmp_path), 0, index)
    for back in (ckpt.load_index(path, device=index.device),
                 ckpt.restore_index(path, index)):
        assert back.tuned == index.tuned and back.codec == index.codec
        for (p, x), (q, y) in zip(hi.index_leaves(back),
                                  hi.index_leaves(index)):
            assert p == q and x.device == y.device and torch.equal(x, y), p
        server = serve.make_server(back, serve.ServeConfig(
            top_r=100, max_batch=16), device=index.device)
        assert (server.kc, server.k2, server.width_source) == (6, 8,
                                                               "tuned")
        got = server.query(c.query_emb[:16], c.query_tokens[:16])
        want = hi.search(index, c.query_emb[:16], c.query_tokens[:16],
                         kc=6, k2=8, top_r=100, device=index.device)
        assert torch.equal(got.doc_ids, want.doc_ids)
        assert torch.equal(got.scores, want.scores)


# --------------------------------------------------------------------------
# sharded and 2-D mesh serving: several mesh positions on one card
# --------------------------------------------------------------------------

#: the score kernel each codec's positions launch (flat has none)
SHARD_KERNELS = {"opq": adc_ops, "pq": adc_ops, "sq8": sq8_ops,
                 "refine:sq8:4": sq8_ops}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("codec", RT_CODECS)
def test_sharded_search_on_the_card_equals_single_device(rt_indexes, codec,
                                                         fused):
    """S = 2 and 4 positions on the card, each in its own thread and
    stream: ids, scores and n_candidates equal the single-device search
    on the card bit for bit, and every position launches topk_scores and
    its codec's score kernel."""
    from repro_torch.core import exec as qexec
    from repro_torch.core import sharded_index as shi
    c, indexes = rt_indexes
    idx = indexes[codec]
    dev = idx.device
    kw = dict(kc=6, k2=8, top_r=100,
              fusion=qexec.FusionSpec(0.5) if fused else None)
    want = hi.search(idx, c.query_emb, c.query_tokens, device=dev, **kw)
    for n in (2, 4):
        mesh = shi.make_shard_mesh(n, devices=[dev] * n)
        sidx = shi.device_put(shi.partition(idx, n), mesh)
        shi.search(sidx, c.query_emb, c.query_tokens, mesh=mesh, **kw)
        topk0 = at_ops.launches
        score = SHARD_KERNELS.get(codec)
        score0 = None if score is None else score.launches
        got = shi.search(sidx, c.query_emb, c.query_tokens, mesh=mesh, **kw)
        torch.cuda.synchronize()
        assert at_ops.launches - topk0 == n
        if score is not None:
            assert score.launches - score0 >= n
        for name in ("doc_ids", "scores", "n_candidates"):
            assert torch.equal(getattr(got, name), getattr(want, name)), (
                n, name)
        mesh.close()


def test_mesh_server_on_the_card_equals_server_and_survives_a_drill(
        rt_indexes, tmp_path):
    """A (2, 2) MeshServer on four positions of the card equals Server bit
    for bit; after ejecting shard 0 it serves partial results from the
    survivors, and a rejoin from its checkpoint restores them exactly."""
    from repro_torch.launch import serve
    c, indexes = rt_indexes
    idx = indexes["opq"]
    dev = idx.device
    cfg = dict(kc=6, k2=8, top_r=100, max_batch=16)
    base = serve.Server(idx, serve.ServeConfig(**cfg), device=dev)
    srv = serve.MeshServer(idx, serve.ServeConfig(
        n_shards=2, data_parallel=2, **cfg), devices=[dev] * 4)
    qe, qt = c.query_emb[:16], c.query_tokens[:16]
    want = base.query(qe, qt)
    full = srv.query(qe, qt)
    for name in ("doc_ids", "scores", "n_candidates"):
        assert torch.equal(getattr(full, name), getattr(want, name)), name
    path = srv.checkpoint(str(tmp_path))
    srv.eject_shard(0)
    deg = srv.query(qe, qt)
    assert deg.partial is True
    lo, hi_ = srv.lost_doc_ranges()[0]
    ids = deg.doc_ids.cpu().numpy()
    assert not ((ids >= lo) & (ids < hi_)).any()
    srv.rejoin(path)
    back = srv.query(qe, qt)
    assert back.partial is False
    for name in ("doc_ids", "scores", "n_candidates"):
        assert torch.equal(getattr(back, name), getattr(full, name)), name
    srv.mesh.close()


@pytest.mark.skipif(torch.cuda.device_count() < 2,
                    reason="needs several cards: one position a card")
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("codec", ["opq", "refine:sq8:4"])
def test_sharded_search_across_cards_equals_single_device(rt_indexes, codec,
                                                          fused):
    """One position a card (the mesh takes the first cards when devices=
    is omitted), so every group spans several cards and its collectives
    take the host-synchronized path with a copy onto the reader's card:
    ids, scores and n_candidates equal the single-device search on the
    first card bit for bit, and every card launches its kernels."""
    from repro_torch.core import exec as qexec
    from repro_torch.core import sharded_index as shi
    c, indexes = rt_indexes
    idx = indexes[codec]
    kw = dict(kc=6, k2=8, top_r=100,
              fusion=qexec.FusionSpec(0.5) if fused else None)
    want = hi.search(idx, c.query_emb, c.query_tokens, device=idx.device,
                     **kw)
    n = min(4, torch.cuda.device_count())
    mesh = shi.make_shard_mesh(n)
    assert [d.index for d in mesh.devices.flat] == list(range(n))
    assert not mesh.group("shards", (0,)).one_card
    sidx = shi.device_put(shi.partition(idx, n), mesh)
    topk0 = at_ops.launches
    got = shi.search(sidx, c.query_emb, c.query_tokens, mesh=mesh, **kw)
    torch.cuda.synchronize()
    assert at_ops.launches - topk0 == n
    assert got.doc_ids.device == mesh.devices.flat[0]
    for name in ("doc_ids", "scores", "n_candidates"):
        assert torch.equal(getattr(got, name).to(idx.device),
                           getattr(want, name)), name
    mesh.close()


@pytest.mark.skipif(torch.cuda.device_count() < 4,
                    reason="needs four cards: one position a card")
def test_mesh_server_across_cards_equals_server(rt_indexes):
    """A (2, 2) MeshServer on the first four cards (make_server places
    them) equals Server bit for bit."""
    from repro_torch.launch import serve
    c, indexes = rt_indexes
    idx = indexes["opq"]
    cfg = dict(kc=6, k2=8, top_r=100, max_batch=16)
    base = serve.Server(idx, serve.ServeConfig(**cfg), device=idx.device)
    srv = serve.make_server(idx, serve.ServeConfig(
        n_shards=2, data_parallel=2, **cfg))
    assert [d.index for d in srv.mesh.devices.flat] == [0, 1, 2, 3]
    qe, qt = c.query_emb[:16], c.query_tokens[:16]
    want = base.query(qe, qt)
    got = srv.query(qe, qt)
    for name in ("doc_ids", "scores", "n_candidates"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    srv.mesh.close()


# --------------------------------------------------------------------------
# the runtime over a mesh and the sharded mutable index, positions on the
# card: one CUDA graph per bucket per mesh
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("geometry", [(1, 4), (2, 2)],
                         ids=["sharded4", "mesh2x2"])
def test_runtime_over_a_mesh_captures_one_graph_per_bucket(rt_indexes,
                                                           geometry, fused):
    """ShardedServer (S = 4) and a (2, 2) MeshServer on four positions of
    the card behind the runtime: one capture per bucket of the quantum
    ladder (the graph spans every position's stream), none while
    serving, every bucket's rows equal ``server.query``'s bit for bit,
    every replica dispatched; a replay launches no wrapper."""
    from repro_torch.core import exec as qexec
    from repro_torch.launch import runtime as rt_mod
    from repro_torch.launch import serve
    c, indexes = rt_indexes
    idx = indexes["opq"]
    dev = idx.device
    d, m = geometry
    cfg = serve.ServeConfig(kc=6, k2=8, top_r=100, max_batch=16,
                            n_shards=m, data_parallel=d,
                            fusion_weight=0.5 if fused else None)
    server = (serve.MeshServer(idx, cfg, devices=[dev] * 4) if d > 1 else
              serve.ShardedServer(idx, cfg, devices=[dev] * 4))
    assert server.mesh.one_card and rt_mod.captures(server)
    rt = rt_mod.ServingRuntime(server, rt_mod.RuntimeConfig(linger_ms=100.0))
    before = qexec.trace_count()
    rt.warmup(c.query_emb.shape[1], c.query_tokens.shape[1])
    assert rt.buckets == rt_mod.bucket_sizes(16, quantum=d)
    assert qexec.trace_count() - before == len(rt.buckets)
    assert all(rt.stats()["captured"].values())
    direct = server.query(c.query_emb[:16], c.query_tokens[:16])
    with rt:
        for b in rt.buckets:
            rows = _rt_bucket(rt, c, b)
            _rt_rows_equal(rows, server.query(c.query_emb[:b],
                                              c.query_tokens[:b]))
            _rt_rows_equal(rows, direct)
        assert rt.bucket_counts == {b: 1 for b in rt.buckets}
        topk0 = at_ops.launches
        rt._programs[16]([c.query_emb[:16],
                          c.query_tokens[:16].astype(np.int64)])
        assert at_ops.launches == topk0          # the graph, no wrapper
        rt.assert_one_compile_per_bucket()
    assert all(n > 0 for n in rt.stats()["replica_dispatch"].values())
    server.mesh.close()


def test_runtime_over_a_degraded_mesh_flags_every_row_partial(rt_indexes,
                                                              tmp_path):
    """The (2, 2) drill through the runtime: after ejecting shard 1 a
    new runtime captures the survivors' mesh, and every row is partial
    and equal to the degraded ``query``'s."""
    from repro_torch.launch import runtime as rt_mod
    from repro_torch.launch import serve
    c, indexes = rt_indexes
    idx = indexes["opq"]
    dev = idx.device
    server = serve.MeshServer(idx, serve.ServeConfig(
        kc=6, k2=8, top_r=100, max_batch=16, n_shards=2, data_parallel=2),
        devices=[dev] * 4)
    server.eject_shard(1)
    want = server.query(c.query_emb[:16], c.query_tokens[:16])
    with rt_mod.ServingRuntime(server, rt_mod.RuntimeConfig(
            linger_ms=100.0)) as rt:
        rt.warmup(c.query_emb.shape[1], c.query_tokens.shape[1])
        assert all(rt.stats()["captured"].values())
        got = rt.query(c.query_emb[:16], c.query_tokens[:16], timeout=RT_WAIT)
    assert got.partial is True and want.partial is True
    np.testing.assert_array_equal(got.doc_ids, want.doc_ids.cpu().numpy())
    np.testing.assert_array_equal(got.scores, want.scores.cpu().numpy())
    server.mesh.close()


@pytest.mark.parametrize("geometry", [(1, 4), (2, 2)],
                         ids=["sharded4", "mesh2x2"])
def test_sharded_mutable_runtime_follows_mutations_on_the_card(cuda,
                                                               geometry):
    """ShardedMutableServer on four positions of the card: its search
    equals the single-device mutable search bit for bit, dense and
    fused; behind the runtime ``add``/``delete`` capture nothing and the
    replayed rows equal ``query``'s, ``compact()`` captures once per
    bucket."""
    from repro_torch.core import exec as qexec
    from repro_torch.core import segments as seg
    from repro_torch.launch import runtime as rt_mod
    from repro_torch.launch import serve
    c = _build_corpus()
    mut = seg.MutableHybridIndex.create(0, c.doc_emb[:-256],
                                        c.doc_tokens[:-256], c.vocab_size,
                                        device=cuda, **_mutable_kw())
    d, m = geometry
    server = serve.ShardedMutableServer(mut, serve.ServeConfig(
        kc=6, k2=8, top_r=100, max_batch=8, mutable=True, n_shards=m,
        data_parallel=d), devices=[cuda] * 4)
    qe, qt = c.query_emb[:8], c.query_tokens[:8]

    def single(fusion=None):
        return mut.search(qe, qt, kc=6, k2=8, top_r=100, fusion=fusion)

    rt = rt_mod.ServingRuntime(server, rt_mod.RuntimeConfig(linger_ms=50.0))
    rt.warmup(c.query_emb.shape[1], c.query_tokens.shape[1])
    assert all(rt.stats()["captured"].values())

    def check(n):
        _rt_rows_equal(_rt_bucket(rt, c, n),
                       server.query(c.query_emb[:n], c.query_tokens[:n]))

    with rt:
        check(8)
        before = qexec.trace_count()
        ids = rt.add(c.doc_emb[-256:-128], c.doc_tokens[-256:-128])
        assert set(server.mut.owning_shard(ids).tolist()) <= set(range(m))
        check(8)
        rt.delete(np.r_[ids[:20], 0, 1, 2])
        check(3)
        rt.add(c.doc_emb[-128:], c.doc_tokens[-128:])
        check(1)
        assert qexec.trace_count() == before      # no new capture
        for f in (None, qexec.FusionSpec(0.5)):
            got = server.mut.search(qe, qt, kc=6, k2=8, top_r=100, fusion=f)
            want = single(f)
            for name in ("doc_ids", "scores", "n_candidates"):
                assert torch.equal(getattr(got, name),
                                   getattr(want, name)), (f, name)
        rt.compact()
        assert qexec.trace_count() - before == len(rt.buckets)
        check(8)
        rt.assert_one_compile_per_bucket()
    server.mesh.close()


@pytest.mark.skipif(torch.cuda.device_count() < 4,
                    reason="needs four cards: one position a card")
def test_runtime_over_a_mesh_across_cards_runs_eagerly(rt_indexes):
    """A (2, 2) MeshServer on the first four cards: the runtime builds one
    eager program per bucket (no capture across cards) and its rows
    equal ``query``'s bit for bit."""
    from repro_torch.launch import runtime as rt_mod
    from repro_torch.launch import serve
    c, indexes = rt_indexes
    idx = indexes["opq"]
    srv = serve.make_server(idx, serve.ServeConfig(
        kc=6, k2=8, top_r=100, max_batch=16, n_shards=2, data_parallel=2))
    assert not srv.mesh.one_card and not rt_mod.captures(srv)
    with rt_mod.ServingRuntime(srv, rt_mod.RuntimeConfig(
            linger_ms=100.0)) as rt:
        rt.warmup(c.query_emb.shape[1], c.query_tokens.shape[1])
        assert not any(rt.stats()["captured"].values())
        for b in rt.buckets:
            _rt_rows_equal(_rt_bucket(rt, c, b),
                           srv.query(c.query_emb[:b], c.query_tokens[:b]))
        rt.assert_one_compile_per_bucket()
    srv.mesh.close()


# --------------------------------------------------------------------------
# build and training over a mesh: the all-reduce and the sharded KMeans
# --------------------------------------------------------------------------

def _allreduce_body(mesh, inputs):
    """Every collective of the training mesh at one position of a (pod 2,
    data 2) mesh: flat and hierarchical all-reduce, tiled psum_scatter
    and all_gather, pmean_metrics."""
    from repro_torch.distributed import collectives

    def body(coord):
        pos = mesh.position(coord)
        t = inputs[mesh.rank(("pod", "data"), coord)]
        part = pos.psum_scatter(t["w"], "data")
        return {"flat": collectives.flat_allreduce(t, ("pod", "data"),
                                                   pos=pos),
                "hier": collectives.hierarchical_allreduce(t, pos=pos),
                "scatter": part, "gather": pos.all_gather(part, "data"),
                "mean": collectives.pmean_metrics({"m": t["b"][0]},
                                                  ("pod", "data"), pos=pos)}
    return body


def _grad_inputs(seed: int, dev) -> list:
    rng = np.random.default_rng(seed)
    return [{"w": torch.from_numpy(rng.standard_normal((16, 8)).astype(
                 np.float32)).to(dev),
             "b": torch.from_numpy(rng.standard_normal(5).astype(
                 np.float32)).to(dev)} for _ in range(4)]


def test_allreduce_on_one_card_equals_the_cpu_and_replays(cuda):
    """Four positions of a (2, 2) mesh on the card: flat and hierarchical
    all-reduce, the tiled collectives and pmean_metrics give every
    position the bits of the same run on CPU positions (the same IEEE
    adds in the same order); captured in a CUDA graph around
    ``Mesh.run``, a replay on new inputs equals an eager run on them."""
    from repro_torch import tree as tree_mod
    from repro_torch.distributed import collectives
    cpu_mesh = collectives.Mesh([["cpu"] * 2] * 2, ("pod", "data"))
    mesh = collectives.Mesh([[cuda] * 2] * 2, ("pod", "data"))
    assert mesh.one_card
    want = cpu_mesh.run(_allreduce_body(cpu_mesh, _grad_inputs(0, "cpu")))
    static = _grad_inputs(0, cuda)
    body = _allreduce_body(mesh, static)
    got = mesh.run(body)
    torch.cuda.synchronize()
    for coord in mesh.positions():
        for a, b in zip(tree_mod.leaves(got[coord]),
                        tree_mod.leaves(want[coord])):
            assert torch.equal(a.cpu(), b)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        mesh.run(body)
    torch.cuda.current_stream(cuda).wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = mesh.run(body)
    fresh = _grad_inputs(1, cuda)
    for s, f in zip(static, fresh):
        for k in s:
            s[k].copy_(f[k])
    graph.replay()
    torch.cuda.synchronize()
    eager = mesh.run(_allreduce_body(mesh, fresh))
    torch.cuda.synchronize()
    for coord in mesh.positions():
        for a, b in zip(tree_mod.leaves(captured[coord]),
                        tree_mod.leaves(eager[coord])):
            assert torch.equal(a, b)
    mesh.close()
    cpu_mesh.close()


def test_kmeans_fit_sharded_on_the_card_agrees_on_every_position(cuda):
    """Four positions of the card over 4 × 2,048 points: one
    ``assign_argmax`` launch a position a step, every position the same
    centroids bit for bit, the cost below the random init's; one step
    from shared centroids: the card's psummed counts equal the CPU's."""
    from repro_torch.core import kmeans
    from repro_torch.distributed import collectives
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((8192, 32), generator=gen, device=cuda)
    mesh = collectives.Mesh([cuda] * 4, ("data",))
    parts = collectives.Split(mesh, "data").place(x)
    before = at_ops.assign_launches
    outs = mesh.run(lambda coord: kmeans.kmeans_fit_sharded(
        3, parts[coord], 64, n_iters=5, pos=mesh.position(coord)))
    torch.cuda.synchronize()
    assert at_ops.assign_launches - before == 4 * 5
    c = outs[(0,)]
    assert all(torch.equal(o, c) for o in outs.values())
    cost = kmeans.kmeans_cost(x, c, kmeans.assign_blocked(x, c))
    c0 = x[:64]
    assert cost < kmeans.kmeans_cost(x, c0, kmeans.assign_blocked(x, c0))
    step = mesh.run(lambda coord: kmeans.sharded_step(
        parts[coord], c, 64, "data", pos=mesh.position(coord)))
    cpu_mesh = collectives.Mesh(["cpu"] * 4, ("data",))
    cparts = collectives.Split(cpu_mesh, "data").place(x.cpu())
    want = cpu_mesh.run(lambda coord: kmeans.sharded_step(
        cparts[coord], c.cpu(), 64, "data", pos=cpu_mesh.position(coord)))
    torch.cuda.synchronize()
    assert torch.equal(step[(0,)][1].cpu(), want[(0,)][1])
    torch.testing.assert_close(step[(0,)][0].cpu(), want[(0,)][0],
                               rtol=1e-5, atol=1e-5)
    mesh.close()
    cpu_mesh.close()


def test_compression_and_pmean_on_the_card_equal_the_cpu(cuda):
    """50 steps of ``compress_with_ef`` on the card bitwise equal to the
    CPU (the scale divides by a tensor: CUDA multiplies by the reciprocal
    of a Python scalar divisor), and ``pmean`` over three positions (no
    power of two) the same bits on the card as on the CPU."""
    from repro_torch import tree as tree_mod
    from repro_torch.distributed import collectives
    from repro_torch.optim import compression
    rng = np.random.default_rng(5)
    g = [{"w": torch.from_numpy(rng.standard_normal((64, 33)).astype(
             np.float32) * 10 ** -i), "b": torch.from_numpy(
             rng.standard_normal(7).astype(np.float32))} for i in range(3)]
    trees = {"cpu": g, "cuda": [tree_mod.to(t, cuda) for t in g]}
    ef = {k: compression.ef_init(v[0]) for k, v in trees.items()}
    for step in range(50):
        out = {}
        for k, v in trees.items():
            comp, ef[k] = compression.compress_with_ef(v[step % 3], ef[k])
            out[k] = tree_mod.leaves(compression.decompress(comp)) + \
                tree_mod.leaves(ef[k]) + [comp["w"].scale, comp["w"].q]
        for a, b in zip(out["cuda"], out["cpu"]):
            assert torch.equal(a.cpu(), b), step
    means = {}
    for k, v in trees.items():
        mesh = collectives.Mesh([cuda if k == "cuda" else "cpu"] * 3,
                                ("data",))
        res = mesh.run(lambda coord: mesh.position(coord).pmean(
            v[coord[0]]["w"], "data"))
        means[k] = [res[(i,)].cpu() for i in range(3)]
        mesh.close()
    for a in means["cuda"] + means["cpu"]:
        assert torch.equal(a, means["cpu"][0])



# --------------------------------------------------------------------------
# training cells on the card: the recsys losses and GatedGCN
# --------------------------------------------------------------------------

CELL_TOL = dict(rtol=1e-4, atol=1e-4)
#: a first AdamW step at lr 1e-4 moves a parameter by about 1e-4: the
#: step is held by its update (new − old) and its first moment
STEP_TOL = dict(rtol=1e-3, atol=1e-6)
MOMENT_TOL = dict(rtol=1e-4, atol=1e-6)
#: seconds the partitioned step may take before it counts as a hang
PARTITION_TIMEOUT_S = 120


def _trees_close(got, want, what: str, tol=CELL_TOL) -> None:
    from repro_torch import tree as tree_mod
    for (path, a), (_, b) in zip(tree_mod.leaves_with_paths(got),
                                 tree_mod.leaves_with_paths(want)):
        torch.testing.assert_close(a.cpu(), b, msg=f"{what} {path}", **tol)


def _step_on_both(cuda, loss, cfg, params, batch):
    """One cell step on the card and on the CPU from the same parameters
    and batch → ((params, state, metrics) card, the same CPU)."""
    from repro_torch import optim
    from repro_torch import tree as tree_mod
    from repro_torch.launch import train
    out = []
    for dev in (cuda, torch.device("cpu")):
        p = tree_mod.map(torch.clone, tree_mod.to(params, dev))  # in place
        out.append(train.cell_step(loss, cfg, p, optim.adam_init(p),
                                   tree_mod.to(batch, dev)))
    return out


def _check_step(card, cpu, params, what: str) -> None:
    """Loss and grad norm within CELL_TOL; each parameter's update from
    ``params`` within STEP_TOL, the first moment within MOMENT_TOL."""
    from repro_torch import tree as tree_mod
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(card[2][key].cpu(), cpu[2][key],
                                   msg=f"{what} {key}", **CELL_TOL)
    _trees_close(tree_mod.map(lambda a, p: a.cpu() - p, card[0], params),
                 tree_mod.map(torch.sub, cpu[0], params),
                 f"{what} update", STEP_TOL)
    _trees_close(card[1].mu, cpu[1].mu, f"{what} first moment",
                 MOMENT_TOL)


@pytest.mark.parametrize("arch", ["dlrm-rm2", "sasrec", "dien", "mind"])
def test_recsys_cell_step_on_the_card_matches_the_cpu(cuda, arch):
    """One training-cell step (value and grad, clip 1.0, AdamW) of each
    recsys arch at its reduced config, B 64: loss and grad norm within
    1e-4 of the CPU, the update and first moment as ``_check_step``
    holds them; SASRec's forward launches
    ``flash_attention`` once a block."""
    from repro_torch.configs import registry
    from repro_torch.data import recsys as rdata
    from repro_torch.models import recsys
    cfg = registry.get(arch).make_reduced()
    params = recsys.INITS[arch](torch.Generator().manual_seed(3), cfg)
    kw = (dict(n_sparse=cfg.n_sparse, n_rows=cfg.n_rows)
          if arch == "dlrm-rm2" else dict(seq_len=cfg.seq_len,
                                          n_items=cfg.n_items))
    gen = {"dlrm-rm2": rdata.dlrm_batch, "sasrec": rdata.sasrec_batch,
           "dien": rdata.dien_batch, "mind": rdata.mind_batch}[arch]
    batch = gen(5, 64, **kw, device="cpu")
    before = fa_ops.launches
    card, cpu = _step_on_both(cuda, recsys.LOSSES[arch], cfg, params, batch)
    if arch == "sasrec":
        assert fa_ops.launches - before == cfg.n_blocks
    _check_step(card, cpu, params, arch)


def _gnn_case(kind: str):
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.data import graph
    from repro_torch.models import gnn
    cfg = dataclasses.replace(registry.get("gatedgcn").make_reduced(),
                              remat=True)
    if kind == "molecule":
        return (gnn.GatedGCNConfig(n_layers=3, d_hidden=16, d_feat=16,
                                   n_classes=10, graph_level=True),
                graph.molecule_batch(0, 8, 30, 64, 16, 10, device="cpu"))
    g = graph.random_graph(0, 300, 1200, cfg.d_feat, cfg.n_classes,
                           device="cpu")
    if kind == "minibatch":
        g = graph.NeighborSampler(300, g.edge_src, g.edge_dst).sample(
            1, np.arange(32), (5, 3), g.node_feat, g.labels, device="cpu")
    return cfg, g


@pytest.mark.parametrize("kind", ["full", "molecule", "minibatch"])
def test_gnn_cell_step_on_the_card_matches_the_cpu(cuda, kind):
    """One GatedGCN cell step (remat on) on a full graph, a molecule
    batch and a sampled minibatch against the CPU (``_check_step``)."""
    from repro_torch.models import gnn
    cfg, g = _gnn_case(kind)
    params = gnn.init(torch.Generator().manual_seed(1), cfg)
    card, cpu = _step_on_both(cuda, gnn.loss_fn, cfg, params, g)
    _check_step(card, cpu, params, kind)


@pytest.mark.parametrize("positions", [2, 4])
def test_partitioned_gradient_on_positions_of_the_card(cuda, positions):
    """loss_fn_partitioned over 2 and 4 positions of the one card (remat
    on, so backward recomputes each layer): its loss within 1e-5 of
    loss_fn's on the card, every gradient within 1e-4, and no hang (a
    backward node that waited for the other positions would block the
    device's one autograd thread: the step must end within
    PARTITION_TIMEOUT_S)."""
    import threading
    from repro_torch import optim
    from repro_torch import tree as tree_mod
    from repro_torch.data import graph
    from repro_torch.distributed import collectives
    from repro_torch.models import gnn
    cfg, g = _gnn_case("full")
    params = tree_mod.to(gnn.init(torch.Generator().manual_seed(2), cfg),
                         cuda)
    g = tree_mod.to(g, cuda)
    (want, _), wgrads = optim.value_and_grad(gnn.loss_fn, params, cfg, g,
                                             has_aux=True)
    mesh = collectives.Mesh([cuda] * positions, ("data",))
    gp = graph.partition_by_dst(g, positions)
    box = {}

    def run():
        torch.cuda.set_device(cuda)
        try:
            box["out"] = optim.value_and_grad(
                lambda p, b: gnn.loss_fn_partitioned(p, cfg, b, mesh),
                params, gp, has_aux=True)
            torch.cuda.synchronize(cuda)
        except BaseException as e:      # noqa: BLE001 — re-raised below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(PARTITION_TIMEOUT_S)
    assert not t.is_alive(), "the partitioned step hung"
    if "err" in box:
        raise box["err"]
    (loss, _), grads = box["out"]
    mesh.close()
    torch.testing.assert_close(loss.cpu(), want.cpu(), rtol=1e-5, atol=0)
    _trees_close(grads, tree_mod.to(wgrads, "cpu"), "partitioned grads")


# --------------------------------------------------------------------------
# the dense LM family: decode and a training step at full width
# --------------------------------------------------------------------------

def _lm_case(arch: str, **kw):
    """(cfg, CPU params) of ``arch``'s config with ``kw`` replaced, f32."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(registry.get(arch).make_reduced(), **kw)
    return cfg, tfm.init(torch.Generator().manual_seed(5), cfg)


@pytest.mark.parametrize("window", [0, 4])
def test_lm_decode_step_and_serve_step_on_the_card_match_the_cpu(cuda,
                                                                  window):
    """One layer's ``decode_step`` on a partly filled cache, then 10
    ``serve_step`` calls (past a 4-slot window) after a ``prefill_step``,
    on the card and on the CPU: outputs and caches within 1e-4,
    ``cache_pos`` equal, one flash launch a prefilled layer and none a
    decode step."""
    from repro_torch import tree as tree_mod
    from repro_torch.models import attention, transformer as tfm
    cfg, params = _lm_case("llama3-8b", window=window)
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(2, 1, cfg.d_model, generator=gen)
    cache = attention.init_cache(2, cfg.n_kv_heads, 6, cfg.head_dim,
                                 torch.float32)
    cache.k.normal_(generator=gen)
    cache.v.normal_(generator=gen)
    cache.cache_pos[:4] = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    lp = tree_mod.index(params["layers"], 0)["attn"]
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              d_head=cfg.head_dim, window=window)
    outs = [attention.decode_step(tree_mod.to(lp, dev),
                                  tree_mod.to(cache, dev), x.to(dev),
                                  torch.tensor(4, device=dev), **kw)
            for dev in (cuda, torch.device("cpu"))]
    torch.testing.assert_close(outs[0][0].cpu(), outs[1][0], **CELL_TOL)
    torch.testing.assert_close(outs[0][1].k.cpu(), outs[1][1].k, **CELL_TOL)
    assert torch.equal(outs[0][1].cache_pos.cpu(), outs[1][1].cache_pos)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    got = []
    for dev in (cuda, torch.device("cpu")):
        p = tree_mod.to(params, dev)
        before = fa_ops.launches
        logits, caches = tfm.prefill_step(p, cfg, tokens[:, :6].to(dev))
        steps = [logits]
        for i in range(6, 16):
            logits, caches = tfm.serve_step(p, cfg, caches,
                                            tokens[:, i:i + 1].to(dev), i)
            steps.append(logits)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert fa_ops.launches - before == cfg.n_layers
        got.append((steps, caches))
    for a, b in zip(got[0][0], got[1][0]):
        torch.testing.assert_close(a.cpu(), b, **CELL_TOL)
    card, cpu = got[0][1], got[1][1]
    torch.testing.assert_close(card.k.cpu(), cpu.k, **CELL_TOL)
    torch.testing.assert_close(card.v.cpu(), cpu.v, **CELL_TOL)
    assert torch.equal(card.cache_pos.cpu(), cpu.cache_pos)


def test_lm_cell_step_at_full_width_on_the_card_matches_the_cpu(cuda):
    """One training-cell step of internlm2-1.8b at full width, 2 layers,
    f32, B 1 × S 64 (remat on), on the card and on the CPU: loss and
    grad norm within 1e-4, every updated leaf within 1e-4, each Adam
    moment leaf within 1% of the CPU's in norm, and each leaf's update
    within rtol 1e-4, atol 1e-6 of AdamW's formula over the card's own
    moments (an update is not held against the CPU's elementwise: where a
    gradient is near eps its rounding becomes up to lr of update); the
    step launches ``flash_attention`` twice a layer (forward and
    recompute).  The step runs in place and gives ``train_step``'s
    bits."""
    import dataclasses
    from repro_torch import optim
    from repro_torch import tree as tree_mod
    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(registry.get("internlm2-1.8b").make_config(),
                              n_layers=2, compute_dtype=torch.float32)
    params = tfm.init(torch.Generator(device=cuda).manual_seed(7), cfg)
    ids = torch.randint(0, cfg.vocab_size, (1, 65), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(8))
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    cpu_params = tree_mod.to(params, "cpu")
    before = fa_ops.launches
    stepped = tree_mod.map(torch.clone, params)
    new, state, m = train.cell_step(tfm.cell_loss, cfg, stepped,
                                    optim.adam_init(stepped), batch)
    torch.cuda.synchronize()
    assert fa_ops.launches - before == 2 * cfg.n_layers
    cnew, cstate, cm = train.cell_step(tfm.cell_loss, cfg, cpu_params,
                                       optim.adam_init(cpu_params),
                                       tree_mod.to(batch, "cpu"))
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(m[key].cpu(), cm[key], **CELL_TOL)
    a = train.CELL_ADAM
    for (path, got), (_, want), (_, old), (_, mu), (_, nu), (_, cmu), (
            _, cnu) in zip(*(tree_mod.leaves_with_paths(t) for t in (
                new, cnew, params, state.mu, state.nu, cstate.mu,
                cstate.nu))):
        torch.testing.assert_close(got.cpu(), want, msg=path, **CELL_TOL)
        for mine, theirs in ((mu, cmu), (nu, cnu)):
            theirs = theirs.to(cuda).double()
            rel = float((mine.double() - theirs).norm() / theirs.norm())
            assert rel <= 1e-2, (path, rel)
        formula = -a.lr * (mu.double() / (1 - a.b1)) / (
            (nu.double() / (1 - a.b2)).sqrt() + a.eps)
        torch.testing.assert_close(got - old, formula.float(), rtol=1e-4,
                                   atol=1e-6, msg=path)
    dnew, dstate, _, gnorm = train.train_step(
        lambda p, b: tfm.cell_loss(p, cfg, b), params,
        optim.adam_init(params), batch, 1.0, train.CELL_ADAM,
        train.CELL_CLIP)
    assert float(gnorm) == float(m["grad_norm"])
    for x, y in zip(tree_mod.leaves((dnew, dstate.mu, dstate.nu)),
                    tree_mod.leaves((new, state.mu, state.nu))):
        assert torch.equal(x, y)


# --------------------------------------------------------------------------
# the MoE layer and the MoE LMs
# --------------------------------------------------------------------------

def _moe_layer_case(dev, n_tokens: int = 512, seed: int = 11):
    """OLMoE's layer width (d 2,048, d_ff 1,024, 64 experts top-8) in
    f32: parameters, rows and a cotangent from one CPU generator, on
    ``dev``."""
    from repro_torch import tree as tree_mod
    from repro_torch.models import moe
    gen = torch.Generator().manual_seed(seed)
    params = moe.init(gen, 2048, 1024, 64)
    # a shared offset skews the load, so capacity factor 1.25 drops
    x = (torch.randn(2, n_tokens // 2, 2048, generator=gen)
         + torch.randn(2048, generator=gen))
    g = torch.randn(2, n_tokens // 2, 2048, generator=gen) / n_tokens
    return (tree_mod.to(params, dev), x.to(dev), g.to(dev))


def _moe_run(params, x, g, cf: float = 1.25):
    """forward and the gradients of Σ out·g + aux → (out, aux, dropped,
    dx, parameter grads, the route)."""
    from repro_torch import tree as tree_mod
    from repro_torch.models import moe
    p = tree_mod.map(lambda t: t.detach().clone().requires_grad_(True),
                     params)
    xx = x.clone().requires_grad_(True)
    with moe.record_routes() as routes:
        out, st = moe.forward(p, xx, n_experts=64, top_k=8,
                              capacity_factor=cf)
    (torch.sum(out * g) + st.aux_loss).backward()
    return (out.detach(), st.aux_loss.detach(), st.dropped_frac, xx.grad,
            [t.grad for t in tree_mod.leaves(p)], routes[0])


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_layer_on_the_card_routes_and_matches_the_cpu(cuda, cf):
    """Routes first (expert ids, positions, kept equal; a token whose
    experts differ must be a near tie, router logits within 1e-5 at the
    cut), then outputs, aux, dropped and every gradient within 1e-4."""
    card = _moe_run(*_moe_layer_case(cuda), cf=cf)
    cpu = _moe_run(*_moe_layer_case(torch.device("cpu")), cf=cf)
    route, want = card[5], cpu[5]
    same = ((route.expert.cpu() == want.expert).all(1)
            & (route.position.cpu() == want.position).all(1)
            & (route.kept.cpu() == want.kept).all(1))
    if not bool(same.all()):
        top = torch.sort(want.logits, -1, descending=True).values
        gap = (top[:, 7] - top[:, 8]).abs() / top[:, 7].abs()
        assert bool((gap[~same] <= 1e-5).all()), gap[~same]
        pytest.skip(f"near ties at tokens {torch.nonzero(~same)[:, 0]}")
    assert (float(cpu[2]) > 0) == (cf == 1.25)
    assert float(card[2].cpu()) == float(cpu[2])
    for name, a, b in [("out", card[0], cpu[0]), ("aux", card[1], cpu[1]),
                       ("dx", card[3], cpu[3])] + [
            (f"grad {i}", a, b) for i, (a, b) in enumerate(zip(card[4],
                                                                cpu[4]))]:
        torch.testing.assert_close(a.cpu(), b, msg=name, **CELL_TOL)


def test_moe_layer_forward_and_backward_repeat_bit_for_bit(cuda):
    """Two forward and backward runs at bf16 compute (where router
    logits tie often) on the card: routes, outputs, aux and every
    gradient the same bits."""
    params, x, g = _moe_layer_case(cuda, n_tokens=2048)
    x = x.bfloat16()
    runs = [_moe_run(params, x, g.bfloat16()) for _ in range(2)]
    for a, b in zip(runs[0][5][:4], runs[1][5][:4]):
        assert torch.equal(a, b)
    for i, (a, b) in enumerate(zip(
            [runs[0][0], runs[0][1], runs[0][3]] + runs[0][4],
            [runs[1][0], runs[1][1], runs[1][3]] + runs[1][4])):
        assert torch.equal(a, b), i


def test_moe_remat_step_on_the_card_equals_a_step_without_remat(cuda):
    """olmoe-1b-7b at full width, 2 layers, bf16 compute, B 1 × S 256:
    under remat each MoE layer's recompute routes as its forward did
    (the routes of both runs equal), so the gradients equal those of a
    step without remat bit for bit."""
    import dataclasses
    from repro_torch import optim
    from repro_torch.configs import registry
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(registry.get("olmoe-1b-7b").make_config(),
                              n_layers=2)
    params = tfm.init(torch.Generator(device=cuda).manual_seed(12), cfg)
    ids = torch.randint(0, cfg.vocab_size, (1, 257), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(13))
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        with moe.record_routes() as routes:
            (loss, _), grads = optim.value_and_grad(
                tfm.cell_loss, params, c, batch, has_aux=True)
        out[remat] = (loss, grads, routes)
    routes = out[True][2]
    assert len(routes) == 2 * cfg.n_layers
    for a, b in zip(routes[:2], routes[2:][::-1]):
        for x, y in zip(a[:4], b[:4]):
            assert torch.equal(x, y)
    for a, b in zip(routes[:2], out[False][2]):
        assert torch.equal(a.expert, b.expert)
    assert torch.equal(out[True][0], out[False][0])
    from repro_torch import tree as tree_mod
    for (path, a), (_, b) in zip(tree_mod.leaves_with_paths(out[True][1]),
                                 tree_mod.leaves_with_paths(out[False][1])):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x22b"])
def test_moe_serve_step_on_the_card_matches_the_cpu(cuda, arch):
    """The reduced MoE config (f32): ``prefill_step`` over 6 tokens, then
    10 ``serve_step`` calls (each routes B = 2 tokens at capacity 1, so
    assignments drop; Mixtral's window of 8 rolls) on the card and on
    the CPU: every call's routes equal, logits and caches within 1e-4,
    ``cache_pos`` equal."""
    from repro_torch import tree as tree_mod
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    cfg, params = _lm_case(arch)
    gen = torch.Generator().manual_seed(14)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    got = []
    for dev in (cuda, torch.device("cpu")):
        p = tree_mod.to(params, dev)
        with moe.record_routes() as routes:
            logits, caches = tfm.prefill_step(p, cfg,
                                              tokens[:, :6].to(dev))
            steps = [logits]
            for i in range(6, 16):
                logits, caches = tfm.serve_step(p, cfg, caches,
                                                tokens[:, i:i + 1].to(dev),
                                                i)
                steps.append(logits)
        got.append((steps, caches, routes))
    (card, ccache, croutes), (cpu, pcache, proutes) = got
    assert len(croutes) == len(proutes) == 11 * cfg.n_layers
    assert any(not bool(r.kept.all()) for r in proutes[cfg.n_layers:])
    for a, b in zip(croutes, proutes):
        for x, y in zip(a[:3], b[:3]):
            assert torch.equal(x.cpu(), y)
    for a, b in zip(card, cpu):
        torch.testing.assert_close(a.cpu(), b, **CELL_TOL)
    torch.testing.assert_close(ccache.k.cpu(), pcache.k, **CELL_TOL)
    torch.testing.assert_close(ccache.v.cpu(), pcache.v, **CELL_TOL)
    assert torch.equal(ccache.cache_pos.cpu(), pcache.cache_pos)

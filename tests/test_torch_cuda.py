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
    # name: (n, l, h, k, duplicated centroid rows, elements off alignment)
    "ties": (33, 300, 32, 12, True, 0),
    "ragged_tiles": (17, 129, 40, 8, True, 0),
    "k_max": (3, 2000, 96, at_ops.MAX_K, False, 0),
    "many_slices": (300, 5000, 64, 30, False, 0),
    "served": (256, 10_000, 768, 30, False, 0),
    "h37_elementwise": (40, 1000, 37, 30, False, 0),
    "misaligned_view": (64, 3000, 768, 30, False, 1),
    "n33_ragged_query_tile": (33, 2000, 768, 30, False, 0),
    "ties_k128": (20, 1000, 64, 128, True, 0),
}


@pytest.mark.parametrize("name", sorted(TOPK_CASES))
def test_topk_scores_kernel_matches_plain(cuda, name):
    """h = 37 and a contiguous view one element past a 16-byte boundary
    take the kernel's element-wise copies, the rest the 16-byte ones."""
    n, l, h, k, ties, offset = TOPK_CASES[name]
    rng = np.random.default_rng(n + l)
    x = rng.normal(size=(n, h))
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    emb = rng.normal(size=(l, h))
    if ties:
        emb = np.concatenate([emb[: (l + 1) // 2]] * 2)[:l]
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
    (occupancy API: 146 KB of shared memory), and the served shape's
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
}


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
    assert fa_ops.vector_loads(q, k, v) is (offset == 0)
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

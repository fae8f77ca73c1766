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
2e-2 in bf16 (one bf16 rounding of the output).
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import hybrid_index as hi
from repro_torch.core import inverted_lists as il
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


ADC_CASES = {
    # name: (b, c, m, k, code dtype, duplicate ids, masked row)
    "c_ragged": (2, 8192 + 77, 96, 256, np.uint8, False, None),
    "c_below_tile": (3, 5, 8, 128, np.uint8, False, 1),
    "int32_dup_masked": (2, 600, 8, 512, np.int32, True, 0),
    "scalar_rows": (2, 333, 3, 64, np.uint8, True, 1),
}


@pytest.mark.parametrize("name", sorted(ADC_CASES))
def test_pq_adc_fused_kernel_matches_plain(cuda, name):
    b, c, m, k, dtype, dup, mask_row = ADC_CASES[name]
    rng = np.random.default_rng(len(name))
    lut = torch.tensor(rng.normal(size=(b, m, k)), dtype=torch.float32,
                       device=cuda)
    plane = torch.tensor(rng.integers(0, k, (700, m)).astype(dtype),
                         device=cuda)
    ids = rng.integers(-3, 703, (b, c)).astype(np.int32)    # clipped
    if dup:
        ids = np.concatenate([ids[:, : (c + 1) // 2]] * 2, -1)[:, :c]
    live = rng.random((b, c)) < 0.8
    if mask_row is not None:
        live[mask_row] = False
    ids, live = torch.tensor(ids, device=cuda), torch.tensor(live,
                                                            device=cuda)
    before = adc_ops.launches
    got = adc_ops.pq_adc_fused(lut, plane, ids, live)
    want = adc_ref.pq_adc_fused(lut, plane, ids, live)
    torch.cuda.synchronize()
    assert adc_ops.launches == before + 1
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-4, atol=1e-4)


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
    # name: (n, l, h, k, duplicated centroid rows)
    "ties": (33, 300, 32, 12, True),
    "ragged_tiles": (17, 129, 40, 8, True),
    "k_max": (3, 2000, 96, at_ops.MAX_K, False),
    "many_slices": (300, 5000, 64, 30, False),
}


@pytest.mark.parametrize("name", sorted(TOPK_CASES))
def test_topk_scores_kernel_matches_plain(cuda, name):
    n, l, h, k, ties = TOPK_CASES[name]
    rng = np.random.default_rng(n + l)
    x = rng.normal(size=(n, h))
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    emb = rng.normal(size=(l, h))
    if ties:
        emb = np.concatenate([emb[: (l + 1) // 2]] * 2)[:l]
    x = torch.tensor(x, dtype=torch.float32, device=cuda)
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


SQ8_CASES = {
    # name: (b, c, h, duplicate ids, masked row, byte offset of the plane)
    "c_below_tile": (3, 5, 768, False, 1, 0),
    "c_ragged": (2, 3 * 512 + 77, 768, True, None, 0),
    "h16_masked": (4, 700, 16, False, 3, 0),
    "h40_scalar": (2, 333, 40, True, 0, 0),
    "unaligned_view": (2, 600, 768, False, None, 3),
    "all_masked": (2, 100, 64, False, "all", 0),
}


@pytest.mark.parametrize("name", sorted(SQ8_CASES))
def test_sq8_dot_fused_kernel_matches_plain(cuda, name):
    b, c, h, dup, mask, offset = SQ8_CASES[name]
    rng = np.random.default_rng(len(name) + 100)
    q = torch.tensor(rng.normal(size=(b, h)), dtype=torch.float32,
                     device=cuda)
    flat = torch.tensor(rng.integers(0, 256, 700 * h + offset),
                        dtype=torch.uint8, device=cuda)
    plane = flat[offset:].view(700, h)
    ids = rng.integers(-3, 703, (b, c)).astype(np.int32)    # clipped
    if dup:
        ids = np.concatenate([ids[:, : (c + 1) // 2]] * 2, -1)[:, :c]
    live = rng.random((b, c)) < 0.8
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
    # name: (m, n, l, h, duplicated centroid rows)
    "ragged": (1, 513, 7, 40, False),
    "one_point": (1, 1, 10_000, 768, False),
    "ties": (1, 300, 1030, 64, True),
    "pq_batch": (96, 700, 256, 8, True),
}


@pytest.mark.parametrize("name", sorted(ASSIGN_CASES))
def test_assign_argmax_kernel_matches_plain(cuda, name):
    m, n, l, h, ties = ASSIGN_CASES[name]
    rng = np.random.default_rng(n + l)
    x = torch.tensor(rng.normal(size=(m, n, h)), dtype=torch.float32,
                     device=cuda)
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
    # name: (dtype, b, hq, hkv, sq, sk, d, causal, window)
    "f32_encoder_d64": (torch.float32, 3, 12, 12, 64, 64, 64, False, 0),
    "f32_d16_gqa_ragged": (torch.float32, 2, 4, 2, 63, 63, 16, True, 0),
    "f32_d128_window": (torch.float32, 1, 8, 1, 200, 200, 128, True, 32),
    "f32_dead_rows": (torch.float32, 2, 4, 4, 384, 63, 32, False, 32),
    "bf16_d128_gqa": (torch.bfloat16, 1, 32, 8, 384, 384, 128, True, 0),
    "bf16_one_row": (torch.bfloat16, 2, 4, 2, 1, 200, 64, False, 0),
}


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_attention_kernel_matches_plain(cuda, name):
    dtype, b, hq, hkv, sq, sk, d, causal, window = FLASH_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(len(name))
    # q, k, v as (B, H, S, d) views of (B, S, H, d) memory
    q = torch.randn((b, sq, hq, d), generator=g, device=cuda).to(
        dtype).transpose(1, 2)
    k, v = (torch.randn((b, sk, hkv, d), generator=g, device=cuda).to(
        dtype).transpose(1, 2) for _ in range(2))
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

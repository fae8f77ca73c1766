"""On-card tests of the port: each CUDA kernel against its plain PyTorch
version, and search on the card against search on the CPU over the same
index.  They skip without a card; on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports only the port (the card's machine has no JAX).  Tolerances:
ADC scores rtol=atol=1e-4 with identical ``-inf`` lanes; top-k ids
identical except swaps between plain scores within 1e-5, scores within
rtol=atol=1e-5 (the kernel and cuBLAS sum the h products in different
orders); SQ8 dots rtol 1e-4, atol 1e-2 (the JAX kernel test's own) with
identical ``-inf`` lanes.
"""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import hybrid_index as hi
from repro_torch.core import inverted_lists as il
from repro_torch.kernels.assign_topk import ops as at_ops
from repro_torch.kernels.assign_topk import ref as at_ref
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

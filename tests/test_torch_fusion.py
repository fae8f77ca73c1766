"""Port parity of hybrid dense∥sparse fusion (DESIGN.md §13): the
single-device cases of ``tests/test_fusion.py`` on the port, each also
against the JAX package on the same JAX-built index (read by the port
through ``save_index`` → ``load_index``), plus the pure pieces
(``sum_by_doc``, ``rrf_contributions``, ``build_scored``) against the
reference on inputs built to expose summation order and division.

Tolerances: ``sum_by_doc``, ``rrf_contributions``, ``build_scored`` and
the checkpointed impact plane bitwise; weight 1.0 ids bitwise equal to
``fusion=None``; weight 0.0 ids equal to a BM25 oracle; fused search
against the reference: ids equal up to swaps between documents whose
scores lie within 1e-4, scores within rtol=atol=1e-4 (the dense half
carries the codec's own 1e-4, DESIGN.md §11), ``n_candidates`` exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import exec as jexec
from repro.core import hybrid_index as jhi
from repro.core import inverted_lists as jil
from repro.core.exec import filters as jfilters
from repro.core.exec import fusion as jfusion
from repro.data import synthetic
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import exec as qexec
from repro_torch.core import hybrid_index as hi
from repro_torch.core import inverted_lists as il
from repro_torch.core import term_selector as ts
from repro_torch.core.exec import filters
from repro_torch.core.exec import fusion
from repro_torch.core.inverted_lists import PAD_DOC
from repro_torch.launch import serve

torch.set_num_threads(2)

TOL = 1e-4
N_NS = 4
WIDTHS = dict(kc=4, k2=4, top_r=16)
KW = dict(n_clusters=16, k1_terms=4, pq_m=4, pq_k=64, cluster_capacity=64,
          term_capacity=32, kmeans_iters=3)
#: index name → (codec, build overrides); "pq" is the reference test's
#: index, "uncapped" its BM25-oracle index, "filtered" its namespace one
SETTINGS = {"pq": ("pq", {}), "opq": ("opq", {}),
            "refine_sq8": ("refine:sq8:4", {}),
            "uncapped": ("pq", dict(term_capacity=None)),
            "filtered": ("pq", dict(doc_namespaces=(
                np.arange(1400) * 7 % N_NS).astype(np.int32))),
            "dense_only": ("pq", dict(sparse=False))}


@pytest.fixture(scope="module")
def corpus():
    return synthetic.generate(seed=0, n_docs=1400, n_queries=24, hidden=32,
                              vocab_size=512, n_topics=8)


@pytest.fixture(scope="module")
def indexes(corpus, tmp_path_factory):
    """name → (JAX index, the port's index loaded from its checkpoint)."""
    out = {}
    for name, (codec, over) in SETTINGS.items():
        kw = dict(KW, codec=codec, **{"sparse": True, **over})
        idx = jhi.build(jax.random.key(0), jnp.asarray(corpus.doc_emb),
                        jnp.asarray(corpus.doc_tokens), corpus.vocab_size,
                        **kw)
        path = jckpt.save_index(str(tmp_path_factory.mktemp(name)), 0, idx)
        out[name] = (idx, ckpt.load_index(path, device="cpu"))
    return out


def _q(corpus):
    return corpus.query_emb, corpus.query_tokens


def _jq(corpus):
    return jnp.asarray(corpus.query_emb), jnp.asarray(corpus.query_tokens)


def assert_topk_match(want, got):
    """Ids equal up to swaps between scores within TOL; scores within
    rtol=atol=TOL; n_candidates exact."""
    wi, ws = np.asarray(want.doc_ids), np.asarray(want.scores)
    gi, gs = got.doc_ids.numpy(), got.scores.numpy()
    np.testing.assert_array_equal(got.n_candidates.numpy(),
                                  np.asarray(want.n_candidates))
    np.testing.assert_allclose(gs, ws, rtol=TOL, atol=TOL)
    for b, p in zip(*np.nonzero(gi != wi)):
        where = np.flatnonzero(wi[b] == gi[b, p])
        ref = ws[b, where[0]] if where.size else ws[b, -1]
        assert abs(ref - gs[b, p]) <= TOL + TOL * abs(ref), (b, p)


# --------------------------------------------------------------------------
# the pure pieces, bitwise against the reference
# --------------------------------------------------------------------------

def _runs_case(seed, b, c, n_ids, pad_share, max_run):
    """Ids in runs of up to ``max_run`` slots in shuffled order, a PAD
    share (its values 0) and values spread over 16 decades, so that a
    different summation order changes the bits."""
    rng = np.random.default_rng(seed)
    ids = np.full((b, c), PAD_DOC, np.int32)
    for r in range(b):
        pos = rng.permutation(c)[: int(c * (1 - pad_share))]
        ids[r, pos] = rng.integers(0, n_ids, pos.size)
        for doc in np.unique(ids[r][ids[r] >= 0]):   # cap each run
            where = np.flatnonzero(ids[r] == doc)
            ids[r, where[max_run:]] = PAD_DOC
    vals = (rng.random((b, c)) * 10.0 ** rng.integers(-8, 8, (b, c))
            ).astype(np.float32)
    vals[ids == PAD_DOC] = 0.0
    return ids, vals


SUM_CASES = {
    # name: (b, c, distinct ids, PAD share, longest run)
    "long_runs": (3, 4096, 64, 0.2, 40),
    "run_of_32": (2, 2048, 40, 0.1, 32),
    "mostly_pad": (2, 1024, 8, 0.9, 16),
    "all_pad": (2, 300, 1, 1.0, 4),
    "pairs": (4, 32, 20, 0.3, 2),
}


@pytest.mark.parametrize("name", sorted(SUM_CASES))
def test_sum_by_doc_matches_reference_bitwise(name):
    b, c, n_ids, pad, max_run = SUM_CASES[name]
    ids, vals = _runs_case(len(name), b, c, n_ids, pad, max_run)
    want = [np.asarray(a) for a in jfusion.sum_by_doc(jnp.asarray(ids),
                                                      jnp.asarray(vals))]
    got = [a.numpy() for a in fusion.sum_by_doc(torch.from_numpy(ids),
                                                torch.from_numpy(vals))]
    for g, w, what in zip(got, want, ("sorted ids", "totals", "first")):
        assert g.dtype == w.dtype, what
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                      err_msg=what)
    if name == "long_runs":   # the case does expose the summation order
        order = np.argsort(ids, axis=-1, kind="stable")
        sval = np.take_along_axis(vals, order, -1)
        sid = np.take_along_axis(ids, order, -1)
        backwards = np.array([sval[r][sid[r] == d][::-1].cumsum()[-1]
                              for r in range(b)
                              for d in np.unique(sid[r][sid[r] >= 0])])
        forwards = np.array([sval[r][sid[r] == d].cumsum()[-1]
                             for r in range(b)
                             for d in np.unique(sid[r][sid[r] >= 0])])
        assert (backwards != forwards).any()


@pytest.mark.parametrize("weight", [0.5, 0.3, 1.0 - 0.3, 0.123456, 1.0])
def test_rrf_contributions_match_reference_bitwise(weight):
    rng = np.random.default_rng(7)
    scores = rng.normal(size=(3, 4096)).astype(np.float32)
    scores[0, 3000:] = -np.inf
    scores[2, :] = -np.inf
    want = np.asarray(jfusion.rrf_contributions(jnp.asarray(scores), weight,
                                                60))
    got = fusion.rrf_contributions(torch.from_numpy(scores), weight,
                                   60).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got[np.isinf(scores)] == 0.0).all()


def test_build_scored_matches_reference():
    rng = np.random.default_rng(3)
    docs = np.repeat(np.arange(500), 3)
    lists = rng.integers(-1, 40, docs.size)
    scores = rng.random(docs.size).astype(np.float32)
    for cap in (None, 8):
        want_l, want_w = jil.build_scored(docs, lists, scores, 40, cap)
        got_l, got_w = il.build_scored(docs, lists, scores, 40, cap,
                                       device="cpu")
        np.testing.assert_array_equal(got_l.entries.numpy(),
                                      np.asarray(want_l.entries))
        np.testing.assert_array_equal(got_l.lengths.numpy(),
                                      np.asarray(want_l.lengths))
        np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
        plain = il.build(docs, lists, scores, 40, cap, device="cpu")
        assert torch.equal(plain.entries, got_l.entries)
    with pytest.raises(ValueError, match="real per-posting scores"):
        il.build_scored(docs, lists, None, 40, device="cpu")


# --------------------------------------------------------------------------
# the spec and the build
# --------------------------------------------------------------------------

def test_fusion_spec_validates():
    qexec.FusionSpec(weight=0.0)
    qexec.FusionSpec(weight=1.0)
    for bad in (dict(weight=1.5), dict(weight=-0.1), dict(rrf_k=-1)):
        with pytest.raises(ValueError):
            qexec.FusionSpec(**bad)
    assert qexec.FusionSpec(weight=0.5) == qexec.FusionSpec(weight=0.5)
    assert hash(qexec.FusionSpec()) == hash(qexec.FusionSpec())
    with pytest.raises(AttributeError):
        qexec.FusionSpec().weight = 0.2          # frozen, as the reference


def test_build_sparse_requires_term_lists(corpus):
    with pytest.raises(ValueError, match="use_terms"):
        hi.build(0, corpus.doc_emb, corpus.doc_tokens, corpus.vocab_size,
                 sparse=True, use_terms=False, device="cpu",
                 **dict(KW, codec="pq"))


def test_sparse_build_matches_reference_and_aligns(corpus, indexes):
    """The port's own ``build(sparse=True)``: term lists equal to the
    reference's, impacts within 1e-5 relative (BM25 position scores,
    tests/test_torch_build.py's bound), 0.0 exactly at pads and > 0
    where a posting exists."""
    jidx, _ = indexes["pq"]
    got = hi.build(0, corpus.doc_emb, corpus.doc_tokens, corpus.vocab_size,
                   sparse=True, device="cpu",
                   **dict(KW, codec="pq"))
    entries = got.term_lists.entries.numpy()
    np.testing.assert_array_equal(entries, np.asarray(jidx.term_lists.entries))
    w = got.sparse_weights.numpy()
    assert w.shape == entries.shape and w.dtype == np.float32
    np.testing.assert_allclose(w, np.asarray(jidx.sparse_weights), rtol=1e-5,
                               atol=0)
    assert (w[entries == PAD_DOC] == 0.0).all()
    assert (w[entries != PAD_DOC] > 0.0).all()
    assert hi.base_source(got).sparse_weights is got.sparse_weights


def test_checkpoint_roundtrip_preserves_fused_search(indexes, corpus):
    """``load_index`` reads the reference's impact plane bit for bit and
    the fused search over it matches the reference's."""
    jidx, tidx = indexes["pq"]
    np.testing.assert_array_equal(tidx.sparse_weights.numpy(),
                                  np.asarray(jidx.sparse_weights))
    fus = 0.5
    want = jhi.search(jidx, *_jq(corpus), fusion=jexec.FusionSpec(fus),
                      **WIDTHS)
    got = hi.search(tidx, *_q(corpus), fusion=qexec.FusionSpec(fus),
                    device="cpu", **WIDTHS)
    assert_topk_match(want, got)


# --------------------------------------------------------------------------
# degenerate weights, the fallback contract, the BM25 oracle
# --------------------------------------------------------------------------

def test_weight_one_bit_identical_to_dense_only(indexes, corpus):
    for name in ("pq", "opq", "refine_sq8"):
        jidx, tidx = indexes[name]
        dense = hi.search(tidx, *_q(corpus), device="cpu", **WIDTHS)
        w1 = hi.search(tidx, *_q(corpus), device="cpu",
                       fusion=qexec.FusionSpec(weight=1.0), **WIDTHS)
        assert torch.equal(dense.doc_ids, w1.doc_ids), name
        jw1 = jhi.search(jidx, *_jq(corpus), **WIDTHS,
                         fusion=jexec.FusionSpec(weight=1.0))
        np.testing.assert_array_equal(w1.n_candidates.numpy(),
                                      np.asarray(jw1.n_candidates))


def test_dense_fallback_without_impact_plane_is_exact(indexes, corpus):
    _, tidx = indexes["dense_only"]
    assert tidx.sparse_weights is None
    dense = hi.search(tidx, *_q(corpus), device="cpu", **WIDTHS)
    fb = hi.search(tidx, *_q(corpus), device="cpu",
                   fusion=qexec.FusionSpec(weight=0.5), **WIDTHS)
    for field in ("doc_ids", "scores", "n_candidates"):
        assert torch.equal(getattr(dense, field), getattr(fb, field)), field


def test_mixed_weight_changes_ranking_and_counts_sparse(indexes, corpus):
    _, tidx = indexes["pq"]
    dense = hi.search(tidx, *_q(corpus), device="cpu", **WIDTHS)
    fused = hi.search(tidx, *_q(corpus), device="cpu",
                      fusion=qexec.FusionSpec(weight=0.5), **WIDTHS)
    assert not torch.equal(dense.doc_ids, fused.doc_ids)
    assert (fused.n_candidates > dense.n_candidates).any()
    assert (fused.n_candidates >= dense.n_candidates).all()


def _bm25_oracle(index, query_tokens, k2, top_r):
    """Pure sparse top-R: each query's stored impacts summed per doc
    over its probed term lists in probed order (float32, the order of
    the fixed-shape path), ranked by (score desc, id asc), zero-score
    docs excluded."""
    t_ids = ts.query_terms(index.term_sel, torch.from_numpy(query_tokens),
                           k2).numpy()
    entries = index.term_lists.entries.numpy()
    weights = index.sparse_weights.numpy()
    out = np.full((t_ids.shape[0], top_r), PAD_DOC, np.int64)
    for b in range(t_ids.shape[0]):
        acc = np.zeros((index.n_docs,), np.float32)
        for t in t_ids[b]:
            if t < 0:
                continue
            for slot in range(entries.shape[1]):
                d = entries[t, slot]
                if d >= 0:
                    acc[d] = np.float32(acc[d] + weights[t, slot])
        live = np.flatnonzero(acc > 0.0)
        order = live[np.lexsort((live, -acc[live]))][:top_r]
        out[b, :order.size] = order
    return out


def test_weight_zero_matches_bm25_oracle(indexes, corpus):
    jidx, tidx = indexes["uncapped"]
    res = hi.search(tidx, *_q(corpus), device="cpu",
                    fusion=qexec.FusionSpec(weight=0.0), **WIDTHS)
    oracle = _bm25_oracle(tidx, corpus.query_tokens, WIDTHS["k2"],
                          WIDTHS["top_r"])
    np.testing.assert_array_equal(res.doc_ids.numpy(), oracle)
    jres = jhi.search(jidx, *_jq(corpus), fusion=jexec.FusionSpec(0.0),
                      **WIDTHS)
    np.testing.assert_array_equal(res.doc_ids.numpy(),
                                  np.asarray(jres.doc_ids))


# --------------------------------------------------------------------------
# against the reference, and the namespace filter
# --------------------------------------------------------------------------

@pytest.mark.parametrize("weight", [0.0, 0.5, 0.8])
@pytest.mark.parametrize("name", ["opq", "refine_sq8"])
def test_fused_search_matches_reference(indexes, corpus, name, weight):
    jidx, tidx = indexes[name]
    want = jhi.search(jidx, *_jq(corpus), fusion=jexec.FusionSpec(weight),
                      **WIDTHS)
    got = hi.search(tidx, *_q(corpus), fusion=qexec.FusionSpec(weight),
                    device="cpu", **WIDTHS)
    assert_topk_match(want, got)
    sp_want = jexec.sparse_topk(
        [jhi.base_source(jidx)],
        jexec.dispatch(jidx.cluster_sel, jidx.term_sel, *_jq(corpus),
                       WIDTHS["kc"], WIDTHS["k2"])[1], WIDTHS["top_r"],
        None, None)
    _, term_ids = qexec.dispatch(tidx.cluster_sel, tidx.term_sel,
                                 *(torch.from_numpy(a) for a in _q(corpus)),
                                 WIDTHS["kc"], WIDTHS["k2"])
    sp_got = qexec.sparse_topk([hi.base_source(tidx)], term_ids,
                               WIDTHS["top_r"], None)
    for g, w in zip(sp_got, sp_want):      # the sparse half is bitwise
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_namespace_filter_applies_to_sparse_candidates(indexes, corpus):
    jidx, tidx = indexes["filtered"]
    doc_ns = tidx.doc_ns.numpy()
    allowed = [[b % N_NS] for b in range(len(corpus.query_emb))]
    for w in (0.0, 0.5):
        got = hi.search(tidx, *_q(corpus), device="cpu",
                        filter=filters.make_filter(allowed, N_NS,
                                                   device="cpu"),
                        fusion=qexec.FusionSpec(weight=w), **WIDTHS)
        ids = got.doc_ids.numpy()
        for b, row in enumerate(ids):
            assert np.isin(doc_ns[row[row >= 0]], allowed[b]).all(), (w, b)
        want = jhi.search(jidx, *_jq(corpus),
                          filter=jfilters.make_filter(allowed, N_NS),
                          fusion=jexec.FusionSpec(w), **WIDTHS)
        assert_topk_match(want, got)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def test_server_set_fusion_validates_weight(indexes):
    _, tidx = indexes["pq"]
    srv = serve.Server(tidx, serve.ServeConfig(kc=4, k2=4, top_r=8,
                                               max_batch=8), device="cpu")
    assert srv.fusion is None
    with pytest.raises(ValueError):
        srv.set_fusion(2.0)
    srv.set_fusion(0.5)
    assert srv.fusion == qexec.FusionSpec(weight=0.5)
    srv.set_fusion(None)
    assert srv.fusion is None
    with pytest.raises(ValueError):
        serve.Server(tidx, serve.ServeConfig(fusion_weight=-1.0),
                     device="cpu")


def test_server_serves_fused_ragged_batches(indexes, corpus):
    jidx, tidx = indexes["opq"]
    n = 11
    srv = serve.Server(tidx, serve.ServeConfig(
        kc=4, k2=4, top_r=16, max_batch=16, fusion_weight=0.5),
        device="cpu")
    got = srv.query(corpus.query_emb[:n], corpus.query_tokens[:n])
    want = jhi.search(jidx, jnp.asarray(corpus.query_emb[:n]),
                      jnp.asarray(corpus.query_tokens[:n]),
                      fusion=jexec.FusionSpec(0.5), **WIDTHS)
    assert_topk_match(want, got)
    srv.set_fusion(None)
    dense = srv.query(corpus.query_emb[:n], corpus.query_tokens[:n])
    assert not torch.equal(dense.doc_ids, got.doc_ids)

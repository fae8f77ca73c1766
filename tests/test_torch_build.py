"""Port parity of the index build: ``repro_torch`` on the CPU against the
JAX package on the same numpy inputs.

Deterministic stages match bit for bit: the synthetic corpus, BM25 term
frequencies, top terms and their lists, SQ8 ranges and codes, the fp16
refine plane.  Float statistics match within 1e-6 relative (IDF and
position scores: XLA's f32 ``log`` and torch's differ in the last bit),
and s̄ within 1e-5: it sums up to n position scores in f32, so a
last-bit change of its inputs moves the rounding of the sum by about
√n·ε.  Encodes
and assignments given the reference's codebooks or centroids match
exactly except on rows whose best two candidates lie within 1e-5 (two
BLAS orders may split such a near-tie either way).  The build itself
draws its KMeans and PQ initialisations from a ``torch.Generator``,
which cannot match ``jax.random``: the full unsupervised build is held
to the reference's recall, MRR and OPQ reconstruction error instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bm25 as jbm25
from repro.core import cluster_selector as jcs
from repro.core import hybrid_index as jhi
from repro.core import inverted_lists as jil
from repro.core import kmeans as jkmeans
from repro.core import metrics as jmetrics
from repro.core import pruning as jpruning
from repro.core import term_selector as jts
from repro.core.codecs import flat as jflat
from repro.core.codecs import pq as jpq
from repro.core.codecs import sq8 as jsq8
from repro.data import synthetic as jsynthetic
from repro_torch.core import bm25
from repro_torch.core import cluster_selector as cs
from repro_torch.core import hybrid_index as hi
from repro_torch.core import inverted_lists as il
from repro_torch.core import kmeans
from repro_torch.core import metrics
from repro_torch.core import pruning
from repro_torch.core import term_selector as ts
from repro_torch.core.codecs import flat
from repro_torch.core.codecs import pq
from repro_torch.core.codecs import refine
from repro_torch.core.codecs import sq8
from repro_torch.data import synthetic

torch.set_num_threads(2)

REL = 1e-6           # IDF / position scores: f32 log differs by an ulp
SBAR_REL = 1e-5      # s̄: f32 sums over ≈ n such scores
NEAR_TIE = 1e-5      # best-two gap under which an argmax may split
GEN = dict(seed=0, n_docs=1500, n_queries=16, hidden=32, vocab_size=512,
           n_topics=8)
BUILD = dict(n_clusters=16, k1_terms=4, pq_m=4, pq_k=64,
             cluster_capacity=128, term_capacity=32, kmeans_iters=3)


@pytest.fixture(scope="module")
def corpus():
    return synthetic.generate(**GEN)


@pytest.fixture(scope="module")
def jax_opq(corpus):
    """The reference's KMeans selector + φ(D), from a JAX opq build."""
    return jhi.build(jax.random.key(0), jnp.asarray(corpus.doc_emb),
                     jnp.asarray(corpus.doc_tokens), corpus.vocab_size,
                     codec="opq", **BUILD)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def assert_rel(got, want, rel=REL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rel,
                               atol=1e-9)


def assert_argmax_match(got, want, scores):
    """Ids equal except where the reference's best two ``scores`` (the
    last axis) lie within NEAR_TIE."""
    got, want = np.asarray(got), np.asarray(want)
    top2 = -np.sort(-np.asarray(scores, np.float64), axis=-1)[..., :2]
    near = (top2[..., 0] - top2[..., 1]) <= NEAR_TIE
    assert ((got == want) | near).all(), np.argwhere((got != want) & ~near)


# --------------------------------------------------------------------------
# deterministic stages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("make_model_b", [True, False])
def test_synthetic_generate_matches_reference(make_model_b):
    kw = dict(GEN, seed=7, make_model_b=make_model_b)
    got, want = synthetic.generate(**kw), jsynthetic.generate(**kw)
    for field in ("doc_emb", "doc_tokens", "query_emb", "query_tokens",
                  "qrels", "doc_topic", "is_hard", "doc_emb_b",
                  "query_emb_b"):
        g, w = getattr(got, field), getattr(want, field)
        if w is None:
            assert g is None, field
        else:
            assert g.dtype == w.dtype, field
            np.testing.assert_array_equal(g, w, err_msg=field)
    assert got.vocab_size == want.vocab_size
    np.testing.assert_array_equal(synthetic.hard_negatives(got, 5, seed=3),
                                  jsynthetic.hard_negatives(want, 5, seed=3))


def test_bm25_stages_match_reference(corpus):
    tokens = corpus.doc_tokens.copy()
    tokens[::7, -5:] = -1                                # PAD tails
    tokens[::5, 3] = tokens[::5, 1]                      # repeats
    jt, tt = jnp.asarray(tokens), _t(tokens, torch.int64)
    v = corpus.vocab_size
    np.testing.assert_array_equal(bm25.first_occurrence_mask(tt).numpy(),
                                  np.asarray(jbm25.first_occurrence_mask(jt)))
    np.testing.assert_array_equal(bm25.term_frequency(tt).numpy(),
                                  np.asarray(jbm25.term_frequency(jt)))
    jstats, stats = jbm25.fit(jt, v), bm25.fit(tt, v)
    assert_rel(stats.idf.numpy(), jstats.idf)
    assert_rel(float(stats.avgdl), float(jstats.avgdl))
    assert stats.n_docs == int(jstats.n_docs)
    jpos = np.asarray(jbm25.score_positions(jt, jstats))
    assert_rel(bm25.score_positions(tt, stats).numpy(), jpos)
    # from the same position scores the rest is exact
    for k in (1, 4, 30):
        wid, ws = jbm25.top_terms(jt, jnp.asarray(jpos), k)
        gid, gs = bm25.top_terms(tt, torch.from_numpy(jpos), k)
        np.testing.assert_array_equal(gid.numpy(), np.asarray(wid))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    assert_rel(bm25.average_term_scores(tt, torch.from_numpy(jpos),
                                        v).numpy(),
               jbm25.average_term_scores(jt, jnp.asarray(jpos), v))
    jsel, jp, _ = jts.fit_unsup(jt, v)
    sel, p, _ = ts.fit_unsup(tt, v)
    assert_rel(sel.avg_scores.numpy(), jsel.avg_scores, SBAR_REL)
    assert_rel(p.numpy(), jp)


def test_term_lists_from_the_same_triples_match_reference(corpus):
    """BM25 → top-K₁ᵀ terms → bucketed term lists, each side from its
    own position scores."""
    jt, tt = jnp.asarray(corpus.doc_tokens), _t(corpus.doc_tokens,
                                                torch.int64)
    _, jpos, _ = jts.fit_unsup(jt, corpus.vocab_size)
    _, pos, _ = ts.fit_unsup(tt, corpus.vocab_size)
    jid, jsc = jts.doc_terms(jt, jpos, 4)
    tid, tsc = ts.doc_terms(tt, pos, 4)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    assert_rel(tsc.numpy(), jsc)
    rep = np.repeat(np.arange(len(corpus.doc_tokens)), 4)
    want = jil.build(rep, np.asarray(jid).reshape(-1),
                     np.asarray(jsc).reshape(-1), corpus.vocab_size, 32)
    got = il.build(rep, tid.numpy().reshape(-1), tsc.numpy().reshape(-1),
                   corpus.vocab_size, 32, device="cpu")
    np.testing.assert_array_equal(got.entries.numpy(),
                                  np.asarray(want.entries))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))


def test_sq8_train_encode_and_refine_plane_match_reference(corpus,
                                                           monkeypatch):
    x = corpus.doc_emb.copy()
    x[:, 3] = 0.25                                   # a constant dimension
    monkeypatch.setattr(sq8, "BLOCK", 256)           # several blocks
    codec, jcodec = sq8.SQ8Codec(), jsq8.SQ8Codec()
    jparams = jcodec.train(jax.random.key(0), jnp.asarray(x))
    params = codec.train(None, torch.from_numpy(x))
    for key in ("lo", "scale"):
        np.testing.assert_array_equal(params[key].numpy(),
                                      np.asarray(jparams[key]))
    assert float(params["scale"][3]) == 1.0
    planes = codec.encode(params, torch.from_numpy(x))
    jplanes = jcodec.encode(jparams, jnp.asarray(x))
    np.testing.assert_array_equal(planes["codes"].numpy(),
                                  np.asarray(jplanes["codes"]))
    np.testing.assert_array_equal(codec.decode(params, planes).numpy(),
                                  np.asarray(jcodec.decode(jparams,
                                                           jplanes)))
    rc = refine.RefineCodec(codec, 4)
    rplanes = rc.encode(params, torch.from_numpy(x))
    want = np.asarray(jnp.asarray(x).astype(jnp.float16))
    assert rplanes["refine_emb"].dtype == torch.float16
    np.testing.assert_array_equal(rplanes["refine_emb"].numpy(), want)
    np.testing.assert_array_equal(rc.decode(params, rplanes).numpy(),
                                  want.astype(np.float32))


def test_pq_and_opq_encode_given_the_reference_codebook(corpus, jax_opq,
                                                        monkeypatch):
    x = corpus.doc_emb
    monkeypatch.setattr(pq, "ENCODE_BLOCK", 500)     # several blocks
    jcb = jpq.train_pq(jax.random.key(1), jnp.asarray(x), m=4, k=64)
    cb = pq.PQCodebook(_t(jcb.codewords))
    frags = x.reshape(len(x), 4, -1)
    c = np.asarray(jcb.codewords, np.float64)
    dist = (np.einsum("nmd,mkd->nmk", frags, c)
            - 0.5 * (c * c).sum(-1)[None])
    codes = pq.pq_encode(cb, torch.from_numpy(x))
    assert codes.dtype == torch.int32
    assert_argmax_match(codes.numpy(), jpq.pq_encode(jcb, jnp.asarray(x)),
                        dist)
    np.testing.assert_allclose(
        pq.pq_decode(cb, codes).numpy(),
        np.asarray(jpq.pq_decode(jcb, jnp.asarray(codes.numpy()))),
        rtol=0, atol=0)
    assert float(pq.reconstruction_mse(cb, torch.from_numpy(x))) == \
        pytest.approx(float(jpq.reconstruction_mse(jcb, jnp.asarray(x))),
                      rel=1e-5)
    jopq = jax_opq.codec_params
    opq = pq.OPQCodebook(_t(jopq.rotation),
                         pq.PQCodebook(_t(jopq.codebook.codewords)))
    xr = (x.astype(np.float64) @ np.asarray(jopq.rotation, np.float64))
    c = np.asarray(jopq.codebook.codewords, np.float64)
    dist = (np.einsum("nmd,mkd->nmk", xr.reshape(len(x), 4, -1), c)
            - 0.5 * (c * c).sum(-1)[None])
    assert_argmax_match(pq.opq_encode(opq, torch.from_numpy(x)).numpy(),
                        jpq.opq_encode(jopq, jnp.asarray(x)), dist)
    codec = pq.OPQCodec()
    planes = codec.encode(opq, torch.from_numpy(x))
    assert planes["codes"].dtype == torch.uint8
    assert_argmax_match(planes["codes"].numpy(),
                        np.asarray(jax_opq.doc_planes["codes"]), dist)


def test_assignments_given_the_reference_centroids(corpus, jax_opq,
                                                   monkeypatch):
    x = corpus.doc_emb
    cent = np.asarray(jax_opq.cluster_sel.embeddings)
    c64 = cent.astype(np.float64)
    l2 = x.astype(np.float64) @ c64.T - 0.5 * (c64 * c64).sum(-1)
    assert_argmax_match(
        kmeans.assign_blocked(torch.from_numpy(x), torch.from_numpy(cent),
                              block=256).numpy(),
        jkmeans.assign_blocked(jnp.asarray(x), jnp.asarray(cent),
                               block=256), l2)
    monkeypatch.setattr(cs, "BLOCK", 300)            # several blocks
    sel = cs.ClusterSelector(torch.from_numpy(cent))
    got = cs.select_for_doc(sel, torch.from_numpy(x))
    assert got.dtype == torch.int32
    assert_argmax_match(got.numpy(), jax_opq.doc_assign,
                        x.astype(np.float64) @ c64.T)


def test_one_lloyd_step_matches_reference(corpus, jax_opq):
    x = corpus.doc_emb
    cent = np.asarray(jax_opq.cluster_sel.embeddings)
    a = np.asarray(jkmeans.assign_blocked(jnp.asarray(x), jnp.asarray(cent)))
    jsums, jcounts = jkmeans._update(jnp.asarray(x), jnp.asarray(a), 16)
    sums, counts = kmeans._update(torch.from_numpy(x), torch.from_numpy(a),
                                  16)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=1e-5,
                               atol=1e-5)
    new = sums / torch.clamp(counts, min=1.0)[:, None]
    jnew = jsums / jnp.maximum(jcounts, 1.0)[:, None]
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), rtol=1e-5,
                               atol=1e-6)
    # a batched step equals its slices (the written-out vmap of train_pq)
    xb = torch.from_numpy(x).reshape(len(x), 2, -1).transpose(0, 1)
    cb = torch.from_numpy(cent).reshape(16, 2, -1).transpose(0, 1)
    ab = kmeans.assign_blocked(xb, cb)
    bs, bc = kmeans._update(xb, ab, 16)
    for j in range(2):
        np.testing.assert_array_equal(
            ab[j].numpy(), kmeans.assign_blocked(xb[j], cb[j]).numpy())
        s1, c1 = kmeans._update(xb[j], ab[j], 16)
        np.testing.assert_array_equal(bc[j].numpy(), c1.numpy())
        np.testing.assert_allclose(bs[j].numpy(), s1.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_kmeans_fit_and_reseeding():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(400, 8)).astype(np.float32))
    g = torch.Generator().manual_seed(0)
    c, a = kmeans.kmeans_fit(g, x, 12, n_iters=8)
    assert c.shape == (12, 8) and a.shape == (400,) and a.dtype == torch.int32
    c0, a0 = kmeans.kmeans_fit(torch.Generator().manual_seed(0), x, 12,
                               n_iters=0)
    assert float(kmeans.kmeans_cost(x, c, a)) < float(
        kmeans.kmeans_cost(x, c0, a0))
    # same seed, same fit
    c2, _ = kmeans.kmeans_fit(torch.Generator().manual_seed(0), x, 12, 8)
    assert torch.equal(c, c2)
    # an empty cluster is re-seeded to a data point; the rest keep theirs
    counts = torch.ones(12)
    counts[5] = 0
    far = torch.full((12, 8), 99.0)
    out = kmeans._reseed_empty(torch.Generator().manual_seed(1), far,
                               counts, x)
    assert torch.equal(out[torch.arange(12) != 5], far[torch.arange(12)
                                                       != 5])
    assert (x == out[5]).all(dim=1).any()
    # fewer points than clusters: sampled with replacement
    c3, _ = kmeans.kmeans_fit(torch.Generator().manual_seed(0), x[:5], 12, 2)
    assert c3.shape == (12, 8)


def test_pruning_matches_reference():
    rng = np.random.default_rng(4)
    lists = jil.build(np.arange(600), rng.integers(0, 40, 600),
                      rng.random(600), 40, None)
    tlists = il.PaddedLists(_t(lists.entries), _t(lists.lengths))
    for want, got in ((jpruning.prune_percentile(lists, 0.9),
                       pruning.prune_percentile(tlists, 0.9)),
                      (jpruning.prune_to_threshold(lists, 7),
                       pruning.prune_to_threshold(tlists, 7)),
                      (jpruning.prune_to_threshold(lists, 1000),
                       pruning.prune_to_threshold(tlists, 1000))):
        np.testing.assert_array_equal(got.entries.numpy(),
                                      np.asarray(want.entries))
        np.testing.assert_array_equal(got.lengths.numpy(),
                                      np.asarray(want.lengths))


def test_flat_search_matches_reference(corpus):
    docs = corpus.doc_emb.copy()
    docs[700:710] = docs[100:110]                    # exact score ties
    q = np.concatenate([corpus.query_emb, docs[100:104]])
    ws, wi = jflat.search(jnp.asarray(q), jnp.asarray(docs), k=50,
                          block=256)
    gs, gi = flat.search(torch.from_numpy(q), torch.from_numpy(docs), k=50,
                         block=256)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------------
# hybrid_index.build
# --------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["sq8", "refine:sq8:4", "flat"])
def test_build_with_injected_selectors_matches_reference(corpus, jax_opq,
                                                         codec):
    """Given the reference's cluster_sel and φ(D), every leaf of the
    port's index equals the JAX-built one's (s̄ within SBAR_REL)."""
    want = jhi.build(jax.random.key(0), jnp.asarray(corpus.doc_emb),
                     jnp.asarray(corpus.doc_tokens), corpus.vocab_size,
                     codec=codec, cluster_sel=jax_opq.cluster_sel,
                     doc_assign=jax_opq.doc_assign, **BUILD)
    got = hi.build(0, corpus.doc_emb, corpus.doc_tokens, corpus.vocab_size,
                   codec=codec,
                   cluster_sel=cs.ClusterSelector(
                       _t(jax_opq.cluster_sel.embeddings)),
                   doc_assign=np.asarray(jax_opq.doc_assign), device="cpu",
                   **BUILD)
    assert got.codec == codec and got.device == torch.device("cpu")
    exact = {"cluster_sel": (got.cluster_sel.embeddings,
                             want.cluster_sel.embeddings),
             "doc_assign": (got.doc_assign, want.doc_assign)}
    for fam in ("cluster_lists", "term_lists"):
        for part in ("entries", "lengths"):
            exact[f"{fam}.{part}"] = (getattr(getattr(got, fam), part),
                                      getattr(getattr(want, fam), part))
    for key, plane in want.doc_planes.items():
        exact[f"doc_planes.{key}"] = (got.doc_planes[key], plane)
    for key in (want.codec_params or {}):
        exact[f"codec_params.{key}"] = (got.codec_params[key],
                                        want.codec_params[key])
    assert set(got.doc_planes) == set(want.doc_planes)
    assert (got.codec_params is None) == (want.codec_params is None)
    for name, (g, w) in exact.items():
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert_rel(got.term_sel.avg_scores.numpy(), want.term_sel.avg_scores,
               SBAR_REL)


def test_build_without_clusters_or_terms_matches_reference(corpus, jax_opq):
    """The IVF and term-only baselines: the disabled family is one PAD
    column per list, as in the reference."""
    sel = cs.ClusterSelector(_t(jax_opq.cluster_sel.embeddings))
    got = hi.build_ivf(0, corpus.doc_emb, corpus.doc_tokens,
                       corpus.vocab_size, n_clusters=16, codec="flat",
                       cluster_capacity=128, cluster_sel=sel,
                       doc_assign=np.asarray(jax_opq.doc_assign),
                       device="cpu")
    want = jhi.build_ivf(jax.random.key(0), jnp.asarray(corpus.doc_emb),
                         jnp.asarray(corpus.doc_tokens), corpus.vocab_size,
                         n_clusters=16, codec="flat", cluster_capacity=128,
                         cluster_sel=jax_opq.cluster_sel,
                         doc_assign=jax_opq.doc_assign)
    only = hi.build_term_only(0, corpus.doc_emb, corpus.doc_tokens,
                              corpus.vocab_size, k1_terms=4, codec="flat",
                              term_capacity=32, device="cpu")
    jonly = jhi.build_term_only(jax.random.key(0),
                                jnp.asarray(corpus.doc_emb),
                                jnp.asarray(corpus.doc_tokens),
                                corpus.vocab_size, k1_terms=4, codec="flat",
                                term_capacity=32)
    for g, w in ((got.cluster_lists, want.cluster_lists),
                 (got.term_lists, want.term_lists),
                 (only.cluster_lists, jonly.cluster_lists),
                 (only.term_lists, jonly.term_lists)):
        np.testing.assert_array_equal(g.entries.numpy(),
                                      np.asarray(w.entries))
        np.testing.assert_array_equal(g.lengths.numpy(),
                                      np.asarray(w.lengths))
    res = hi.search_ivf(got, corpus.query_emb, corpus.query_tokens, kc=4,
                        top_r=50, device="cpu")
    jres = jhi.search_ivf(want, jnp.asarray(corpus.query_emb),
                          jnp.asarray(corpus.query_tokens), kc=4, top_r=50)
    np.testing.assert_array_equal(res.doc_ids.numpy(),
                                  np.asarray(jres.doc_ids))


def test_build_fails_fast(corpus):
    args = (0, corpus.doc_emb, corpus.doc_tokens, corpus.vocab_size)
    kw = dict(n_clusters=4, k1_terms=2, device="cpu")
    with pytest.raises(ValueError, match="unknown codec"):
        hi.build(*args, codec="sq9", **kw)
    with pytest.raises(ValueError, match="doc_namespaces must be"):
        hi.build(*args, doc_namespaces=np.zeros(3, np.int32), **kw)
    with pytest.raises(ValueError, match="non-negative"):
        hi.build(*args, doc_namespaces=-np.ones(1500, np.int32), **kw)
    with pytest.raises(ValueError, match="use_terms=True"):
        hi.build(*args, sparse=True, use_terms=False, **kw)
    # sparse=True is ported: the impact plane lies beside the term lists
    sparse = hi.build(*args, sparse=True, **kw)
    entries = sparse.term_lists.entries
    assert sparse.sparse_weights.shape == entries.shape
    assert bool((sparse.sparse_weights[entries == il.PAD_DOC] == 0).all())
    assert bool((sparse.sparse_weights[entries != il.PAD_DOC] > 0).all())


def test_full_unsupervised_build_reaches_the_reference_quality():
    """The port's own KMeans + BM25 + OPQ on the quickstart corpus
    (examples/quickstart.py) against the JAX build at equal widths and
    cost: R@100 and MRR@10 within 0.02, OPQ reconstruction MSE within
    10%; the sq8/refine/flat builds over the same lists keep the
    quickstart's codec ordering."""
    c = synthetic.generate(seed=0, n_docs=12_000, n_queries=500, hidden=64,
                           vocab_size=8192)
    kw = dict(n_clusters=192, k1_terms=12, codec="opq", pq_m=8, pq_k=256,
              cluster_capacity=256, term_capacity=128, kmeans_iters=10)
    want = jhi.build(jax.random.key(0), jnp.asarray(c.doc_emb),
                     jnp.asarray(c.doc_tokens), c.vocab_size, **kw)
    got = hi.build(0, c.doc_emb, c.doc_tokens, c.vocab_size, device="cpu",
                   **kw)
    assert hi.candidate_cost(got, 6, 8, 100) == jhi.candidate_cost(
        want, 6, 8, 100)
    res = hi.search(got, c.query_emb, c.query_tokens, kc=6, k2=8,
                    top_r=100, device="cpu")
    jres = jhi.search(want, jnp.asarray(c.query_emb),
                      jnp.asarray(c.query_tokens), kc=6, k2=8, top_r=100)
    ids, jids = res.doc_ids.numpy(), np.asarray(jres.doc_ids)
    r100, jr100 = (metrics.recall_at_k(ids, c.qrels, 100),
                   jmetrics.recall_at_k(jids, c.qrels, 100))
    mrr, jmrr = (metrics.mrr_at_k(ids, c.qrels, 10),
                 jmetrics.mrr_at_k(jids, c.qrels, 10))
    assert abs(r100 - jr100) <= 0.02, (r100, jr100)
    assert abs(mrr - jmrr) <= 0.02, (mrr, jmrr)
    mse = float(pq.opq_reconstruction_mse(got.codec_params,
                                          torch.from_numpy(c.doc_emb)))
    jmse = float(jpq.opq_reconstruction_mse(want.codec_params,
                                            jnp.asarray(c.doc_emb)))
    assert abs(mse - jmse) <= 0.1 * jmse, (mse, jmse)
    # the codec sweep of the quickstart over the port's own lists
    recall = {}
    for spec in ("flat", "sq8", "refine:sq8:4"):
        idx = hi.build(0, c.doc_emb, c.doc_tokens, c.vocab_size,
                       device="cpu", cluster_sel=got.cluster_sel,
                       doc_assign=got.doc_assign, **dict(kw, codec=spec))
        r = hi.search(idx, c.query_emb, c.query_tokens, kc=6, k2=8,
                      top_r=100, device="cpu")
        recall[spec] = metrics.recall_at_k(r.doc_ids, c.qrels, 100)
    assert recall["refine:sq8:4"] >= recall["flat"] - 0.01, recall
    assert recall["sq8"] >= r100 - 0.01, (recall, r100)


# --------------------------------------------------------------------------
# the serving CLI (build + serve)
# --------------------------------------------------------------------------

def test_serve_cli_builds_and_serves_with_tenant_isolation(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--docs", "2000", "--queries", "96",
                "--batch", "32", "--codec", "refine:sq8", "--namespaces",
                "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 96 queries in ")
    assert out[0].endswith(" q/s, 1 device)")
    assert out[1].startswith("filtered: 32 queries x 1/4 namespaces")
    assert out[1].endswith("tenant isolation OK")
    # --shards and --data-parallel are ported: mesh positions on the CPU
    for flag, layout in ((["--shards", "2"], "2 shard(s)"),
                         (["--shards", "2", "--data-parallel", "2"],
                          "(2, 2) mesh")):
        serve.main(["--device", "cpu", "--docs", "1000", "--queries", "64",
                    "--batch", "32", *flag])
        out = capsys.readouterr().out.splitlines()
        assert out[0].startswith("served 64 queries in ")
        assert out[0].endswith(f" q/s, {layout})")
    # --runtime is ported: serve through the micro-batching runtime
    serve.main(["--device", "cpu", "--docs", "1000", "--queries", "64",
                "--batch", "32", "--runtime", "--cache", "64",
                "--namespaces", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 64 queries in ")
    assert out[1].endswith("tenant isolation OK")
    assert out[2].startswith("runtime: 3 batches over buckets "
                             "[1, 2, 4, 8, 16, 32]")
    assert "programs/bucket {1: 1, 2: 1, 4: 1, 8: 1, 16: 1, 32: 1}" \
        in out[2] and "0 post-warmup programs" in out[2]
    # --mutable is ported: stream the last eighth in, delete, compact
    serve.main(["--device", "cpu", "--docs", "1000", "--queries", "64",
                "--batch", "32", "--mutable", "--delta-capacity", "256",
                "--namespaces", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 64 queries in ")
    assert out[1].endswith("tenant isolation OK")
    assert out[2].startswith("mutable: added 125, deleted 31, compacted "
                             "to 969 docs in ")
    # --fusion-weight is ported: build the impact plane, serve fused
    serve.main(["--device", "cpu", "--docs", "1000", "--queries", "64",
                "--batch", "32", "--fusion-weight", "0.5"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 64 queries in ")
    with pytest.raises(ValueError, match="fusion weight"):
        serve.main(["--device", "cpu", "--docs", "1000", "--queries", "32",
                    "--fusion-weight", "1.5"])
    with pytest.raises(ValueError, match="unknown codec"):
        serve.main(["--device", "cpu", "--codec", "sq9"])

"""Port parity of the search path: ``repro_torch`` search and ``Server``
on the CPU against ``repro.core.hybrid_index.search`` (both
``use_kernel`` settings), on indexes the JAX package built and saved
with ``save_index`` and the port read with ``load_index`` — for every
registered codec, the ``sq8`` and ``refine:*`` settings included.

The contract is the reference's own (DESIGN.md §11): dispatch ids,
candidate planes and ``n_candidates`` exact; top-R ids exact up to
swaps between documents whose scores lie within 1e-4, and exact in
order for the bitwise ``flat`` codec; scores within rtol=atol=1e-4.
The framework tie traps (top-k tie order, the two-key total order,
stable dedup, C < R padding) each have a pinned case below.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import bm25 as jbm25
from repro.core import cluster_selector as jcs
from repro.core import codecs as jcodecs
from repro.core import exec as jexec
from repro.core import hybrid_index as jhi
from repro.core import inverted_lists as jil
from repro.core import term_selector as jts
from repro.core.exec import filters as jfilters
from repro.data import synthetic
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import cluster_selector as cs
from repro_torch.core import codecs
from repro_torch.core import exec as qexec
from repro_torch.core import hybrid_index as hi
from repro_torch.core import inverted_lists as il
from repro_torch.core import metrics
from repro_torch.core import term_selector as ts
from repro_torch.core.exec import filters
from repro_torch.launch import serve

torch.set_num_threads(2)

TOL = 1e-4
N_NS = 5
WIDTHS = dict(kc=6, k2=8, top_r=100)        # the quickstart widths


@pytest.fixture(scope="module")
def corpus():
    return synthetic.generate(seed=0, n_docs=1500, n_queries=16, hidden=32,
                              vocab_size=512, n_topics=8)


#: index name → (codec spec, namespaces?); the sq8 and refine settings
#: reuse the opq index's KMeans (cluster_sel + doc_assign), the pattern
#: of examples/quickstart.py's codec sweep
SETTINGS = {"opq": ("opq", False), "pq": ("pq", False),
            "flat": ("flat", False), "opq_filtered": ("opq", True),
            "sq8": ("sq8", False), "refine_sq8": ("refine:sq8:4", False),
            "refine_pq": ("refine:pq:4", False),
            "refine_opq": ("refine:opq", False)}


@pytest.fixture(scope="module")
def indexes(corpus, tmp_path_factory):
    """name → (JAX index, port index loaded from its checkpoint)."""
    out = {}
    ns = (np.arange(1500) % N_NS).astype(np.int32)
    for name, (codec, filtered) in SETTINGS.items():
        reuse = ({} if name in ("opq", "pq", "flat", "opq_filtered") else
                 dict(cluster_sel=out["opq"][0].cluster_sel,
                      doc_assign=out["opq"][0].doc_assign))
        idx = jhi.build(jax.random.key(0), jnp.asarray(corpus.doc_emb),
                        jnp.asarray(corpus.doc_tokens), corpus.vocab_size,
                        n_clusters=16, k1_terms=4, codec=codec, pq_m=4,
                        pq_k=64, cluster_capacity=128, term_capacity=32,
                        kmeans_iters=3, doc_namespaces=ns if filtered
                        else None, **reuse)
        path = jckpt.save_index(str(tmp_path_factory.mktemp(name)), 0, idx)
        out[name] = (idx, ckpt.load_index(path, device="cpu"))
    return out


def _filter(n):
    """Query b may see namespaces {b % N_NS, (b + 2) % N_NS}."""
    return jfilters.make_filter([(b % N_NS, (b + 2) % N_NS)
                                 for b in range(n)], N_NS)


def assert_topk_match(want_ids, want_s, got_ids, got_s, exact=False):
    """Top-R ids equal up to swaps between scores within TOL; scores
    within rtol=atol=TOL; ``exact`` demands the same ids in order."""
    want_ids, got_ids = np.asarray(want_ids), np.asarray(got_ids)
    want_s, got_s = np.asarray(want_s), np.asarray(got_s)
    np.testing.assert_allclose(got_s, want_s, rtol=TOL, atol=TOL)
    if exact:
        np.testing.assert_array_equal(got_ids, want_ids)
        return
    for b in np.flatnonzero((got_ids != want_ids).any(axis=1)):
        for p in np.flatnonzero(got_ids[b] != want_ids[b]):
            # the doc the port ranks at p sits in the reference list at a
            # score within TOL, or fell off its end within TOL of the cut
            where = np.flatnonzero(want_ids[b] == got_ids[b, p])
            ref = want_s[b, where[0]] if where.size else want_s[b, -1]
            assert abs(ref - got_s[b, p]) <= TOL + TOL * abs(ref), (b, p)


def _jax_stages(idx, qe, qt, kc, k2, use_kernel):
    cl, tm = jexec.dispatch(idx.cluster_sel, idx.term_sel, qe, qt, kc, k2,
                            use_kernel)
    return cl, tm, jexec.gather([jhi.base_source(idx)], cl, tm).cands


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_search_matches_reference(indexes, corpus, name, use_kernel):
    jidx, tidx = indexes[name]
    qe, qt = corpus.query_emb, corpus.query_tokens
    flt = _filter(len(qe)) if name.endswith("filtered") else None
    want = jhi.search(jidx, jnp.asarray(qe), jnp.asarray(qt),
                      use_kernel=use_kernel, filter=flt, **WIDTHS)
    got = hi.search(tidx, qe, qt, filter=flt, device="cpu", **WIDTHS)

    cl, tm, cands = _jax_stages(jidx, jnp.asarray(qe), jnp.asarray(qt),
                                WIDTHS["kc"], WIDTHS["k2"], use_kernel)
    tcl, ttm = qexec.dispatch(tidx.cluster_sel, tidx.term_sel,
                              torch.from_numpy(qe), torch.from_numpy(qt),
                              WIDTHS["kc"], WIDTHS["k2"])
    np.testing.assert_array_equal(tcl.numpy(), np.asarray(cl))
    np.testing.assert_array_equal(ttm.numpy(), np.asarray(tm))
    tcands = qexec.gather([hi.base_source(tidx)], tcl, ttm).cands
    np.testing.assert_array_equal(tcands.numpy(), np.asarray(cands))
    np.testing.assert_array_equal(got.n_candidates.numpy(),
                                  np.asarray(want.n_candidates))
    assert_topk_match(want.doc_ids, want.scores, got.doc_ids, got.scores,
                      exact=name == "flat")


@pytest.mark.parametrize("name", ["opq", "flat", "opq_filtered",
                                  "refine_sq8"])
def test_server_ragged_batch_matches_reference(indexes, corpus, name):
    jidx, tidx = indexes[name]
    n = 11                                            # < max_batch
    qe, qt = corpus.query_emb[:n], corpus.query_tokens[:n]
    filtered = name.endswith("filtered")
    allowed = [(b % N_NS, (b + 2) % N_NS) for b in range(n)]
    want = jhi.search(jidx, jnp.asarray(qe), jnp.asarray(qt),
                      filter=_filter(n) if filtered else None, **WIDTHS)
    server = serve.make_server(
        tidx, serve.ServeConfig(kc=6, k2=8, top_r=100, max_batch=16,
                                n_namespaces=N_NS if filtered else 0),
        device="cpu")
    got = server.query(qe, qt, namespaces=allowed if filtered else None)
    assert got.doc_ids.shape == (n, 100) and server.n_served == n
    np.testing.assert_array_equal(got.n_candidates.numpy(),
                                  np.asarray(want.n_candidates))
    assert_topk_match(want.doc_ids, want.scores, got.doc_ids, got.scores,
                      exact=name == "flat")
    if filtered:
        ids = got.doc_ids.numpy()
        for b in range(n):
            assert set(ids[b][ids[b] >= 0] % N_NS) <= set(allowed[b])


def test_search_with_fewer_candidates_than_r(indexes, corpus):
    """C = kc·128 + k2·32 = 160 < R = 300: the tail pads with PAD_DOC."""
    jidx, tidx = indexes["opq"]
    qe, qt = corpus.query_emb, corpus.query_tokens
    want = jhi.search(jidx, jnp.asarray(qe), jnp.asarray(qt), kc=1, k2=1,
                      top_r=300)
    got = hi.search(tidx, qe, qt, kc=1, k2=1, top_r=300, device="cpu")
    assert (got.doc_ids.numpy()[:, 160:] == il.PAD_DOC).all()
    np.testing.assert_array_equal(got.n_candidates.numpy(),
                                  np.asarray(want.n_candidates))
    assert_topk_match(want.doc_ids, want.scores, got.doc_ids, got.scores)


def test_ivf_and_term_only_and_cost_match_reference(indexes, corpus):
    jidx, tidx = indexes["pq"]
    qe, qt = corpus.query_emb, corpus.query_tokens
    for jfn, tfn, kw in ((jhi.search_ivf, hi.search_ivf,
                          dict(kc=4, top_r=50)),
                         (jhi.search_term_only, hi.search_term_only,
                          dict(k2=6, top_r=50))):
        want = jfn(jidx, jnp.asarray(qe), jnp.asarray(qt), **kw)
        got = tfn(tidx, qe, qt, device="cpu", **kw)
        np.testing.assert_array_equal(got.n_candidates.numpy(),
                                      np.asarray(want.n_candidates))
        assert_topk_match(want.doc_ids, want.scores, got.doc_ids,
                          got.scores)
    assert (hi.candidate_budget(tidx, 6, 8)
            == jhi.candidate_budget(jidx, 6, 8))
    assert (hi.candidate_cost(tidx, 6, 8, 100)
            == jhi.candidate_cost(jidx, 6, 8, 100))


@pytest.mark.parametrize("name", ["sq8", "refine_sq8", "refine_pq",
                                  "refine_opq"])
def test_quantized_checkpoints_load_with_the_reference_planes(indexes,
                                                              name):
    """The sq8 params and the fp16 refine plane arrive as the JAX build
    wrote them, and the codec's cost accounting agrees."""
    jidx, tidx = indexes[name]
    assert tidx.codec == SETTINGS[name][0]
    for key, plane in jidx.doc_planes.items():
        got = tidx.doc_planes[key].numpy()
        assert got.dtype == np.asarray(plane).dtype, key
        np.testing.assert_array_equal(got, np.asarray(plane))
    if "sq8" in name:
        for key in ("lo", "scale"):
            np.testing.assert_array_equal(
                tidx.codec_params[key].numpy(),
                np.asarray(jidx.codec_params[key]))
    spec = SETTINGS[name][0]
    assert (codecs.get(spec).bytes_per_doc(tidx.doc_planes)
            == jcodecs.get(spec).bytes_per_doc(jidx.doc_planes))
    for kc, k2, r in ((6, 8, 100), (2, 3, 10)):
        assert (hi.candidate_cost(tidx, kc, k2, r)
                == jhi.candidate_cost(jidx, kc, k2, r))


@pytest.mark.parametrize("spec", ["refine", "refine:sq8", "refine:opq:2",
                                  "refine:flat:1", "sq8"])
def test_codec_spec_grammar_matches_reference(spec):
    got, want = codecs.get(spec), jcodecs.get(spec)
    assert got.name == want.name
    assert got.refine_width(100) == want.refine_width(100)
    assert got.candidate_cost(5000, 100) == want.candidate_cost(5000, 100)


@pytest.mark.parametrize("spec,err", [("refine:pq:x", "refine[:base[:mult]]"),
                                      ("refine:pq:0", "mult must be >= 1"),
                                      ("refine:nope", "unknown codec"),
                                      ("sq9", "unknown codec")])
def test_codec_spec_errors_match_reference(spec, err):
    for get in (codecs.get, jcodecs.get):
        with pytest.raises(ValueError, match=re.escape(err)):
            get(spec)


def test_metrics_match_reference(indexes, corpus):
    from repro.core import metrics as jmetrics
    _, tidx = indexes["opq"]
    got = hi.search(tidx, corpus.query_emb, corpus.query_tokens,
                    device="cpu", **WIDTHS)
    ids = got.doc_ids.numpy()
    for k in (1, 10, 100):
        assert metrics.recall_at_k(ids, corpus.qrels, k) == pytest.approx(
            jmetrics.recall_at_k(ids, corpus.qrels, k))
        assert metrics.mrr_at_k(ids, corpus.qrels, k) == pytest.approx(
            jmetrics.mrr_at_k(ids, corpus.qrels, k))


# --------------------------------------------------------------------------
# framework tie traps
# --------------------------------------------------------------------------

def test_query_terms_tie_order_on_equal_avg_scores():
    """lax.top_k takes the lowest position first among equal s̄; a
    plain torch.topk promises no order."""
    rng = np.random.default_rng(1)
    avg = np.repeat(rng.random(8).astype(np.float32), 8)      # 8-way ties
    tokens = rng.integers(-1, 64, size=(12, 20)).astype(np.int32)
    tokens[:, 5] = tokens[:, 2]                               # repeats
    for k2 in (4, 8, 25):                                     # 25 > len
        want = jts.query_terms(jts.TermSelector(jnp.asarray(avg)),
                               jnp.asarray(tokens), k2)
        got = ts.query_terms(ts.TermSelector(torch.from_numpy(avg)),
                             torch.from_numpy(tokens), k2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    first = np.asarray(jbm25.first_occurrence_mask(jnp.asarray(tokens)))
    np.testing.assert_array_equal(
        ts.bm25.first_occurrence_mask(torch.from_numpy(tokens)).numpy(),
        first)
    assert not first[:, 5].any()


@pytest.mark.parametrize("use_kernel", [False, True])
def test_select_for_query_tie_order_on_duplicate_centroids(use_kernel):
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(20, 16)).astype(np.float32)
    emb = np.concatenate([emb, emb[::-1], emb])               # 3-way ties
    x = rng.normal(size=(9, 16)).astype(np.float32)
    want_i, want_s = jcs.select_for_query(
        jcs.ClusterSelector(jnp.asarray(emb)), jnp.asarray(x), 7,
        use_kernel=use_kernel)
    got_i, got_s = cs.select_for_query(
        cs.ClusterSelector(torch.from_numpy(emb)), torch.from_numpy(x), 7)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        cs.scores(cs.ClusterSelector(torch.from_numpy(emb)),
                  torch.from_numpy(x)).numpy(),
        np.asarray(jcs.scores(jcs.ClusterSelector(jnp.asarray(emb)),
                              jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def test_dedup_keeps_first_slot_of_candidates_shared_across_lists():
    rng = np.random.default_rng(3)
    docs = rng.integers(0, 40, size=(6, 90)).astype(np.int32)
    docs[:, 60:] = docs[:, :30]                       # cross-list repeats
    docs[rng.random(docs.shape) < 0.1] = il.PAD_DOC
    want = np.asarray(jil.dedup_mask(jnp.asarray(docs)))
    got = il.dedup_mask(torch.from_numpy(docs)).numpy()
    np.testing.assert_array_equal(got, want)
    lists = jil.build(np.arange(40), rng.integers(0, 5, 40), None, 5, 12)
    tlists = il.PaddedLists(torch.tensor(np.asarray(lists.entries)),
                            torch.tensor(np.asarray(lists.lengths)))
    disp = np.array([[0, 3, 3, -1], [4, 4, 1, 2]], np.int32)  # list twice
    np.testing.assert_array_equal(
        il.gather_candidates(tlists, torch.from_numpy(disp)).numpy(),
        np.asarray(jil.gather_candidates(lists, jnp.asarray(disp))))


@pytest.mark.parametrize("c,r", [(7, 12), (40, 12), (12, 12)])
def test_topk_by_score_total_order_and_padding(c, r):
    rng = np.random.default_rng(c)
    scores = rng.integers(0, 4, size=(5, c)).astype(np.float32)  # ties
    scores[rng.random(scores.shape) < 0.3] = -np.inf
    ids = rng.permutation(5 * c).reshape(5, c).astype(np.int32)
    ws, wi = jexec.topk_by_score(jnp.asarray(scores), jnp.asarray(ids), r)
    gs, gi = qexec.topk_by_score(torch.from_numpy(scores),
                                 torch.from_numpy(ids), r)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def test_bucketing_matches_reference():
    rng = np.random.default_rng(4)
    docs, lists = np.arange(300), rng.integers(-1, 17, 300)
    scores = rng.random(300)
    for sc, cap in ((scores, 9), (None, None)):
        want = jil.build(docs, lists, sc, 17, cap)
        got = il.build(docs, lists, sc, 17, cap, device="cpu")
        np.testing.assert_array_equal(got.entries.numpy(),
                                      np.asarray(want.entries))
        np.testing.assert_array_equal(got.lengths.numpy(),
                                      np.asarray(want.lengths))


def test_allowed_mask_matches_reference_on_uint32_words():
    rng = np.random.default_rng(5)
    n_ns = 70                                         # 3 words, bit 31 used
    allowed = [tuple(rng.choice(n_ns, 9, replace=False)) + (31, 63)
               for _ in range(4)]
    want_f = jfilters.make_filter(allowed, n_ns)
    ns_ids = rng.integers(-3, 100, size=(4, 50)).astype(np.int32)
    want = np.asarray(jfilters.allowed_mask(want_f, jnp.asarray(ns_ids)))
    got_f = filters.make_filter(allowed, n_ns, device="cpu")
    np.testing.assert_array_equal(got_f.numpy(),
                                  np.asarray(want_f).astype(np.int64))
    for words in (got_f, filters.as_words(np.asarray(want_f), "cpu")):
        got = filters.allowed_mask(words, torch.from_numpy(ns_ids)).numpy()
        np.testing.assert_array_equal(got, want)

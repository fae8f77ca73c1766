"""Port parity of streaming mutations (DESIGN.md §8): the port's
``MutableHybridIndex`` against the reference's ``repro.core.segments``,
for every registered codec, on mutable indexes the JAX package created
and saved with ``save_mutable`` and the port read with ``load_mutable``.

Tolerances: after the same ``add_docs`` the delta list entries, lengths,
codec planes and ``dropped_postings`` are exact and the eviction scores
within 1e-5; search against the reference (dense, namespace-filtered and
fused at weight 0.5) has ``n_candidates`` exact, ids equal up to swaps
between documents whose scores lie within 1e-4 and scores within
rtol=atol=1e-4 (DESIGN.md §11).  Inside the port, ``compact()`` equals
``hi.build`` over the survivors leaf for leaf and in search, bit for
bit.  The remaining cases are the reference's ``tests/test_segments.py``
single-device cases run on the port.
"""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import codecs as jcodecs
from repro.core import segments as jseg
from repro.core.exec import filters as jfilters
from repro.core.exec import fusion as jfusion
from repro.data import synthetic
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import codecs
from repro_torch.core import exec as qexec
from repro_torch.core import hybrid_index as hi
from repro_torch.core import segments as seg
from repro_torch.launch import serve

torch.set_num_threads(2)

TOL = 1e-4
SCORE_TOL = 1e-5                     # eviction scores after add_docs
N_NS = 4
HOLD = 80
KW = dict(n_clusters=16, k1_terms=4, pq_m=4, pq_k=64, cluster_capacity=96,
          term_capacity=48, kmeans_iters=3, sparse=True)
#: 8-slot delta lists overflow under HOLD adds, so eviction runs
DELTA = dict(delta_capacity=128, delta_cluster_capacity=8,
             delta_term_capacity=8)
SEARCH = dict(kc=4, k2=4, top_r=15)
CODECS = codecs.registered()
#: ids the reference deletes before its second checkpoint: a quarter of
#: the streamed docs and three base docs
BASE_DOOMED = [3, 4, 7]


@pytest.fixture(scope="module")
def corpus():
    return synthetic.generate(seed=0, n_docs=1500, n_queries=24, hidden=32,
                              vocab_size=512, n_topics=8)


def _ns(n):
    return (np.arange(n) % N_NS).astype(np.int32)


@pytest.fixture(scope="module")
def saved(corpus, tmp_path_factory):
    """codec → (reference mutable index after adds and deletes, its
    fresh checkpoint, its mutated checkpoint, the streamed ids)."""
    out = {}
    c = corpus
    ns = _ns(len(c.doc_emb))
    for codec in CODECS:
        mut = jseg.MutableHybridIndex.create(
            jax.random.key(0), c.doc_emb[:-HOLD], c.doc_tokens[:-HOLD],
            c.vocab_size, doc_namespaces=ns[:-HOLD], codec=codec,
            **DELTA, **KW)
        d = tmp_path_factory.mktemp(codec)
        fresh = jckpt.save_mutable(str(d / "fresh"), 0, mut)
        ids = mut.add_docs(c.doc_emb[-HOLD:], c.doc_tokens[-HOLD:],
                           namespaces=ns[-HOLD:])
        mut.delete_docs(ids[:HOLD // 4])
        mut.delete_docs(BASE_DOOMED)
        mutated = jckpt.save_mutable(str(d / "mutated"), 1, mut)
        out[codec] = (mut, fresh, mutated, ids)
    return out


def _load(path, codec=None):
    return ckpt.load_mutable(path, seed=0, codec=codec, device="cpu")


def _filter(n):
    """Query b may see namespaces {b % N_NS, (b + 2) % N_NS}."""
    return jfilters.make_filter([(b % N_NS, (b + 2) % N_NS)
                                 for b in range(n)], N_NS)


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


def assert_equal_results(a, b, what=None):
    for x, y in ((a.doc_ids, b.doc_ids), (a.scores, b.scores),
                 (a.n_candidates, b.n_candidates)):
        assert torch.equal(x, y), what


def assert_same_index(a, b):
    la, lb = hi.index_leaves(a), hi.index_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    assert a.codec == b.codec
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------

def test_registered_codecs_match_reference():
    assert CODECS == jcodecs.registered()


@pytest.mark.parametrize("codec", CODECS)
def test_add_docs_gives_the_reference_delta_planes(saved, corpus, codec):
    """The port, loaded from the reference's fresh checkpoint, streams
    the same documents through the frozen selectors into the same delta
    lists (with the same evictions), codec planes and counters."""
    jmut, fresh, _, jids = saved[codec]
    c = corpus
    tmut = _load(fresh, codec)
    assert tmut.delta_count == 0 and tmut.base.codec == codec
    ids = tmut.add_docs(c.doc_emb[-HOLD:], c.doc_tokens[-HOLD:],
                        namespaces=_ns(len(c.doc_emb))[-HOLD:])
    np.testing.assert_array_equal(ids, jids)
    want, got = jmut.state_tree()["delta"], tmut.state_tree()["delta"]
    assert sorted(want) == sorted(got)
    for k in ("cluster_entries", "cluster_lengths", "term_entries",
              "term_lengths", "assign", "ns", "emb", "tokens"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
    for k in ("cluster_scores", "term_scores"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                   rtol=SCORE_TOL, atol=SCORE_TOL)
    assert sorted(got["planes"]) == sorted(want["planes"])
    for k, v in want["planes"].items():
        assert got["planes"][k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got["planes"][k], np.asarray(v), k)
    assert tmut.dropped_postings == jmut.dropped_postings
    # more postings came to some 8-slot lists than they hold, so the
    # eviction rule ran on both sides
    sent = np.bincount(got["assign"][:HOLD], minlength=KW["n_clusters"])
    assert sent.max() > DELTA["delta_cluster_capacity"]
    np.testing.assert_array_equal(
        got["cluster_lengths"],
        np.minimum(sent, DELTA["delta_cluster_capacity"]))
    assert tmut.epoch == 1


@pytest.mark.parametrize("codec", CODECS)
def test_search_on_a_loaded_checkpoint_matches_reference(saved, corpus,
                                                         codec):
    """Dense, namespace-filtered and fused (weight 0.5) search over the
    reference's base + delta + tombstones."""
    jmut, _, mutated, _ = saved[codec]
    c = corpus
    tmut = _load(mutated, codec)
    assert (tmut.delta_count, tmut.n_deleted, tmut.epoch) == (
        jmut.delta_count, jmut.n_deleted, jmut.epoch)
    np.testing.assert_array_equal(tmut.tombstones, jmut.tombstones)
    qe, qt = c.query_emb, c.query_tokens
    jq = (jnp.asarray(qe), jnp.asarray(qt))
    flt = _filter(len(qe))
    for kw, jkw in (({}, {}),
                    (dict(filter=flt), dict(filter=flt)),
                    (dict(fusion=qexec.FusionSpec(weight=0.5)),
                     dict(fusion=jfusion.FusionSpec(weight=0.5)))):
        assert_topk_match(jmut.search(*jq, **SEARCH, **jkw),
                          tmut.search(qe, qt, **SEARCH, **kw))


@pytest.mark.parametrize("codec", CODECS)
def test_deleted_ids_never_surface(saved, corpus, codec):
    """Delete ids that surfaced, base and delta alike: they are gone from
    the dense path (through refine on the refine codec), the fused path
    and the sparse path alone (weight 0.0)."""
    _, _, mutated, _ = saved[codec]
    c = corpus
    tmut = _load(mutated)
    qe, qt = c.query_emb, c.query_tokens
    paths = (None, qexec.FusionSpec(weight=0.5), qexec.FusionSpec(weight=0.0))
    seen = np.unique(np.concatenate([
        tmut.search(qe, qt, fusion=f, **SEARCH).doc_ids.numpy().ravel()
        for f in paths]))
    seen = seen[seen >= 0]
    doomed = np.concatenate([seen[seen < tmut.n_base][::7][:10],
                             seen[seen >= tmut.n_base][:10]])
    assert (doomed >= tmut.n_base).any() and (doomed < tmut.n_base).any()
    n_live = tmut.n_live
    tmut.delete_docs(doomed)
    assert tmut.n_live < n_live
    for f in paths:
        ids = tmut.search(qe, qt, fusion=f, **SEARCH).doc_ids.numpy()
        assert not np.isin(ids, doomed).any(), f
        assert not tmut.is_deleted(ids[ids >= 0]).any(), f


# --------------------------------------------------------------------------
# compaction (inside the port)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("codec", CODECS)
def test_compact_equals_rebuild(saved, corpus, codec):
    """compact() is hi.build over the survivors with the same seed: leaf
    for leaf, in search bit for bit, and as mutable state (epoch apart,
    which survives compaction by design)."""
    c = corpus
    tmut = _load(saved[codec][2])
    compacted = tmut.compact()
    emb, tok = tmut.surviving_corpus()
    ns = tmut.surviving_namespaces()
    assert emb.shape[0] == tmut.n_live == compacted.n_base
    np.testing.assert_array_equal(
        ns, tmut.namespaces_of(tmut.survivors()))
    rebuilt = hi.build(0, emb, tok, c.vocab_size, codec=codec,
                       doc_namespaces=ns, device="cpu", **KW)
    assert_same_index(compacted.base, rebuilt)
    for f in (None, qexec.FusionSpec(weight=0.5)):
        assert_equal_results(
            compacted.search(c.query_emb, c.query_tokens, fusion=f,
                             **SEARCH),
            hi.search(rebuilt, c.query_emb, c.query_tokens, fusion=f,
                      device="cpu", **SEARCH), f)
    fresh = seg.MutableHybridIndex.create(
        0, emb, tok, c.vocab_size, doc_namespaces=ns, codec=codec,
        device="cpu", **DELTA, **KW)
    a, b = compacted.state_extra(), fresh.state_extra()
    assert a.pop("epoch") == tmut.epoch + 1 and b.pop("epoch") == 0
    assert a == b
    ta, tb = compacted.state_tree(), fresh.state_tree()
    assert_same_index(ta.pop("base"), tb.pop("base"))
    fa = jax.tree_util.tree_flatten_with_path(ta)[0]
    fb = jax.tree_util.tree_flatten_with_path(tb)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        np.testing.assert_array_equal(x, y, jax.tree_util.keystr(p))


@pytest.mark.parametrize("codec", CODECS)
def test_compact_renumbers_survivors_contiguously(saved, codec):
    tmut = _load(saved[codec][2])
    surv = tmut.survivors()
    assert surv.size == tmut.n_live
    assert not np.isin(surv, np.flatnonzero(tmut.tombstones)).any()
    assert not np.isin(surv, BASE_DOOMED).any()
    compacted = tmut.compact()
    assert compacted.n_base == surv.size
    assert compacted.delta_count == 0 and compacted.n_deleted == 0


# --------------------------------------------------------------------------
# the remaining reference cases
# --------------------------------------------------------------------------

@pytest.mark.parametrize("codec", CODECS)
def test_add_overflow_raises_delta_full(saved, corpus, codec):
    c = corpus
    tmut = _load(saved[codec][1])
    ns = _ns(tmut.delta_capacity)
    tmut.add_docs(c.doc_emb[:tmut.delta_capacity],
                  c.doc_tokens[:tmut.delta_capacity], namespaces=ns)
    with pytest.raises(seg.DeltaFull):
        tmut.add_docs(c.doc_emb[:1], c.doc_tokens[:1], namespaces=0)
    assert tmut.delta_fill == 1.0
    # search is still fine at exactly full
    res = tmut.search(c.query_emb, c.query_tokens, **SEARCH)
    assert res.doc_ids.shape == (len(c.query_emb), SEARCH["top_r"])


@pytest.mark.parametrize("codec", CODECS)
def test_add_and_delete_validate_their_arguments(saved, corpus, codec):
    c = corpus
    tmut = _load(saved[codec][2])
    for bad in ([tmut.n_docs], [-1]):
        with pytest.raises(ValueError, match="out of range"):
            tmut.delete_docs(bad)
    with pytest.raises(ValueError, match="namespaces="):
        tmut.add_docs(c.doc_emb[:2], c.doc_tokens[:2])
    with pytest.raises(ValueError, match="non-negative"):
        tmut.add_docs(c.doc_emb[:2], c.doc_tokens[:2], namespaces=-1)
    with pytest.raises(ValueError, match="row mismatch"):
        tmut.add_docs(c.doc_emb[:2], c.doc_tokens[:3], namespaces=0)
    with pytest.raises(ValueError, match="wider"):
        tmut.add_docs(c.doc_emb[:1], np.zeros((1, 999), np.int32),
                      namespaces=0)
    with pytest.raises(ValueError, match="selector"):
        seg.MutableHybridIndex.create(
            0, c.doc_emb[:100], c.doc_tokens[:100], c.vocab_size,
            doc_assign=np.zeros(100, np.int32), codec=codec, device="cpu",
            **KW)
    plain = seg.MutableHybridIndex.create(
        0, c.doc_emb[:300], c.doc_tokens[:300], c.vocab_size,
        delta_capacity=4, codec=codec, device="cpu",
        **dict(KW, n_clusters=4))
    with pytest.raises(ValueError, match="unfiltered"):
        plain.add_docs(c.doc_emb[:1], c.doc_tokens[:1], namespaces=0)
    with pytest.raises(ValueError, match="no namespace planes"):
        plain.namespaces_of([0])
    # the reference's default delta capacities
    assert plain.families()[1] == (4, 4)
    assert (plain.candidate_budget(4, 4)
            == 4 * (plain.base.cluster_lists.capacity + 4)
            + 4 * (plain.base.term_lists.capacity + 4))


@pytest.mark.parametrize("codec", CODECS)
def test_epoch_counts_mutations_and_caches_planes(saved, corpus, codec):
    c = corpus
    tmut = _load(saved[codec][2])
    e = tmut.epoch
    first = tmut.delta_segment()
    tmut.search(c.query_emb, c.query_tokens, **SEARCH)
    assert tmut.epoch == e and tmut.delta_segment() is first
    tmut.add_docs(c.doc_emb[:3], c.doc_tokens[:3], namespaces=1)
    assert tmut.epoch == e + 1 and tmut.delta_segment() is not first
    tmut.delete_docs([0])
    tmut.delete_docs([0])                       # idempotent, still counted
    assert tmut.epoch == e + 3 and tmut.is_deleted([0]).all()
    assert tmut.compact().epoch == e + 4
    assert tmut.delta_segment().capacity == tmut.delta_capacity
    assert tmut.delta_segment().doc_assign.device.type == "cpu"


@pytest.mark.parametrize("codec", CODECS)
def test_needs_compact_watermarks(saved, codec):
    tmut = _load(saved[codec][2])
    fill, ratio = tmut.delta_fill, tmut.tombstone_ratio
    assert fill == HOLD / tmut.delta_capacity
    assert ratio == (HOLD // 4 + len(BASE_DOOMED)) / tmut.n_docs
    assert not tmut.needs_compact()                  # 0 disables both
    assert tmut.needs_compact(fill_watermark=fill)
    assert not tmut.needs_compact(fill_watermark=fill + 0.01)
    assert tmut.needs_compact(tombstone_watermark=ratio)
    assert not tmut.needs_compact(fill_watermark=0.99,
                                  tombstone_watermark=0.99)


def test_load_mutable_refusals(saved, tmp_path):
    jmut, fresh, _, _ = saved["sq8"]
    with pytest.raises(ValueError, match="codec"):
        _load(fresh, codec="flat")
    plain = jckpt.save_index(str(tmp_path / "plain"), 0, jmut.base)
    with pytest.raises(ValueError, match="mutable"):
        _load(plain)
    # a checkpoint of a supervised index needs its selectors
    sup = tmp_path / "sup"
    shutil.copytree(fresh, sup)
    manifest = json.loads((sup / "manifest.json").read_text())
    manifest["extra"]["mutable"]["sup_selectors"] = True
    (sup / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="selectors="):
        _load(str(sup))


@pytest.mark.parametrize("codec", CODECS)
def test_mutable_server_roundtrip_and_watermarks(saved, corpus, codec):
    """MutableServer: ragged batches, deletes honoured, manual compact,
    then auto-compaction at each watermark; the immutable server and
    make_server(mutable=True) refuse mutation."""
    c = corpus
    ns = _ns(len(c.doc_emb))
    cfg = serve.ServeConfig(kc=4, k2=4, top_r=10, max_batch=32,
                            mutable=True, n_namespaces=N_NS)
    s = serve.make_mutable_server(_load(saved[codec][1]), cfg, device="cpu")
    r0 = s.query(c.query_emb[:20], c.query_tokens[:20],
                 namespaces=[b % N_NS for b in range(20)])
    assert r0.doc_ids.shape == (20, 10) and s.epoch == 0
    ids = s.add(c.doc_emb[-HOLD:], c.doc_tokens[-HOLD:],
                namespaces=ns[-HOLD:])
    s.delete(ids[:10])
    r1 = s.query(c.query_emb[:11], c.query_tokens[:11])
    assert r1.doc_ids.shape == (11, 10)
    assert not np.isin(r1.doc_ids.numpy(), ids[:10]).any()
    assert s.epoch == 2
    s.compact()
    assert s.epoch == 3 and s.index is s.mut.base
    r2 = s.query(c.query_emb, c.query_tokens)
    assert s.n_served == 20 + 11 + len(c.query_emb)
    assert int(r2.doc_ids.max()) < s.mut.n_base      # renumbered
    n_base = s.mut.n_base
    # the fill watermark compacts once half the delta is used ...
    cfg.compact_fill_watermark = 0.5
    s.add(c.doc_emb[:63], c.doc_tokens[:63], namespaces=ns[:63])
    assert s.mut.delta_count == 63 and s.mut.n_base == n_base
    s.add(c.doc_emb[63:64], c.doc_tokens[63:64], namespaces=ns[63:64])
    assert s.mut.delta_count == 0 and s.mut.n_base == n_base + 64
    # ... the tombstone watermark once a tenth of the docs is deleted
    cfg.compact_fill_watermark = 0.0
    cfg.compact_tombstone_watermark = 0.1
    n_base = s.mut.n_base
    s.delete(np.arange(n_base // 20))
    assert s.mut.n_deleted == n_base // 20
    s.delete(np.arange(n_base // 20, n_base // 10 + 1))
    assert s.mut.n_deleted == 0 and s.mut.n_base == n_base - n_base // 10 - 1
    imm = serve.make_server(s.mut.base, serve.ServeConfig(kc=4, k2=4),
                            device="cpu")
    with pytest.raises(RuntimeError, match="immutable"):
        imm.add(c.doc_emb[:1], c.doc_tokens[:1])
    with pytest.raises(ValueError, match="make_mutable_server"):
        serve.make_server(s.mut.base, cfg, device="cpu")

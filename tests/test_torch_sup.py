"""Port parity of HI²_sup indexing: ``repro_torch.launch.train``
(``SupSelectors``, ``build_sup_index``) on the CPU against
``repro.launch.train`` on parameters the reference trained.

The module fixture runs the reference's ``train_hi2_sup`` for 100 steps
on a small synthetic corpus with ``fit``'s checkpointing on, and carries
the trained ``DistillParams`` into the port both in memory
(``distill_params_from_numpy``) and from the saved checkpoint
(``load_distill``).

Tolerances: position scores rtol=atol=1e-4 (two frameworks' f32 matmul
orders through a 2-layer encoder); s̄ 1e-5 relative (an f32 sum of up
to n such scores); cluster lists, φ(D) and codes exact; term lists
exact except that documents whose K₁ᵀ-th and next term lie within 1e-4
are listed and set aside, and entries whose scores lie within 1e-4 may
swap places in a score-ordered list; search ids equal
up to swaps between scores within 1e-4; the ``opq`` index, whose
codebooks the port draws from its own generator, within 0.02 R@100 /
MRR@10 of the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hybrid_index as jhi
from repro.core import metrics as jmetrics
from repro.core import term_selector as jts
from repro.data import synthetic as jsynthetic
from repro.launch import train as jtrain
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import hybrid_index as hi
from repro_torch.core import metrics
from repro_torch.core import term_selector as ts
from repro_torch.launch import train

torch.set_num_threads(2)

TOL = 1e-4
SBAR_REL = 1e-5
K1 = 4
BUILD = dict(k1_terms=K1, pq_m=8, pq_k=64, cluster_capacity=256,
             term_capacity=48)
WIDTHS = dict(kc=4, k2=6, top_r=100)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    corpus = jsynthetic.generate(seed=0, n_docs=1500, n_queries=200,
                                 hidden=32, vocab_size=512, n_topics=16,
                                 make_model_b=False)
    cfg = jtrain.SupTrainConfig(n_clusters=16, encoder_layers=2,
                                encoder_dim=64, encoder_heads=4,
                                n_steps=100, batch_queries=8, n_negatives=3,
                                kmeans_iters=4, seed=0)
    ckpt_dir = str(tmp_path_factory.mktemp("sup_fit"))
    params, jcfg, assign, losses = jtrain.train_hi2_sup(
        corpus, cfg, log_every=0, ckpt_dir=ckpt_dir)
    assert losses[-1] < losses[0]
    enc_cfg = ckpt.enc_cfg_from_fields(dataclasses.asdict(jcfg))
    leaves = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
              jax.tree_util.tree_flatten_with_path(params)[0]}
    tparams = ckpt.distill_params_from_numpy(leaves, enc_cfg, device="cpu")
    return dict(corpus=corpus, params=params, jcfg=jcfg,
                assign=np.asarray(assign), enc_cfg=enc_cfg,
                tparams=tparams, ckpt_dir=ckpt_dir, leaves=leaves)


def _padded_tokens(corpus):
    """The corpus tokens with PAD tails and holes (the encoder applies
    no key-padding mask, so PADs change every position's state)."""
    tokens = corpus.doc_tokens[:300].copy()
    tokens[::3, 50:] = -1
    tokens[1::5, ::9] = -1
    return tokens


def _flat(params):
    return [t for t in (params.cluster_embeddings, *params.term_mlp)] + \
        _flat_tree(params.encoder)


def _flat_tree(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat_tree(tree[k])]
    return [tree]


def test_load_distill_reads_the_fit_checkpoint(trained):
    """The fit checkpoint (``{"params", "opt"}``) carries the same
    parameters as the in-memory tree, leaf for leaf, both given the
    step directory and the manager directory."""
    want = _flat(trained["tparams"])
    assert len(want) == len(trained["leaves"])
    for path in (trained["ckpt_dir"], f"{trained['ckpt_dir']}/step_00000100"):
        got = _flat(ckpt.load_distill(path, trained["enc_cfg"],
                                      device="cpu"))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    np.testing.assert_array_equal(
        trained["tparams"].encoder["layers"]["mlp"]["w_up"]["w"].numpy(),
        trained["leaves"][".encoder['layers']['mlp']['w_up']['w']"])
    with pytest.raises(ValueError, match="shape"):
        ckpt.distill_params_from_numpy(
            trained["leaves"], dataclasses.replace(trained["enc_cfg"],
                                                   n_layers=3), device="cpu")


def _jax_position_scores(trained, tokens, encode_batch=512):
    sel = jtrain.SupSelectors(params=trained["params"],
                              enc_cfg=trained["jcfg"],
                              encode_batch=encode_batch)
    return np.asarray(sel.position_scores(jnp.asarray(tokens)))


@pytest.mark.parametrize("encode_batch", [7, 512])
def test_position_scores_match_reference(trained, encode_batch):
    corpus = trained["corpus"]
    sel = train.SupSelectors(trained["tparams"], trained["enc_cfg"],
                             encode_batch=encode_batch, device="cpu")
    for tokens in (corpus.doc_tokens[:300], _padded_tokens(corpus)):
        got = sel.position_scores(tokens).numpy()
        want = _jax_position_scores(trained, tokens)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        assert (got[tokens < 0] == 0).all() and (got[tokens >= 0] > 0).all()


def test_build_inputs_match_reference(trained):
    corpus = trained["corpus"]
    sel = train.SupSelectors(trained["tparams"], trained["enc_cfg"],
                             device="cpu")
    got = sel.build_inputs(corpus.doc_emb, corpus.doc_tokens,
                           corpus.vocab_size)
    jsel = jtrain.SupSelectors(params=trained["params"],
                               enc_cfg=trained["jcfg"])
    want = jsel.build_inputs(jnp.asarray(corpus.doc_emb),
                             jnp.asarray(corpus.doc_tokens),
                             corpus.vocab_size)
    np.testing.assert_array_equal(got["doc_assign"].numpy(),
                                  np.asarray(want["doc_assign"]))
    np.testing.assert_array_equal(got["cluster_sel"].embeddings.numpy(),
                                  np.asarray(want["cluster_sel"].embeddings))
    np.testing.assert_allclose(got["term_pos_scores"].numpy(),
                               np.asarray(want["term_pos_scores"]),
                               rtol=TOL, atol=TOL)
    w = np.asarray(want["term_sel"].avg_scores)
    np.testing.assert_allclose(got["term_sel"].avg_scores.numpy(), w,
                               rtol=SBAR_REL, atol=SBAR_REL * np.abs(w).max())


def _ref_term_scores(trained):
    """The reference's per-document top terms: ({(doc, term): score},
    the documents whose K₁ᵀ-th and next-best term lie within TOL, which
    either framework may split either way)."""
    corpus = trained["corpus"]
    pos = _jax_position_scores(trained, corpus.doc_tokens)
    ids, scores = (np.asarray(a) for a in jts.doc_terms(
        jnp.asarray(corpus.doc_tokens), jnp.asarray(pos), K1 + 1))
    ties = set(np.flatnonzero(scores[:, K1 - 1] - scores[:, K1] <= TOL))
    score_of = {(d, t): scores[d, j] for d in range(len(ids))
                for j, t in enumerate(ids[d, :K1])}
    return score_of, ties


def _assert_term_lists_match(trained, got, want) -> None:
    """Term lists equal, except that the term choice of near-tie
    documents is set aside and entries may swap where their reference
    scores lie within TOL (lists are ordered by score)."""
    score_of, ties = _ref_term_scores(trained)
    print(f"near-tie documents set aside: {sorted(ties)}")
    assert len(ties) < 0.05 * len(trained["assign"])
    ge, gl = (a.numpy() for a in got)
    we, wl = (np.asarray(a) for a in want)
    assert ge.shape == we.shape
    for t in range(we.shape[0]):
        g = [d for d in ge[t, :gl[t]] if d not in ties]
        w = [d for d in we[t, :wl[t]] if d not in ties]
        assert len(g) == len(w), t
        for gd, wd in zip(g, w):
            if gd != wd:
                assert abs(score_of[(gd, t)] - score_of[(wd, t)]) <= TOL, (
                    t, gd, wd)


def _build_both(trained, codec, **kw):
    corpus = trained["corpus"]
    want = jtrain.build_sup_index(corpus, trained["params"], trained["jcfg"],
                                  jnp.asarray(trained["assign"]),
                                  codec=codec, **BUILD, **kw)
    got = train.build_sup_index(corpus, trained["tparams"],
                                trained["enc_cfg"], trained["assign"],
                                codec=codec, device="cpu", **BUILD, **kw)
    return want, got


@pytest.mark.parametrize("codec", ["flat", "sq8"])
def test_build_sup_index_matches_reference_leaf_for_leaf(trained, codec):
    want, got = _build_both(trained, codec)
    assert got.codec == codec
    exact = {"cluster_sel": (got.cluster_sel.embeddings,
                             want.cluster_sel.embeddings),
             "doc_assign": (got.doc_assign, want.doc_assign),
             "cluster_lists.entries": (got.cluster_lists.entries,
                                       want.cluster_lists.entries),
             "cluster_lists.lengths": (got.cluster_lists.lengths,
                                       want.cluster_lists.lengths)}
    for key, plane in want.doc_planes.items():
        exact[f"doc_planes.{key}"] = (got.doc_planes[key], plane)
    for key in (want.codec_params or {}):
        exact[f"codec_params.{key}"] = (got.codec_params[key],
                                        want.codec_params[key])
    for name, (g, w) in exact.items():
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    w = np.asarray(want.term_sel.avg_scores)
    np.testing.assert_allclose(got.term_sel.avg_scores.numpy(), w,
                               rtol=SBAR_REL, atol=SBAR_REL * np.abs(w).max())
    _assert_term_lists_match(trained, got.term_lists, want.term_lists)


def _assert_ids_match(want, got):
    """Top-R ids equal up to swaps between scores within TOL."""
    wi, ws = np.asarray(want.doc_ids), np.asarray(want.scores)
    gi, gs = got.doc_ids.numpy(), got.scores.numpy()
    np.testing.assert_allclose(gs, ws, rtol=TOL, atol=TOL)
    for b, p in zip(*np.nonzero(gi != wi)):
        where = np.flatnonzero(wi[b] == gi[b, p])
        ref = ws[b, where[0]] if where.size else ws[b, -1]
        assert abs(ref - gs[b, p]) <= TOL + TOL * abs(ref), (b, p)


@pytest.mark.parametrize("codec", ["flat", "sq8"])
def test_sup_search_matches_reference(trained, codec):
    corpus = trained["corpus"]
    want, got = _build_both(trained, codec, prune_gamma=0.9)
    np.testing.assert_array_equal(got.term_lists.lengths.numpy(),
                                  np.asarray(want.term_lists.lengths))
    assert got.term_lists.entries.shape == want.term_lists.entries.shape
    assert int(got.term_lists.lengths.max()) < BUILD["term_capacity"]
    jres = jhi.search(want, jnp.asarray(corpus.query_emb),
                      jnp.asarray(corpus.query_tokens), **WIDTHS)
    res = hi.search(got, corpus.query_emb, corpus.query_tokens,
                    device="cpu", **WIDTHS)
    np.testing.assert_array_equal(res.n_candidates.numpy(),
                                  np.asarray(jres.n_candidates))
    _assert_ids_match(jres, res)


def test_opq_sup_index_reaches_the_reference_quality(trained):
    corpus = trained["corpus"]
    want, got = _build_both(trained, "opq")
    qe, qt = corpus.query_emb, corpus.query_tokens
    ids = hi.search(got, qe, qt, device="cpu", **WIDTHS).doc_ids.numpy()
    jids = np.asarray(jhi.search(want, jnp.asarray(qe), jnp.asarray(qt),
                                 **WIDTHS).doc_ids)
    for k, fn, jfn in ((100, metrics.recall_at_k, jmetrics.recall_at_k),
                       (10, metrics.mrr_at_k, jmetrics.mrr_at_k)):
        got_m, want_m = fn(ids, corpus.qrels, k), jfn(jids, corpus.qrels, k)
        assert abs(got_m - want_m) <= 0.02, (k, got_m, want_m)


def test_unported_training_and_sparse_raise(trained):
    for fn in (train.fit, train.train_hi2_sup):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            fn()
    with pytest.raises(NotImplementedError, match="not yet ported"):
        train.build_sup_index(trained["corpus"], trained["tparams"],
                              trained["enc_cfg"], trained["assign"],
                              k1_terms=2, sparse=True, device="cpu")


def test_term_mlp_scores_match_reference():
    rng = np.random.default_rng(2)
    h = rng.normal(size=(3, 9, 16)).astype(np.float32)
    tokens = rng.integers(-1, 20, (3, 9)).astype(np.int32)
    w = [rng.normal(size=s).astype(np.float32)
         for s in ((16, 16), (16,), (16, 1), (1,))]
    got = ts.mlp_token_scores(ts.TermMLP(*map(torch.from_numpy, w)),
                              torch.from_numpy(h), torch.from_numpy(tokens))
    want = jts.mlp_token_scores(jts.TermMLP(*map(jnp.asarray, w)),
                                jnp.asarray(h), jnp.asarray(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert (got.numpy()[tokens == -1] == 0).all()

"""The port's sharded and 2-D mesh serving (``repro_torch.launch.serve``:
``ShardedServer``, ``MeshServer``; DESIGN.md §6, §12) on CPU mesh
positions, over an index the JAX package built (``sq8``, with
namespaces, as ``tests/test_mesh_serving.py`` builds its own):

  · ``ShardedServer`` equals ``Server`` bit for bit on a full and a
    ragged batch, and counts ``n_served``;
  · ``MeshServer`` on every (data, model) geometry of four positions
    equals ``Server`` bit for bit, unfiltered, filtered, fused and
    ragged; it refuses a batch that does not divide over its data axis;
  · the shard-loss drill of DESIGN.md §12 without the runtime (on the
    port's own build of the same corpus):
    checkpoint, eject shard 0, results ``partial`` with nothing from the
    lost range and equal to a ``MutableServer`` with that range
    tombstoned, the last shard refused, rejoin bit-identical to before;
    ``note_shard_latency`` ejects a straggler;
  · a ``MeshServer`` checkpoint restores through the JAX package's
    ``restore_index`` leaf for leaf, and the JAX package's checkpoint of
    its own partition restores into a port ``MeshServer``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import hybrid_index as jhi
from repro.core import sharded_index as jshi
from repro.data import synthetic
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import hybrid_index as hi
from repro_torch.core import segments as seg
from repro_torch.core import sharded_index as shi
from repro_torch.launch import serve

torch.set_num_threads(2)

N_DOCS = 3_000
N_NS = 4
KW = dict(n_clusters=32, k1_terms=6, codec="sq8", cluster_capacity=96,
          term_capacity=48, kmeans_iters=5)


@pytest.fixture(scope="module")
def corpus():
    return synthetic.generate(seed=0, n_docs=N_DOCS, n_queries=48,
                              hidden=32, vocab_size=1024, n_topics=16)


@pytest.fixture(scope="module")
def built(corpus, tmp_path_factory):
    """(JAX index, its save_index path, the port's index loaded from it)."""
    jidx = jhi.build(jax.random.key(0), jnp.asarray(corpus.doc_emb),
                     jnp.asarray(corpus.doc_tokens), corpus.vocab_size,
                     doc_namespaces=np.arange(N_DOCS) % N_NS, sparse=True,
                     **KW)
    path = jckpt.save_index(str(tmp_path_factory.mktemp("sq8")), 0, jidx)
    return jidx, path, ckpt.load_index(path, device="cpu")


@pytest.fixture(scope="module")
def base(built):
    return serve.Server(built[2], serve.ServeConfig(
        max_batch=16, n_namespaces=N_NS), device="cpu")


def _equal(a, b):
    for name in ("doc_ids", "scores", "n_candidates"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _want(n):
    return [i % N_NS for i in range(n)]


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_server_equals_server(built, base, corpus, n_shards):
    srv = serve.make_server(built[2], serve.ServeConfig(
        max_batch=16, n_shards=n_shards, n_namespaces=N_NS), device="cpu")
    assert type(srv) is serve.ShardedServer and srv.n_replicas == 1
    assert srv.device == torch.device("cpu")
    qe, qt = corpus.query_emb, corpus.query_tokens
    for lo, hi_ in ((0, 16), (16, 27)):      # full batch + ragged tail
        out = srv.query(qe[lo:hi_], qt[lo:hi_])
        assert out.partial is False
        _equal(base.query(qe[lo:hi_], qt[lo:hi_]), out)
    _equal(base.query(qe[:16], qt[:16], namespaces=_want(16)),
           srv.query(qe[:16], qt[:16], namespaces=_want(16)))
    assert srv.n_served == 16 + 11 + 16
    srv.mesh.close()


@pytest.mark.parametrize("geometry", [(2, 1), (4, 1), (2, 2), (1, 4)],
                         ids=lambda g: f"data{g[0]}-model{g[1]}")
def test_mesh_server_equals_server(built, base, corpus, geometry):
    d, m = geometry
    srv = serve.MeshServer(built[2], serve.ServeConfig(
        max_batch=16, n_shards=m, data_parallel=d, n_namespaces=N_NS),
        device="cpu")
    assert srv.mesh.shape == {"data": d, "shards": m}
    assert srv.n_replicas == d and srv.epoch == 0 and not srv.partial
    qe, qt = corpus.query_emb, corpus.query_tokens
    out = srv.query(qe[:16], qt[:16])
    assert out.partial is False
    _equal(base.query(qe[:16], qt[:16]), out)
    _equal(base.query(qe[:16], qt[:16], namespaces=_want(16)),
           srv.query(qe[:16], qt[:16], namespaces=_want(16)))
    _equal(base.query(qe[16:27], qt[16:27]), srv.query(qe[16:27], qt[16:27]))
    base.set_fusion(0.5)
    srv.set_fusion(0.5)
    try:
        _equal(base.query(qe[:16], qt[:16]), srv.query(qe[:16], qt[:16]))
    finally:
        base.set_fusion(None)
    srv.mesh.close()


def test_mesh_server_rejects_indivisible_batch():
    with pytest.raises(ValueError, match="divide"):
        serve.MeshServer(None, serve.ServeConfig(max_batch=16,
                                                 data_parallel=3))


def test_shard_loss_degrades_and_rejoins_bit_identically(corpus, tmp_path):
    # the port's own build: the oracle below builds the same base
    index = hi.build(0, corpus.doc_emb, corpus.doc_tokens, corpus.vocab_size,
                     device="cpu", **KW)
    srv = serve.MeshServer(index, serve.ServeConfig(
        max_batch=16, n_shards=2, data_parallel=2), device="cpu")
    qe, qt = corpus.query_emb[:16], corpus.query_tokens[:16]
    full = srv.query(qe, qt)
    path = srv.checkpoint(str(tmp_path))
    srv.eject_shard(0)
    srv.eject_shard(0)                        # idempotent
    assert srv.partial and srv.epoch == 1
    assert srv.lost_doc_ranges() == [(0, 1500)]
    degraded = srv.query(qe, qt)
    assert degraded.partial is True
    ids = degraded.doc_ids.numpy()
    assert (ids[ids >= 0] >= 1500).all()      # nothing from the lost range
    # the oracle: the full corpus with the lost range tombstoned (the
    # same build, so the same base index)
    mut = seg.MutableHybridIndex.create(
        0, corpus.doc_emb, corpus.doc_tokens, corpus.vocab_size,
        delta_capacity=16, device="cpu", **KW)
    mut.delete_docs(np.arange(0, 1500))
    oracle = serve.make_mutable_server(mut, serve.ServeConfig(
        max_batch=16, mutable=True), device="cpu")
    want = oracle.query(qe, qt)
    assert torch.equal(want.doc_ids, degraded.doc_ids)
    assert torch.equal(want.scores, degraded.scores)
    with pytest.raises(ValueError, match="last healthy"):
        srv.eject_shard(1)
    srv.rejoin(path)
    assert not srv.partial and srv.epoch == 2 and srv.lost_doc_ranges() == []
    restored = srv.query(qe, qt)
    assert restored.partial is False
    _equal(full, restored)
    srv.mesh.close()


def test_straggler_feed_ejects_through_the_server(built, corpus):
    srv = serve.MeshServer(built[2], serve.ServeConfig(
        max_batch=16, n_shards=2, data_parallel=1), device="cpu")
    for _ in range(10):                    # a healthy median
        for shard in (0, 1):
            assert not srv.note_shard_latency(shard, 0.1)
    ejected = False
    for _ in range(5):                     # shard 1 at 10x the median
        srv.note_shard_latency(0, 0.1)
        if srv.note_shard_latency(1, 1.0):
            ejected = True
            break
    assert ejected and srv.health.lost == [1] and srv.partial
    res = srv.query(corpus.query_emb[:16], corpus.query_tokens[:16])
    assert res.partial is True
    ids = res.doc_ids.numpy()
    assert (ids[ids >= 0] < 1500).all()    # only shard 0's range
    srv.mesh.close()


def _jleaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_mesh_checkpoints_cross_both_ways(built, corpus, tmp_path):
    jidx, _, tidx = built
    srv = serve.MeshServer(tidx, serve.ServeConfig(
        max_batch=16, n_shards=2, data_parallel=2), device="cpu")
    qe, qt = corpus.query_emb[:16], corpus.query_tokens[:16]
    full = srv.query(qe, qt)
    # the port's checkpoint through the reference's restore_index
    path = srv.checkpoint(str(tmp_path / "port"), step=5)
    like = jshi.partition(jidx, 2)
    back = jckpt.restore_index(path, like)
    got, want = _jleaves(back), _jleaves(like)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w), p
    assert back.codec == "sq8" and back.n_docs == N_DOCS
    # the reference's checkpoint of its partition into the port
    jpath = jckpt.save_index(str(tmp_path / "jax"), 0, like)
    restored = ckpt.restore_index(jpath, shi.to_meta(srv.index))
    assert isinstance(restored, shi.ShardedHybridIndex)
    assert restored.placement is None and restored.max_postings == (
        tidx.max_postings)
    for (p, g), (_, w) in zip(hi.index_leaves(restored), want):
        assert np.array_equal(np.asarray(g), w), p
    srv.eject_shard(1)
    srv.rejoin(jpath)
    _equal(full, srv.query(qe, qt))
    with pytest.raises(ValueError, match="codec"):
        ckpt.restore_index(jpath, dataclasses.replace(
            shi.to_meta(srv.index), codec="opq"))
    srv.mesh.close()

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
    its own partition restores into a port ``MeshServer``;
  · the serving runtime over ``ShardedServer``, ``MeshServer`` and
    ``ShardedMutableServer``: the quantum ladder, one program per bucket
    per mesh, rows equal to ``query``'s, every replica dispatched, and
    the drill through the runtime (every row ``partial`` while a shard
    is out, no cached full row replayed);
  · ``mesh_serving.py``'s CPU smoke with ``--check``.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys

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


# --------------------------------------------------------------------------
# the runtime over a mesh (DESIGN.md §10, §12)
# --------------------------------------------------------------------------

def _layout(kind, built, corpus):
    """A mesh server of four CPU positions over the JAX-built index (the
    mutable one over its corpus, all but the last 64 docs)."""
    cfg = dict(max_batch=16, n_namespaces=N_NS)
    if kind == "sharded":
        return serve.make_server(built[2], serve.ServeConfig(
            n_shards=4, **cfg), device="cpu")
    if kind == "mesh":
        return serve.make_server(built[2], serve.ServeConfig(
            n_shards=2, data_parallel=2, **cfg), device="cpu")
    mut = seg.MutableHybridIndex.create(
        0, corpus.doc_emb[:-64], corpus.doc_tokens[:-64], corpus.vocab_size,
        delta_capacity=64, doc_namespaces=np.arange(N_DOCS - 64) % N_NS,
        device="cpu", **KW)
    return serve.make_mutable_server(mut, serve.ServeConfig(
        n_shards=2, data_parallel=2, mutable=True, **cfg), device="cpu")


@pytest.mark.parametrize("kind", ["sharded", "mesh", "sharded_mutable"])
def test_runtime_over_a_mesh_one_program_per_bucket_round_robin(
        built, corpus, kind):
    """One program per bucket per mesh (not per replica), none while
    serving; computed rows round-robin over every data-axis replica; the
    rows equal the server's ``query`` bit for bit, filtered too."""
    from repro_torch.launch import runtime as rt_mod
    srv = _layout(kind, built, corpus)
    d = srv.n_replicas
    assert d == (1 if kind == "sharded" else 2)
    rt = rt_mod.ServingRuntime(srv, rt_mod.RuntimeConfig(linger_ms=50.0))
    assert rt.buckets == ((1, 2, 4, 8, 16) if d == 1 else (2, 4, 8, 16))
    rt.warmup(32, corpus.query_tokens.shape[1])
    assert rt.warm_traces == {b: 1 for b in rt.buckets}
    assert rt.stats()["captured"] == {b: False for b in rt.buckets}
    qe, qt = corpus.query_emb, corpus.query_tokens
    with rt:
        for n in (1, 3, 16, 7, 2):
            got = rt.query(qe[:n], qt[:n], timeout=120)
            want = srv.query(qe[:n], qt[:n])
            for name in ("doc_ids", "scores", "n_candidates"):
                np.testing.assert_array_equal(getattr(got, name),
                                              getattr(want, name).numpy())
            assert got.partial is False
        got = rt.query(qe[:16], qt[:16], namespaces=_want(16), timeout=120)
        _equal(srv.query(qe[:16], qt[:16], namespaces=_want(16)),
               type(got)(*(torch.as_tensor(x) for x in got[:3])))
        rt.assert_one_compile_per_bucket()
        disp = rt.stats()["replica_dispatch"]
        assert set(disp) == set(range(d)) and all(v > 0
                                                  for v in disp.values())
        assert sum(disp.values()) == rt.n_served == 45
    srv.mesh.close()


def test_the_runtime_carries_the_drill_through_a_degraded_mesh(corpus,
                                                              tmp_path):
    """The shard-loss drill through the runtime (the reference's
    ``tests/test_mesh_serving.py`` case): after an eject every row is
    ``partial`` and equal to the degraded ``query``, the epoch bump keeps
    the cache from replaying full rows, and after the rejoin the rows
    are full and equal to those before the failure."""
    from repro_torch.launch import runtime as rt_mod
    index = hi.build(0, corpus.doc_emb, corpus.doc_tokens, corpus.vocab_size,
                     device="cpu", **KW)
    srv = serve.MeshServer(index, serve.ServeConfig(
        max_batch=16, n_shards=2, data_parallel=2), device="cpu")
    qe, qt = corpus.query_emb[:16], corpus.query_tokens[:16]
    full = srv.query(qe, qt)
    rt = rt_mod.ServingRuntime(srv, rt_mod.RuntimeConfig(cache_size=64,
                                                         linger_ms=50.0))
    rt.warmup(32, qt.shape[1])
    with rt:
        pre = rt.query(qe, qt, timeout=120)
        assert pre.partial is False
        path = srv.checkpoint(str(tmp_path))
        srv.eject_shard(0)
        degraded = srv.query(qe, qt)
        hits0 = rt.cache.hits
        via_rt = rt.query(qe, qt, timeout=120)
        assert via_rt.partial is True and rt.cache.hits == hits0
        np.testing.assert_array_equal(via_rt.doc_ids,
                                      degraded.doc_ids.numpy())
        np.testing.assert_array_equal(via_rt.scores, degraded.scores.numpy())
        ids = via_rt.doc_ids
        assert (ids[ids >= 0] >= 1500).all()
        srv.rejoin(path)
        post = rt.query(qe, qt, timeout=120)
        assert post.partial is False
        np.testing.assert_array_equal(post.doc_ids, full.doc_ids.numpy())
        np.testing.assert_array_equal(post.scores, full.scores.numpy())
    srv.mesh.close()


# --------------------------------------------------------------------------
# the mesh_serving benchmark's CPU smoke
# --------------------------------------------------------------------------

def _returned_keys(func) -> set:
    """Keys of the last dict literal ``func`` returns."""
    ret = [n.value for n in ast.walk(func)
           if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    return {k.value for k in ret[-1].keys if k is not None}


def test_mesh_serving_smoke_check_passes_on_cpu(tmp_path):
    """``python -m repro_torch.benchmarks.mesh_serving --smoke --check
    --device cpu`` exits 0 (ids identical across the five geometries, one
    program per bucket per mesh and none while serving, runtime rows
    equal to direct ones, every replica dispatched, the (2, 2) drill's
    partial-result contract through the runtime, the emulated (2, 1)
    gate), writes only its ``--out`` file, and reports the reference's
    keys (plus ``device``, and per geometry ``positions_per_card`` and
    ``captured``)."""
    out = tmp_path / "mesh.json"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.mesh_serving",
         "--smoke", "--check", "--device", "cpu", "--out", str(out)],
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")),
        capture_output=True, text=True, timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert os.listdir(tmp_path) == ["mesh.json"]
    report = json.loads(out.read_text())
    assert json.loads(proc.stdout) == report
    tree = ast.parse(open(os.path.join(root, "benchmarks",
                                       "mesh_serving.py")).read())
    funcs = {n.name: n for n in ast.walk(tree)
             if isinstance(n, ast.FunctionDef)}
    main_report = [n.value for n in ast.walk(funcs["main"])
                   if isinstance(n, ast.Assign)
                   and getattr(n.targets[0], "id", None) == "report"
                   and isinstance(n.value, ast.Dict)][0]
    assert set(report) == {k.value for k in main_report.keys} | {"device"}
    want_geo = (_returned_keys(funcs["run_geometry"]) - {"_fingerprint"}
                | {"positions_per_card", "captured"})
    assert set(report["geometries"]) == {"1x1", "2x1", "4x1", "1x2", "2x2"}
    for g, rep in report["geometries"].items():
        assert set(rep) == want_geo, g
        assert rep["runtime_bit_identical"] and rep["dispatch_all_replicas"]
        assert set(rep["warm_compiles"].values()) == {1}
        assert rep["post_warmup_compiles"] == 0
        assert rep["positions_per_card"] is None and not rep["captured"]
    assert report["geometries"]["2x2"]["buckets"] == [2, 4, 8, 16, 32]
    assert report["doc_ids_identical_across_geometries"]
    assert report["speedup_emulated_2x1"] >= 1.6
    drill = report["failover"]
    assert set(drill) == _returned_keys(funcs["run_drill"])
    assert drill["runtime_partial_flagged"] and drill["rejoin_bit_identical"]
    assert drill["epoch_bumps"] == 2


@pytest.mark.parametrize("per_card", [None, 2])
def test_mesh_serving_scaling_gate_holds_emulated_devices_only(per_card):
    """``check`` applies the reference's emulated (2, 1) >= 1.6x gate
    where the positions are emulated devices (``positions_per_card``
    None, the CPU run) and not where they share one card, whose reading
    (0.65x in a smoke run on an H100) ``check_scaling`` still reports;
    the result contracts hold on both."""
    from repro_torch.benchmarks import mesh_serving
    geo = {"positions_per_card": per_card, "warm_compiles": {"2": 1},
           "post_warmup_compiles": 0, "runtime_bit_identical": True,
           "dispatch_all_replicas": True}
    report = {"geometries": {g: dict(geo) for g in ("1x1", "2x1")},
              "doc_ids_identical_across_geometries": True,
              "speedup_emulated_2x1": 0.65,
              "failover": dict.fromkeys(
                  ("partial_flagged", "runtime_partial_flagged",
                   "lost_range_excluded", "degraded_differs",
                   "restored_not_partial", "rejoin_bit_identical"), True)}
    scaling = mesh_serving.check_scaling(report)
    assert len(scaling) == 1 and "0.65x" in scaling[0]
    assert mesh_serving.emulated(report) is (per_card is None)
    assert mesh_serving.check(report) == (scaling if per_card is None
                                          else [])
    report["failover"]["rejoin_bit_identical"] = False
    assert "failover drill: rejoin_bit_identical is False" in \
        mesh_serving.check(report)

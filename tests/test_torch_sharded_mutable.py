"""The port's sharded mutable index and server
(``repro_torch.core.segments.ShardedMutableIndex``,
``repro_torch.launch.serve.ShardedMutableServer``; DESIGN.md §6, §8,
§12) on CPU mesh positions:

  · ``ShardedMutableIndex.search`` equals the port's single-device
    ``MutableHybridIndex.search`` bit for bit (ids, scores,
    ``n_candidates``) for every codec × {no filter, filter} × {dense,
    fused at 0.5}, at S ∈ {2, 3, 4} and on a (2, 2) mesh, fresh, after
    streamed adds and after deletes, and after ``compact()`` equal to the
    compacted single-device index (the cases of the reference's
    ``tests/test_segments.py``, ``test_exec.py``, ``test_fusion.py`` and
    ``test_tune.py`` on the sharded mutable path);
  · adds land in the owning shard's planes, the tail slots of
    ⌈capacity / S⌉ stay unreachable, a sharded ``n_candidates`` stays
    within the mutable candidate budget, and each position's delta
    planes keep their addresses across add/delete;
  · ``ShardedMutableServer`` (1-D and (2, 2)) equals ``MutableServer``
    through add, delete and compact, and ``make_mutable_server`` picks
    it;
  · one subprocess runs the reference's ``ShardedMutableIndex`` over
    four emulated devices after adds and deletes and saves the index
    with ``save_mutable``; the port loads it and matches under DESIGN.md
    §11 (``n_candidates`` exact, ids up to near-tie swaps, scores within
    rtol=atol=1e-4).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.data import synthetic
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import codecs
from repro_torch.core import exec as qexec
from repro_torch.core import segments as seg
from repro_torch.core import sharded_index as shi
from repro_torch.core.exec import filters
from repro_torch.core.inverted_lists import PAD_DOC
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve

torch.set_num_threads(2)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DOCS = 1_501
N_NS = 4
HOLD = 80
TOL = 1e-4
KW = dict(n_clusters=16, k1_terms=4, pq_m=4, pq_k=64, cluster_capacity=64,
          term_capacity=32, kmeans_iters=3, sparse=True)
#: 100 slots: ⌈100 / 3⌉ = 34 leaves two tail slots at S = 3; 8-slot
#: delta lists overflow under HOLD adds, so eviction runs
DELTA = dict(delta_capacity=100, delta_cluster_capacity=8,
             delta_term_capacity=8)
SEARCH = dict(kc=4, k2=4, top_r=15)
GEOMETRIES = ((1, 2), (1, 3), (1, 4), (2, 2))


@pytest.fixture(scope="module")
def corpus():
    return synthetic.generate(seed=0, n_docs=N_DOCS, n_queries=16,
                              hidden=32, vocab_size=512, n_topics=8)


def _ns(n):
    return (np.arange(n) % N_NS).astype(np.int32)


@pytest.fixture(scope="module")
def fresh(corpus):
    """codec → an empty-delta mutable index over all but the last HOLD
    docs, with namespaces and the impact plane; tests mutate copies."""
    c = corpus
    return {codec: seg.MutableHybridIndex.create(
        0, c.doc_emb[:-HOLD], c.doc_tokens[:-HOLD], c.vocab_size,
        doc_namespaces=_ns(N_DOCS)[:-HOLD], codec=codec, device="cpu",
        **DELTA, **KW) for codec in codecs.registered()}


def _copy(mut):
    return seg.MutableHybridIndex.from_state(mut.state_tree(),
                                             mut.state_extra(), seed=0)


@pytest.fixture(scope="module")
def meshes():
    made = {(d, m): mesh_mod.make_serving_mesh(d, m, devices=["cpu"] * d * m)
            if d > 1 else shi.make_shard_mesh(m, devices=["cpu"] * m)
            for d, m in GEOMETRIES}
    yield made
    for mesh in made.values():
        mesh.close()


def _sharded(mut, meshes, geometry):
    d, m = geometry
    return seg.ShardedMutableIndex(mut, m, meshes[geometry],
                                   data_axis="data" if d > 1 else None)


def _equal(a, b, what=None):
    for name in ("doc_ids", "scores", "n_candidates"):
        assert torch.equal(getattr(a, name), getattr(b, name)), (what, name)


def _filter(n):
    return filters.make_filter([(b % N_NS, (b + 1) % N_NS)
                                for b in range(n)], N_NS, device="cpu")


# --------------------------------------------------------------------------
# sharded mutable == single-device mutable, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
@pytest.mark.parametrize("filtered", [False, True],
                         ids=["unfiltered", "filtered"])
@pytest.mark.parametrize("codec", codecs.registered())
def test_sharded_mutable_equals_single_device(fresh, corpus, meshes, codec,
                                              filtered, fused):
    c = corpus
    mut = _copy(fresh[codec])
    sharded = {g: _sharded(mut, meshes, g) for g in GEOMETRIES}
    kw = dict(SEARCH, filter=_filter(16) if filtered else None,
              fusion=qexec.FusionSpec(0.5) if fused else None)

    def check(state):
        want = mut.search(c.query_emb, c.query_tokens, **kw)
        for g, smut in sharded.items():
            _equal(want, smut.search(c.query_emb, c.query_tokens, **kw),
                   (state, g))
        return want

    check("fresh")
    ids = mut.add_docs(c.doc_emb[-HOLD:], c.doc_tokens[-HOLD:],
                       namespaces=_ns(N_DOCS)[-HOLD:])
    assert mut.dropped_postings > 0               # eviction ran
    check("added")
    mut.delete_docs(ids[:20])
    mut.delete_docs([5, 6, 7])
    want = check("deleted")
    assert not np.isin(want.doc_ids.numpy(), np.r_[ids[:20], 5, 6, 7]).any()
    if filtered:
        got = want.doc_ids.numpy()
        for b in range(16):
            row = got[b][got[b] >= 0]
            assert np.isin(mut.namespaces_of(row),
                           [b % N_NS, (b + 1) % N_NS]).all(), b


@pytest.mark.parametrize("codec", codecs.registered())
def test_compacted_sharded_equals_compacted_single_device(fresh, corpus,
                                                          meshes, codec):
    """``compact()`` on the sharded index shards the compacted host index
    over the same mesh: dense, filtered and fused searches equal the
    single-device compacted index's."""
    c = corpus
    mut = _copy(fresh[codec])
    smut = _sharded(mut, meshes, (2, 2))
    ids = smut.add_docs(c.doc_emb[-HOLD:], c.doc_tokens[-HOLD:],
                        namespaces=_ns(N_DOCS)[-HOLD:])
    smut.delete_docs(np.r_[ids[:20], 5, 6, 7])
    scomp = smut.compact()
    comp = mut.compact()
    assert scomp.mesh is smut.mesh and scomp.data_axis == "data"
    assert scomp.mut.n_base == comp.n_base == N_DOCS - 23
    assert scomp.epoch == comp.epoch == mut.epoch + 1
    for kw in (dict(SEARCH), dict(SEARCH, filter=_filter(16)),
               dict(SEARCH, fusion=qexec.FusionSpec(0.5))):
        _equal(comp.search(c.query_emb, c.query_tokens, **kw),
               scomp.search(c.query_emb, c.query_tokens, **kw))


def test_adds_land_in_the_owning_shards_planes(fresh, corpus, meshes):
    """Each shard's delta lists hold only global ids of its own slot
    range, every added doc is posted somewhere, and the tail slots of
    ⌈capacity / S⌉ (S = 3: 102 rows for 100 slots) hold zeros no entry
    points at."""
    c = corpus
    mut = _copy(fresh["flat"])
    smut = _sharded(mut, meshes, (1, 3))
    assert smut.dper == 34
    ids = smut.add_docs(c.doc_emb[-60:], c.doc_tokens[-60:],
                        namespaces=_ns(60))
    shards = smut.owning_shard(ids)
    assert shards.tolist() == [0] * 34 + [1] * 26
    assert (smut.owning_shard(np.arange(0, mut.n_base, 97))
            == np.arange(0, mut.n_base, 97) // smut.per).all()
    split = smut.split_delta()
    n_base = mut.n_base
    posted = []
    for s in range(3):
        for plane in ("cluster_entries", "term_entries"):
            e = split[plane][s]
            mine = e[e != PAD_DOC]
            lo = n_base + s * smut.dper
            assert ((mine >= lo) & (mine < lo + smut.dper)).all(), (plane, s)
            posted.append(mine)
    assert np.isin(ids, np.concatenate(posted)).all()
    tail = split["doc_planes"]["emb"][2, 100 - 2 * 34:]
    assert tail.shape[0] == 2 and not tail.any()
    assert split["tomb_delta"].shape == (3, 34)
    assert split["tomb_base"].shape == (3, smut.per)


def test_sharded_candidates_stay_within_the_mutable_budget(fresh, corpus,
                                                           meshes):
    c = corpus
    for codec in ("opq", "refine"):
        mut = _copy(fresh[codec])
        mut.add_docs(c.doc_emb[-HOLD:], c.doc_tokens[-HOLD:],
                     namespaces=_ns(HOLD))
        budget = mut.candidate_budget(4, 4)
        for g in GEOMETRIES:
            got = _sharded(mut, meshes, g).search(
                c.query_emb, c.query_tokens, kc=4, k2=4, top_r=16)
            assert int(got.n_candidates.max()) <= budget, (codec, g)


def test_position_planes_keep_their_addresses(fresh, corpus, meshes):
    """add_docs / delete_docs copy each epoch into the tensors of the
    first sync (no new planes, so a captured graph stays valid);
    compact() makes new ones."""
    c = corpus
    mut = _copy(fresh["opq"])
    smut = _sharded(mut, meshes, (2, 2))
    smut.search(c.query_emb, c.query_tokens, **SEARCH)

    def ptrs(index):
        out = []
        seg._tree_map(lambda t: out.append(t.data_ptr()), index._delta)
        return out

    before = ptrs(smut)
    assert len(smut._delta) == 2                  # (shard, device) pairs
    ids = smut.add_docs(c.doc_emb[-8:], c.doc_tokens[-8:],
                        namespaces=_ns(8))
    smut.delete_docs(ids[:2])
    smut.sync_device()
    assert ptrs(smut) == before
    assert smut._delta[(0, torch.device("cpu"))]["tomb_delta"][:2].all()
    assert int(smut._delta[(0, torch.device("cpu"))]
               ["cluster_lengths"].sum()) == 8
    assert smut.epoch == mut.epoch
    comp = smut.compact()
    comp.sync_device()
    assert not set(ptrs(comp)) & set(before)


def test_sharded_mutable_refuses_what_it_cannot_serve(fresh, corpus,
                                                      meshes):
    c = corpus
    mut = _copy(fresh["flat"])
    with pytest.raises(ValueError, match="2-D mesh passed in"):
        seg.ShardedMutableIndex(mut, 2, data_axis="data")
    with pytest.raises(ValueError, match="not 4 shards"):
        seg.ShardedMutableIndex(mut, 4, meshes[(1, 2)])
    with pytest.raises(ValueError, match="does not divide over 2"):
        _sharded(mut, meshes, (2, 2)).search(c.query_emb[:3],
                                             c.query_tokens[:3], **SEARCH)
    plain = seg.MutableHybridIndex.create(
        0, c.doc_emb[:600], c.doc_tokens[:600], c.vocab_size,
        delta_capacity=16, codec="flat", device="cpu", **KW)
    with pytest.raises(ValueError, match="doc_namespaces"):
        seg.ShardedMutableIndex(plain, 2, meshes[(1, 2)]).search(
            c.query_emb, c.query_tokens, filter=_filter(16), **SEARCH)
    # without a mesh, positions follow the index: the CPU here
    own = seg.ShardedMutableIndex(plain, 2)
    assert [str(d) for d in own.mesh.devices.flat] == ["cpu", "cpu"]
    _equal(plain.search(c.query_emb, c.query_tokens, **SEARCH),
           own.search(c.query_emb, c.query_tokens, **SEARCH))
    own.mesh.close()


# --------------------------------------------------------------------------
# ShardedMutableServer == MutableServer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("geometry", [(1, 2), (2, 2)],
                         ids=["sharded2", "mesh2x2"])
def test_sharded_mutable_server_equals_mutable_server(fresh, corpus,
                                                      geometry):
    c = corpus
    d, m = geometry
    cfg = dict(max_batch=16, mutable=True, n_namespaces=N_NS,
               fusion_weight=0.5)
    ref = serve.make_mutable_server(_copy(fresh["opq"]), serve.ServeConfig(
        **cfg), device="cpu")
    srv = serve.make_mutable_server(_copy(fresh["opq"]), serve.ServeConfig(
        n_shards=m, data_parallel=d, **cfg), device="cpu")
    assert type(srv) is serve.ShardedMutableServer
    assert srv.n_replicas == d and srv.mesh.shape["shards"] == m
    assert srv.mut.data_axis == ("data" if d > 1 else None)
    assert (srv.kc, srv.k2) == (ref.kc, ref.k2)
    qe, qt = c.query_emb, c.query_tokens
    want = [i % N_NS for i in range(16)]

    def check():
        _equal(ref.query(qe, qt), srv.query(qe, qt))
        _equal(ref.query(qe[:6], qt[:6]), srv.query(qe[:6], qt[:6]))
        _equal(ref.query(qe, qt, namespaces=want),
               srv.query(qe, qt, namespaces=want))

    check()
    for s in (ref, srv):
        ids = s.add(c.doc_emb[-HOLD:], c.doc_tokens[-HOLD:],
                    namespaces=_ns(N_DOCS)[-HOLD:])
        s.delete(ids[:16])
    assert srv.epoch == ref.epoch
    check()
    ref.compact()
    srv.compact()
    assert srv.index is srv.mut.base and srv.index.n_docs == N_DOCS - 16
    check()
    assert srv.n_served == ref.n_served
    srv.mesh.close()


def test_sharded_mutable_server_compacts_at_its_watermark(fresh, corpus):
    c = corpus
    srv = serve.make_mutable_server(_copy(fresh["pq"]), serve.ServeConfig(
        max_batch=16, mutable=True, n_shards=2, n_namespaces=N_NS,
        compact_fill_watermark=0.5), device="cpu")
    srv.add(c.doc_emb[-40:], c.doc_tokens[-40:], namespaces=_ns(40))
    assert srv.mut.mut.delta_count == 40
    srv.add(c.doc_emb[-HOLD:-40], c.doc_tokens[-HOLD:-40],
            namespaces=_ns(40))
    assert srv.mut.mut.delta_count == 0 and srv.index.n_docs == N_DOCS
    with pytest.raises(ValueError, match="divide over 2"):
        serve.ShardedMutableServer(_copy(fresh["pq"]), serve.ServeConfig(
            max_batch=15, mutable=True, n_shards=2, data_parallel=2),
            device="cpu")
    srv.mesh.close()


# --------------------------------------------------------------------------
# the reference's sharded mutable search over four emulated devices
# --------------------------------------------------------------------------

_REFERENCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.checkpoint import checkpoint as jckpt
from repro.core import exec as qexec, segments as seg
from repro.core.exec import filters
from repro.data import synthetic

assert jax.device_count() == 4
out = sys.argv[1]
c = synthetic.generate(seed=0, n_docs=%(n)d, n_queries=16, hidden=32,
                       vocab_size=512, n_topics=8)
ns = (np.arange(%(n)d) %% %(ns)d).astype(np.int32)
hold = %(hold)d
mut = seg.MutableHybridIndex.create(
    jax.random.key(0), c.doc_emb[:-hold], c.doc_tokens[:-hold],
    c.vocab_size, doc_namespaces=ns[:-hold], codec="opq", **%(delta)r,
    **%(kw)r)
ids = mut.add_docs(c.doc_emb[-hold:], c.doc_tokens[-hold:],
                   namespaces=ns[-hold:])
mut.delete_docs(ids[:20]); mut.delete_docs([5, 6, 7])
jckpt.save_mutable(out + "/mut", 0, mut)
smut = seg.ShardedMutableIndex(mut, 4)
qe, qt = jnp.asarray(c.query_emb), jnp.asarray(c.query_tokens)
flt = filters.make_filter([(b %% %(ns)d, (b + 1) %% %(ns)d)
                           for b in range(16)], %(ns)d)
res = {}
for name, extra in (("dense", {}), ("filtered", {"filter": flt}),
                    ("fused", {"fusion": qexec.FusionSpec(0.5)})):
    res[name] = smut.search(qe, qt, **%(search)r, **extra)
np.savez(out + "/results.npz", **{
    f"{k}_{f}": np.asarray(getattr(r, f)) for k, r in res.items()
    for f in ("doc_ids", "scores", "n_candidates")})
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_sharded_mutable"))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
               "count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(_ROOT, "src"))
    script = _REFERENCE % dict(n=N_DOCS, ns=N_NS, hold=HOLD, delta=DELTA,
                               kw=KW, search=SEARCH)
    proc = subprocess.run([sys.executable, "-c", script, out], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(os.path.join(out, "results.npz")) as z:
        results = dict(z)
    return out, results


@pytest.mark.parametrize("case", ["dense", "filtered", "fused"])
def test_sharded_mutable_matches_the_reference_on_four_devices(
        reference_run, corpus, meshes, case):
    out, results = reference_run
    mut = ckpt.load_mutable(os.path.join(out, "mut", "step_00000000"),
                            seed=0, codec="opq", device="cpu")
    kw = dict(SEARCH)
    if case == "filtered":
        kw["filter"] = _filter(16)
    if case == "fused":
        kw["fusion"] = qexec.FusionSpec(0.5)
    got = _sharded(mut, meshes, (1, 4)).search(corpus.query_emb,
                                               corpus.query_tokens, **kw)
    _equal(mut.search(corpus.query_emb, corpus.query_tokens, **kw), got)
    np.testing.assert_array_equal(got.n_candidates.numpy(),
                                  results[f"{case}_n_candidates"])
    want_ids, want_s = results[f"{case}_doc_ids"], results[f"{case}_scores"]
    got_ids, got_s = got.doc_ids.numpy(), got.scores.numpy()
    np.testing.assert_allclose(got_s, want_s, rtol=TOL, atol=TOL)
    for b, p in zip(*np.nonzero(got_ids != want_ids)):
        where = np.flatnonzero(want_ids[b] == got_ids[b, p])
        ref = want_s[b, where[0]] if where.size else want_s[b, -1]
        assert abs(ref - got_s[b, p]) <= TOL + TOL * abs(ref), (b, p)


def test_serve_cli_runs_sharded_mutable_serving_through_the_runtime():
    """``python -m repro_torch.launch.serve --mutable --shards 2
    --data-parallel 2 --runtime`` on the CPU: a (2, 2) mesh, the
    quantum-2 ladder, one program per bucket and none after warmup."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device",
         "cpu", "--mutable", "--shards", "2", "--data-parallel", "2",
         "--docs", "1200", "--queries", "64", "--batch", "16",
         "--delta-capacity", "256", "--runtime"],
        env=dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = proc.stdout
    assert "(2, 2) mesh" in out and "mutable: added 150" in out
    assert "buckets [2, 4, 8, 16]" in out
    assert "programs/bucket {2: 1, 4: 1, 8: 1, 16: 1}" in out
    assert "0 post-warmup programs" in out

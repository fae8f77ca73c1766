"""The port's document-sharded index (``repro_torch.core.sharded_index``,
DESIGN.md §6) on the CPU, against its own single-device search and
against the JAX package:

  · ``partition`` gives the reference's arrays (every leaf, path and
    dtype) for every registered codec, with namespaces and the BM25
    impact plane, at S ∈ {1, 3, 4} and N = 4,999;
  · sharded search on S ∈ {2, 3, 4} CPU mesh positions equals the
    port's single-device search bit for bit (ids, scores,
    ``n_candidates``) for every codec × {no filter, filter} × {dense,
    fused at 0.5}, with ``top_r`` beyond the candidate pool;
  · one subprocess runs the reference's sharded search over four
    emulated devices (opq, refine, filtered, fused, and the survivor
    view of ``take_shards``) and saves its checkpoints; the port loads
    them, partitions, and matches under the cross-framework contract of
    DESIGN.md §11 (``n_candidates`` exact, ids up to near-tie swaps,
    scores within 1e-4);
  · the mesh: collectives' bits, a failing or missing position fails
    the call within its time limit, a mesh never takes more cards than
    exist without ``devices=``; ``search``'s argument checks;
    ``fault.py`` against the reference on the same event sequences; the
    runtime over a mesh server; ``sharded_search.py``'s CPU smoke.
"""
import json
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import hybrid_index as jhi
from repro.core import sharded_index as jshi
from repro.data import synthetic
from repro.distributed import fault as jfault
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import codecs
from repro_torch.core import exec as qexec
from repro_torch.core import hybrid_index as hi
from repro_torch.core import sharded_index as shi
from repro_torch.core.exec import filters
from repro_torch.distributed import collectives
from repro_torch.distributed import fault
from repro_torch.launch import mesh as mesh_mod

torch.set_num_threads(2)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_DOCS = 4_999
N_NS = 4
TOL = 1e-4
KW = dict(n_clusters=24, k1_terms=5, pq_m=4, pq_k=64, cluster_capacity=64,
          term_capacity=32, kmeans_iters=3)
#: top_r beyond the pool: kc·64 + k2·32 = 352 candidate slots
WIDTHS = dict(kc=3, k2=5, top_r=400)


@pytest.fixture(scope="module")
def corpus():
    return synthetic.generate(seed=1, n_docs=N_DOCS, n_queries=24,
                              hidden=32, vocab_size=1024, n_topics=16)


@pytest.fixture(scope="module")
def indexes(corpus, tmp_path_factory):
    """codec → (JAX index, the port's index loaded from its checkpoint),
    every one with namespaces and the impact plane; the others reuse
    opq's KMeans."""
    out = {}
    ns = (np.arange(N_DOCS) % N_NS).astype(np.int32)
    for codec in ["opq"] + [c for c in codecs.registered() if c != "opq"]:
        reuse = ({} if codec == "opq" else
                 dict(cluster_sel=out["opq"][0].cluster_sel,
                      doc_assign=out["opq"][0].doc_assign))
        jidx = jhi.build(jax.random.key(0), jnp.asarray(corpus.doc_emb),
                         jnp.asarray(corpus.doc_tokens), corpus.vocab_size,
                         codec=codec, doc_namespaces=ns, sparse=True,
                         **KW, **reuse)
        path = jckpt.save_index(str(tmp_path_factory.mktemp(codec)), 0,
                                jidx)
        out[codec] = (jidx, ckpt.load_index(path, device="cpu"))
    return out


@pytest.fixture(scope="module")
def meshes():
    made = {s: shi.make_shard_mesh(s, devices=["cpu"] * s)
            for s in (2, 3, 4)}
    yield made
    for m in made.values():
        m.close()


def _filter(n):
    return filters.make_filter([(b % N_NS, (b + 1) % N_NS)
                                for b in range(n)], N_NS, device="cpu")


def _jleaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _equal(a, b):
    for name in ("doc_ids", "scores", "n_candidates"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def assert_topk_match(want_ids, want_s, got_ids, got_s):
    """Top-R ids equal up to swaps between scores within TOL; scores
    within rtol=atol=TOL (the contract of tests/test_torch_search.py)."""
    want_ids, got_ids = np.asarray(want_ids), np.asarray(got_ids)
    want_s, got_s = np.asarray(want_s), np.asarray(got_s)
    np.testing.assert_allclose(got_s, want_s, rtol=TOL, atol=TOL)
    for b in np.flatnonzero((got_ids != want_ids).any(axis=1)):
        for p in np.flatnonzero(got_ids[b] != want_ids[b]):
            where = np.flatnonzero(want_ids[b] == got_ids[b, p])
            ref = want_s[b, where[0]] if where.size else want_s[b, -1]
            assert abs(ref - got_s[b, p]) <= TOL + TOL * abs(ref), (b, p)


# --------------------------------------------------------------------------
# partition
# --------------------------------------------------------------------------

@pytest.mark.parametrize("codec", codecs.registered())
def test_partition_matches_the_reference(indexes, codec):
    jidx, tidx = indexes[codec]
    for n_shards in (1, 3, 4):
        got = [(p, np.asarray(x)) for p, x in
               hi.index_leaves(shi.partition(tidx, n_shards))]
        want = _jleaves(jshi.partition(jidx, n_shards))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (p, g), (_, w) in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w), (n_shards, p)
        sidx = shi.partition(tidx, n_shards)
        assert sidx.n_shards == n_shards and sidx.n_docs == N_DOCS
        assert sidx.max_postings == tidx.max_postings
        # the union of the per-shard lists is the global lists
        assert torch.equal(sidx.term_lengths.sum(0), tidx.term_lists.lengths)
        assert shi.candidate_budget(sidx, 3, 5) == hi.candidate_budget(
            tidx, 3, 5)


# --------------------------------------------------------------------------
# sharded == single-device, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
@pytest.mark.parametrize("filtered", [False, True],
                         ids=["unfiltered", "filtered"])
@pytest.mark.parametrize("codec", codecs.registered())
def test_sharded_search_equals_single_device(indexes, corpus, meshes, codec,
                                             filtered, fused):
    _, tidx = indexes[codec]
    qe, qt = corpus.query_emb, corpus.query_tokens
    kw = dict(WIDTHS, filter=_filter(len(qe)) if filtered else None,
              fusion=qexec.FusionSpec(0.5) if fused else None)
    want = hi.search(tidx, qe, qt, device="cpu", **kw)
    assert (want.doc_ids == -1).any()          # top_r beyond the pool
    for n_shards, mesh in meshes.items():
        sidx = shi.device_put(shi.partition(tidx, n_shards), mesh)
        _equal(want, shi.search(sidx, qe, qt, mesh=mesh, **kw))


def test_placement_and_host_round_trip(indexes, meshes):
    """device_put leaves shape-only fields and per-device blocks;
    to_host stacks them back to the partition, leaf for leaf."""
    _, tidx = indexes["refine"]
    sidx = shi.partition(tidx, 3)
    placed = shi.device_put(sidx, meshes[3])
    assert placed.cluster_entries.is_meta and shi.is_placed(placed,
                                                            meshes[3])
    assert not shi.is_placed(sidx, meshes[3])
    assert placed.n_shards == 3 and placed.docs_per_shard == 1_667
    back = [(p, np.asarray(x)) for p, x in
            hi.index_leaves(shi.to_host(placed))]
    for (p, g), (_, w) in zip(back, hi.index_leaves(sidx)):
        assert np.array_equal(g, np.asarray(w)), p
    assert shi.plane_bytes(placed, 0) == sum(
        x[0].nbytes for p, x in hi.index_leaves(sidx)
        if not p.startswith((".cluster_sel", ".term_sel", ".codec_params")))
    with pytest.raises(ValueError, match="shape-only"):
        shi.shard_block(shi.to_meta(placed), 0)


# --------------------------------------------------------------------------
# the reference's sharded search over four emulated devices
# --------------------------------------------------------------------------

_REFERENCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.checkpoint import checkpoint as jckpt
from repro.core import exec as qexec, hybrid_index as hi
from repro.core import sharded_index as shi
from repro.core.exec import filters
from repro.data import synthetic

assert jax.device_count() == 4
out = sys.argv[1]
c = synthetic.generate(seed=1, n_docs=%(n)d, n_queries=24, hidden=32,
                       vocab_size=1024, n_topics=16)
kw = %(kw)r
ns = (np.arange(%(n)d) %% %(ns)d).astype(np.int32)
qe, qt = jnp.asarray(c.query_emb), jnp.asarray(c.query_tokens)
opq = hi.build(jax.random.key(0), jnp.asarray(c.doc_emb),
               jnp.asarray(c.doc_tokens), c.vocab_size, codec="opq",
               doc_namespaces=ns, sparse=True, **kw)
ref = hi.build(jax.random.key(0), jnp.asarray(c.doc_emb),
               jnp.asarray(c.doc_tokens), c.vocab_size, codec="refine",
               cluster_sel=opq.cluster_sel, doc_assign=opq.doc_assign, **kw)
jckpt.save_index(out + "/opq", 0, opq)
jckpt.save_index(out + "/refine", 0, ref)
mesh = shi.make_shard_mesh(4)
flt = filters.make_filter([(b %% %(ns)d, (b + 1) %% %(ns)d)
                           for b in range(24)], %(ns)d)
res = {}
widths = %(widths)r
for name, idx, extra in (("opq", opq, {}), ("refine", ref, {}),
                         ("filtered", opq, {"filter": flt}),
                         ("fused", opq, {"fusion": qexec.FusionSpec(0.5)})):
    s = shi.device_put(shi.partition(idx, 4), mesh)
    r = shi.search(s, qe, qt, mesh=mesh, **widths, **extra)
    res[name] = r
part = shi.partition(opq, 4)
sub_mesh = shi.make_shard_mesh(3)
sub = shi.device_put(shi.take_shards(part, [1, 2, 3]), sub_mesh)
res["survivors"] = shi.search(
    sub, qe, qt, mesh=sub_mesh, **widths,
    shard_offsets=shi.shard_offsets_for([1, 2, 3], part.docs_per_shard))
np.savez(out + "/results.npz", **{
    f"{k}_{f}": np.asarray(getattr(r, f)) for k, r in res.items()
    for f in ("doc_ids", "scores", "n_candidates")})
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_sharded"))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
               "count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(_ROOT, "src"))
    script = _REFERENCE % dict(n=N_DOCS, kw=KW, ns=N_NS, widths=WIDTHS)
    proc = subprocess.run([sys.executable, "-c", script, out], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(os.path.join(out, "results.npz")) as z:
        results = dict(z)
    return out, results


@pytest.mark.parametrize("case", ["opq", "refine", "filtered", "fused",
                                  "survivors"])
def test_sharded_search_matches_the_reference_on_four_devices(
        reference_run, corpus, meshes, case):
    out, results = reference_run
    index = "refine" if case == "refine" else "opq"
    tidx = ckpt.load_index(os.path.join(out, index, "step_00000000"),
                           device="cpu")
    qe, qt = corpus.query_emb, corpus.query_tokens
    kw = dict(WIDTHS)
    if case == "filtered":
        kw["filter"] = _filter(len(qe))
    if case == "fused":
        kw["fusion"] = qexec.FusionSpec(0.5)
    part = shi.partition(tidx, 4)
    if case == "survivors":
        survivors = [1, 2, 3]
        mesh = meshes[3]
        got = shi.search(
            shi.device_put(shi.take_shards(part, survivors), mesh), qe, qt,
            mesh=mesh, shard_offsets=shi.shard_offsets_for(
                survivors, part.docs_per_shard), **kw)
        # nothing from shard 0's range
        ids = got.doc_ids.numpy()
        assert (ids[ids >= 0] >= part.docs_per_shard).all()
    else:
        mesh = meshes[4]
        got = shi.search(shi.device_put(part, mesh), qe, qt, mesh=mesh, **kw)
        _equal(hi.search(tidx, qe, qt, device="cpu", **kw), got)
    np.testing.assert_array_equal(got.n_candidates.numpy(),
                                  results[f"{case}_n_candidates"])
    assert_topk_match(results[f"{case}_doc_ids"], results[f"{case}_scores"],
                      got.doc_ids, got.scores)


# --------------------------------------------------------------------------
# the mesh, its collectives and its failures
# --------------------------------------------------------------------------

def test_collectives_gather_in_order_and_sum_the_same_bits():
    mesh = collectives.Mesh(["cpu"] * 4, ("shards",))
    xs = [torch.tensor([0.1, 1e8, -3.0]) * (i + 1) for i in range(4)]

    def body(coord):
        env = qexec.ShardEnv("shards", coord[0],
                             mesh.group("shards", coord))
        s, i = collectives.gather_topk(
            xs[coord[0]][None].repeat(2, 1),
            torch.arange(3, dtype=torch.int32)[None].repeat(2, 1)
            + 10 * coord[0], env)
        return s, i, env.psum(xs[coord[0]])

    out = mesh.run(body)
    want_sum = ((xs[0] + xs[1]) + xs[2]) + xs[3]
    for s, i, total in out.values():
        assert s.shape == (2, 12) and torch.equal(s[0], torch.cat(xs))
        assert i[1].tolist() == [0, 1, 2, 10, 11, 12, 20, 21, 22, 30, 31,
                                 32]
        assert torch.equal(total, want_sum)
    mesh.close()


def test_collectives_under_thread_switching_stress():
    """Eight positions on a (2, 4) mesh, 100 rounds of all_gather and psum
    along the shard axis with the interpreter switching threads every
    microsecond: every position reads every round's values, never a
    neighbour round's."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    mesh = mesh_mod.make_serving_mesh(2, 4, devices=["cpu"] * 8)
    try:
        def body(coord):
            group = mesh.group("shards", coord)
            bad = 0
            for step in range(100):
                x = torch.tensor([step, coord[0], coord[1]])
                (got,) = group.all_gather(coord[1], (x,))
                total = group.psum(coord[1], x)
                bad += int(not torch.equal(got[:, 2], torch.arange(4))
                           or not (got[:, 0] == step).all()
                           or not (got[:, 1] == coord[0]).all()
                           or total.tolist() != [4 * step, 4 * coord[0], 6])
            return bad

        t0 = time.perf_counter()
        out = mesh.run(body)
        assert time.perf_counter() - t0 < 120
        assert sorted(out) == mesh.positions() and not any(out.values())
    finally:
        sys.setswitchinterval(old)
        mesh.close()


def test_a_failing_position_fails_the_call_and_the_mesh_recovers(
        monkeypatch):
    monkeypatch.setattr(collectives, "TIMEOUT_S", 60.0)
    mesh = collectives.Mesh(["cpu"] * 4, ("shards",))

    def body(coord):
        if coord == (2,):
            raise ValueError("position 2 failed")
        return mesh.group("shards", coord).psum(coord[0],
                                               torch.ones(3))

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="position 2 failed"):
        mesh.run(body)
    assert time.perf_counter() - t0 < 10.0     # the others did not wait
    ok = mesh.run(lambda c: mesh.group("shards", c).psum(c[0],
                                                         torch.ones(3)))
    assert all(torch.equal(v, torch.full((3,), 4.0)) for v in ok.values())
    mesh.close()


def test_a_missing_position_times_out_instead_of_hanging(monkeypatch):
    monkeypatch.setattr(collectives, "TIMEOUT_S", 0.5)
    mesh = collectives.Mesh(["cpu"] * 3, ("shards",))

    def body(coord):
        if coord == (1,):
            return None                    # never meets the others
        return mesh.group("shards", coord).psum(coord[0], torch.ones(1))

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="did not arrive within 0.5 s"):
        mesh.run(body)
    assert time.perf_counter() - t0 < 10.0
    mesh.close()
    with pytest.raises(RuntimeError, match="closed"):
        mesh.run(lambda c: None)


def test_a_stalled_position_fails_the_call_and_closes_the_mesh(
        monkeypatch):
    """A position that stalls after its last collective, where no
    barrier waits for it: the caller gives up after twice the collective
    timeout, names the position, and closes the mesh; the stalled thread
    ends once it comes free."""
    monkeypatch.setattr(collectives, "TIMEOUT_S", 0.5)
    before = set(threading.enumerate())
    mesh = collectives.Mesh(["cpu"] * 3, ("shards",))
    stalled = [t for t in set(threading.enumerate()) - before
               if t.name == "mesh-position-(1,)"]
    assert len(stalled) == 1
    free = threading.Event()

    def body(coord):
        out = mesh.group("shards", coord).psum(coord[0], torch.ones(1))
        if coord == (1,):
            free.wait(30.0)                # stalls past the others
        return out

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match=r"positions \[\(1,\)\] did "
                                           r"not finish.*closed"):
        mesh.run(body)
    assert time.perf_counter() - t0 < 10.0
    with pytest.raises(RuntimeError, match="closed"):
        mesh.run(lambda c: None)
    free.set()
    stalled[0].join(timeout=10)
    assert not stalled[0].is_alive()


def test_mesh_threads_stop_when_the_mesh_is_freed():
    before = set(threading.enumerate())
    mesh = mesh_mod.make_serving_mesh(2, 2, devices=["cpu"] * 4)
    assert mesh.shape == {"data": 2, "shards": 2}
    assert [str(d) for d in mesh.devices.flat] == ["cpu"] * 4
    mine = set(threading.enumerate()) - before
    assert len(mine) == 4 and all(t.name.startswith("mesh-position")
                                  for t in mine)
    mesh.run(lambda c: torch.ones(1))
    del mesh
    import gc
    gc.collect()
    for t in mine:
        t.join(timeout=10)
        assert not t.is_alive()


def test_a_mesh_takes_no_more_cards_than_exist(monkeypatch, indexes):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match=">= 1"):
        mesh_mod.make_serving_mesh(0, 2)
    with pytest.raises(RuntimeError, match="devices="):
        mesh_mod.make_serving_mesh(2, 2)
    with pytest.raises(RuntimeError, match="devices="):
        shi.make_shard_mesh(4)
    with pytest.raises(ValueError, match="needs 4 devices"):
        shi.make_shard_mesh(4, devices=["cpu"] * 3)
    # a search without a mesh takes the first cards, so it raises too
    _, tidx = indexes["opq"]
    sidx = shi.partition(tidx, 2)
    with pytest.raises(RuntimeError, match="devices="):
        shi.search(sidx, np.zeros((2, 32), np.float32),
                   np.zeros((2, 4), np.int32), kc=2, k2=2, top_r=5)
    # a server asked for the card neither falls back to the CPU
    from repro_torch.launch import serve
    cfg = serve.ServeConfig(max_batch=4, n_shards=2)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.ShardedServer(tidx, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.MeshServer(tidx, serve.ServeConfig(max_batch=4, n_shards=2,
                                                 data_parallel=2))


def test_search_refuses_what_the_reference_refuses(indexes, corpus, meshes):
    _, tidx = indexes["opq"]
    qe, qt = corpus.query_emb[:6], corpus.query_tokens[:6]
    sidx = shi.partition(tidx, 3)
    with pytest.raises(ValueError, match="has size 4 but the index has 3"):
        shi.search(sidx, qe, qt, mesh=meshes[4], **WIDTHS)
    grid = mesh_mod.make_serving_mesh(4, 3, devices=["cpu"] * 12)
    with pytest.raises(ValueError, match="does not divide over 4"):
        shi.search(sidx, qe, qt, mesh=grid, data_axis="data", **WIDTHS)
    with pytest.raises(ValueError, match="no axis 'rows'"):
        shi.search(sidx, qe, qt, mesh=grid, data_axis="rows", **WIDTHS)
    grid.close()
    unfiltered = ckpt.index_from_numpy(
        {p: np.asarray(x) for p, x in hi.index_leaves(tidx)
         if p != ".doc_ns"}, "opq", device="cpu")
    with pytest.raises(ValueError, match="doc_namespaces="):
        shi.search(shi.partition(unfiltered, 3), qe, qt, mesh=meshes[3],
                   filter=_filter(6), **WIDTHS)
    with pytest.raises(ValueError, match="shard_offsets shape"):
        shi.search(sidx, qe, qt, mesh=meshes[3], shard_offsets=[0, 1],
                   **WIDTHS)
    with pytest.raises(ValueError, match="out of range"):
        shi.take_shards(sidx, [0, 3])
    with pytest.raises(ValueError, match="at least one"):
        shi.take_shards(sidx, [])


# --------------------------------------------------------------------------
# fault.py, the runtime's refusal, the benchmark
# --------------------------------------------------------------------------

def _health_trace(mod):
    h = mod.ShardHealth(3, window=20)
    trace = []
    for step in range(12):
        for s in range(3):
            dt = 1.0 if (s == 2 and step >= 8) else 0.1 + 0.01 * s
            trace.append(h.observe(s, dt))
    h.eject(2)
    trace += [h.healthy, h.lost, h.degraded]
    with pytest.raises(ValueError, match="out of range"):
        h.observe(3, 0.1)
    h.eject(1)
    with pytest.raises(ValueError, match="last healthy"):
        h.eject(0)
    h.rejoin(1)
    trace += [h.healthy, dict(h.monitor.strikes)]
    h.rejoin()
    trace += [h.healthy, h.degraded, dict(h.monitor.strikes)]
    return trace


def test_fault_matches_the_reference():
    assert _health_trace(fault) == _health_trace(jfault)
    for n, hosts in ((10, [0, 1, 2]), (7, [5, 1]), (3, [0, 1, 2, 3]),
                     (0, [4])):
        assert fault.reshard_bounds(n, hosts) == jfault.reshard_bounds(
            n, hosts)
    with pytest.raises(ValueError, match=">= 1"):
        fault.ShardHealth(0)
    assert issubclass(fault.SimulatedFailure, RuntimeError)


def test_the_runtime_serves_a_mesh_server(indexes, corpus):
    """The runtime over a 2-shard CPU mesh: one eager program per bucket
    (a card captures one graph per bucket per mesh; the CPU captures
    nothing), every bucket's rows equal ``query``'s bit for bit."""
    from repro_torch.launch import runtime, serve
    _, tidx = indexes["opq"]
    server = serve.make_server(tidx, serve.ServeConfig(max_batch=4,
                                                       n_shards=2),
                               device="cpu")
    assert not runtime.captures(server)
    qe, qt = corpus.query_emb, corpus.query_tokens
    with runtime.ServingRuntime(server, runtime.RuntimeConfig(
            linger_ms=50.0)) as rt:
        rt.warmup(qe.shape[1], qt.shape[1])
        assert rt.buckets == (1, 2, 4)
        assert rt.stats()["captured"] == {1: False, 2: False, 4: False}
        for n in rt.buckets:
            got = rt.query(qe[:n], qt[:n], timeout=120)
            want = server.query(qe[:n], qt[:n])
            for name in ("doc_ids", "scores", "n_candidates"):
                np.testing.assert_array_equal(
                    getattr(got, name), getattr(want, name).numpy())
            assert got.partial is False
        rt.assert_one_compile_per_bucket()
    assert rt.stats()["replica_dispatch"] == {0: 7}
    server.mesh.close()


def test_sharded_search_benchmark_smoke(tmp_path):
    out = tmp_path / "sharded.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.sharded_search",
         "--device", "cpu", "--devices", "4", "--docs", "3000",
         "--queries", "32", "--out", str(out)],
        env=dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src")),
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads(out.read_text())
    assert json.loads(proc.stdout) == report
    assert [e["shards"] for e in report["sharded"]] == [2, 4]
    assert all(e["doc_ids_identical"] for e in report["sharded"])
    assert all(e["positions_per_card"] is None for e in report["sharded"])
    assert set(report) >= {"n_docs", "n_queries", "top_r", "codec",
                           "candidate_budget", "candidate_cost", "devices",
                           "baseline", "sharded"}
    assert os.listdir(tmp_path) == ["sharded.json"]

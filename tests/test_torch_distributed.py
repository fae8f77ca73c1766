"""The port's build and training half of multi-device on CPU mesh
positions, against the live JAX package:

  · one subprocess runs the reference on 8 emulated host devices (its
    ``flat_allreduce`` / ``hierarchical_allreduce`` on a (pod 2, data 4)
    mesh, tiled ``psum_scatter`` / ``all_gather``, ``kmeans_fit_sharded``
    and ``shard_batch``) and returns numpy arrays; the port's collectives
    on a (2, 4) CPU mesh equal them within rtol 1e-5 (the adds' order),
    and every position holds the same bits;
  · one sharded Lloyd step from given centroids against the reference's
    ``assign_blocked`` + ``_update`` per shard, summed in rank order:
    counts exact, sums rtol = atol = 1e-5; the whole
    ``kmeans_fit_sharded`` learns and agrees on every position, and its
    reseeds draw the same indices on every position;
  · ``compress_with_ef`` bitwise against the reference over 50 steps,
    and the reference's own error-feedback bound;
  · ``restore_resharded`` of a reference checkpoint onto a device and
    split over 2 and 4 positions; ``restore_mutable`` round trips and
    refuses as the reference does;
  · ``Dataloader`` and ``shard_batch``; ``list_size_histogram``,
    ``adc_score`` and ``pq_full_scores`` against the JAX functions.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import inverted_lists as jil
from repro.core import kmeans as jkm
from repro.core.codecs import pq as jpq
from repro.data import pipeline as jpipe
from repro.distributed import fault as jfault
from repro.optim import compression as jcomp
from repro_torch import tree as tree_mod
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import inverted_lists as il
from repro_torch.core import kmeans
from repro_torch.core import segments as seg
from repro_torch.core.codecs import pq
from repro_torch.data import pipeline
from repro_torch.data import synthetic
from repro_torch.distributed import collectives
from repro_torch.optim import compression

torch.set_num_threads(2)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: all-reduce: rtol of the sum of the summands' magnitudes, the bound of
#: float adds taken in another order (a plain rtol of the sum itself
#: fails wherever the summands cancel)
RTOL = 1e-5
SUM_TOL = 1e-5                 # KMeans sums, rtol = atol
N_POINTS, DIM, N_CLUSTERS, ITERS = 1_024, 16, 8, 5   # the reference test's

_REFERENCE = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core import kmeans
from repro.data import pipeline
from repro.distributed import collectives, compat, sharding as shd
from repro.distributed.compat import shard_map

inp = dict(np.load(sys.argv[1]))
out = {}
mesh = compat.make_mesh((2, 4), ("pod", "data"))
g = {"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"])}
flat = shard_map(lambda t: collectives.flat_allreduce(t, ("data", "pod")),
                 mesh=mesh, in_specs=P(("pod", "data")), out_specs=P())
hier = shard_map(lambda t: collectives.hierarchical_allreduce(t),
                 mesh=mesh, in_specs=P(("pod", "data")), out_specs=P(),
                 check=False)
for name, fn in (("flat", flat), ("hier", hier)):
    r = fn(g)
    out[name + "_w"], out[name + "_b"] = np.asarray(r["w"]), np.asarray(r["b"])

line = compat.make_mesh((8,), ("data",))
scat = shard_map(lambda t: jax.lax.psum_scatter(t, "data",
                                                scatter_dimension=0,
                                                tiled=True),
                 mesh=line, in_specs=P("data"), out_specs=P("data"))
gath = shard_map(lambda t: jax.lax.all_gather(t, "data", axis=0, tiled=True),
                 mesh=line, in_specs=P("data"), out_specs=P(), check=False)
x = jnp.asarray(inp["w"])
out["scatter"] = np.asarray(scat(x))             # block r of rank r, tiled
out["gather"] = np.asarray(gath(x))

pts = jnp.asarray(inp["points"])
fit = shard_map(lambda xl: kmeans.kmeans_fit_sharded(jax.random.key(1), xl,
                                                     %(l)d, n_iters=%(it)d),
                mesh=line, in_specs=P("data"), out_specs=P())
c = fit(pts)
out["fit_cost"] = np.asarray(kmeans.kmeans_cost(
    pts, c, kmeans.assign_blocked(pts, c)))

with shd.use_mesh(mesh):
    sb = pipeline.shard_batch({"x": inp["batch"]})
shards = {s.device: np.asarray(s.data) for s in sb["x"].addressable_shards}
out["batch_shards"] = np.stack([shards[d] for d in mesh.devices.flat])
np.savez(sys.argv[2], **out)
"""


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((8 * 16, 8)).astype(np.float32),
            "b": rng.standard_normal((8 * 5,)).astype(np.float32),
            "points": rng.standard_normal((N_POINTS, DIM)).astype(
                np.float32),
            "batch": rng.integers(0, 1000, (16, 3)).astype(np.int32)}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def reference_run(inputs, tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_distributed")
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
               "--xla_cpu_multi_thread_eigen=false "
               "intra_op_parallelism_threads=1",
               PYTHONPATH=os.path.join(_ROOT, "src"))
    script = _REFERENCE % dict(l=N_CLUSTERS, it=ITERS)
    proc = subprocess.run([sys.executable, "-c", script, str(d / "in.npz"),
                           str(d / "out.npz")], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(d / "out.npz") as z:
        return dict(z)


@pytest.fixture(scope="module")
def pod_mesh():
    mesh = collectives.Mesh([["cpu"] * 4] * 2, ("pod", "data"))
    yield mesh
    mesh.close()


def _grads(inputs, rank: int) -> dict:
    """Position ``rank``'s block of the gradients, as the reference's
    ``P(("pod", "data"))`` splits them."""
    return {"w": torch.from_numpy(inputs["w"][rank * 16:(rank + 1) * 16]),
            "b": torch.from_numpy(inputs["b"][rank * 5:(rank + 1) * 5])}


def _sum_close(got, want, summands: np.ndarray) -> None:
    """|got − want| ≤ RTOL · Σ|summand| elementwise; ``summands`` is
    (S, ...)."""
    bound = RTOL * np.abs(summands.astype(np.float64)).sum(0)
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= bound).all(), float((err - bound).max())


def _all_equal(outs: list) -> None:
    for o in outs[1:]:
        for a, b in zip(tree_mod.leaves(outs[0]), tree_mod.leaves(o)):
            assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the all-reduce and the collectives under it
# --------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["flat", "hier"])
def test_allreduce_matches_the_reference_on_a_pod_mesh(reference_run,
                                                       inputs, pod_mesh,
                                                       schedule):
    """(pod 2, data 4) with {"w": (16, 8), "b": (5,)} a position (5 is not
    a multiple of |data|, so "b" takes the flat fallback): within RTOL of
    the reference and of the float64 sum, the same bits on every
    position, and the hierarchical schedule within RTOL of the flat
    one."""
    def body(coord):
        pos = pod_mesh.position(coord)
        g = _grads(inputs, pod_mesh.rank(("pod", "data"), coord))
        if schedule == "flat":
            return collectives.flat_allreduce(g, ("data", "pod"), pos=pos)
        return (collectives.hierarchical_allreduce(g, pos=pos),
                collectives.flat_allreduce(g, ("pod", "data"), pos=pos))

    outs = list(pod_mesh.run(body).values())
    _all_equal(outs)
    got = outs[0] if schedule == "flat" else outs[0][0]
    for k, rows in (("w", 16), ("b", 5)):
        summands = inputs[k].reshape((8, rows) + inputs[k].shape[1:])
        _sum_close(got[k].numpy(), reference_run[f"{schedule}_{k}"],
                   summands)
        _sum_close(got[k].numpy(), summands.astype(np.float64).sum(0),
                   summands)
        if schedule == "hier":
            _sum_close(got[k].numpy(), outs[0][1][k].numpy(), summands)
    if schedule == "hier":      # the fallback leaf is the flat psum itself
        assert torch.equal(got["b"], outs[0][1]["b"])


def test_tiled_psum_scatter_and_all_gather_round_trip(reference_run, inputs):
    """Over 8 positions: rank r's ``psum_scatter`` block equals block r of
    the reference's (within RTOL) and of the port's own psum (bitwise); the
    tiled ``all_gather`` equals the reference's concatenation bitwise and
    gathers the scattered blocks back into the psum bit for bit."""
    mesh = collectives.Mesh(["cpu"] * 8, ("data",))
    x = torch.from_numpy(inputs["w"])

    def body(coord):
        pos = mesh.position(coord)
        mine = x[coord[0] * 16:(coord[0] + 1) * 16]
        part = pos.psum_scatter(mine, "data")
        return part, pos.all_gather(part, "data"), pos.psum(mine, "data"), \
            pos.all_gather(mine, "data")

    outs = mesh.run(body)
    mesh.close()
    total = outs[(0,)][2]
    for (r,), (part, back, psum, gathered) in outs.items():
        assert part.shape == (2, 8)
        assert torch.equal(part, total[2 * r:2 * r + 2])
        assert torch.equal(back, total) and torch.equal(psum, total)
        assert torch.equal(gathered, x)
        np.testing.assert_array_equal(gathered.numpy(),
                                      reference_run["gather"])
    _sum_close(torch.cat([outs[(r,)][0] for r in range(8)]).numpy(),
               reference_run["scatter"], inputs["w"].reshape(8, 16, 8))


def test_groups_over_several_axes_add_in_row_major_rank_order(pod_mesh):
    """A psum over two axes is one group whatever order names them, its
    ranks row-major over (pod, data): values that cancel differently in
    another order pin the order of the adds."""
    vals = [torch.tensor([1e8, 1.0, -1e8, 3.0][i % 4] * (1 + i / 7),
                         dtype=torch.float32).reshape(1) for i in range(8)]

    def body(coord):
        pos = pod_mesh.position(coord)
        r = pos.axis_index(("data", "pod"))
        return (r, pos.psum(vals[r], ("data", "pod")),
                pos.psum(vals[r], ("pod", "data")),
                pos.axis_size(("pod", "data")))

    want = vals[0]
    for v in vals[1:]:
        want = want + v
    for coord, (r, a, b, n) in pod_mesh.run(body).items():
        assert r == coord[0] * 4 + coord[1] and n == 8
        assert torch.equal(a, want) and torch.equal(b, want)
    with pytest.raises(ValueError, match="no axis"):
        pod_mesh.axis_size(("pod", "model"))
    with pytest.raises(ValueError, match="once"):
        pod_mesh.rank(("pod", "pod"), (0, 0))


def test_pmean_metrics_agree_on_every_position(pod_mesh):
    """``pmean_metrics`` of a loss and an aux term: psum / 8, the same bits
    on every position, within rtol 1e-5 of the float64 mean."""
    losses = np.random.default_rng(3).random(8).astype(np.float32)

    def body(coord):
        r = pod_mesh.rank(("pod", "data"), coord)
        m = {"loss": torch.tensor(losses[r]),
             "aux": torch.tensor([losses[r], 2 * losses[r]])}
        return collectives.pmean_metrics(m, ("pod", "data"),
                                         pos=pod_mesh.position(coord))

    outs = list(pod_mesh.run(body).values())
    _all_equal(outs)
    np.testing.assert_allclose(float(outs[0]["loss"]),
                               losses.astype(np.float64).mean(), rtol=RTOL)
    assert torch.equal(outs[0]["aux"][1], 2 * outs[0]["aux"][0])


def test_psum_scatter_and_split_refuse_what_they_cannot_split(pod_mesh):
    def body(coord):
        return pod_mesh.position(coord).psum_scatter(torch.zeros(6), "data")

    with pytest.raises(ValueError, match="multiple of 4"):
        pod_mesh.run(body)
    with pytest.raises(ValueError, match="cannot split"):
        collectives.Split(pod_mesh, "data").place(torch.zeros(6))


# --------------------------------------------------------------------------
# sharded KMeans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_lloyd_step_matches_the_reference(inputs, n_shards):
    """One step from shared centroids: per shard the reference's
    ``assign_blocked`` + ``_update``, summed in rank order, against the
    port's psummed statistics: counts exact, sums rtol = atol = 1e-5,
    the same bits on every position."""
    x = inputs["points"]
    c = x[::N_POINTS // N_CLUSTERS][:N_CLUSTERS] + 0.25
    per = N_POINTS // n_shards
    want_s = want_n = None
    for r in range(n_shards):
        xl = jnp.asarray(x[r * per:(r + 1) * per])
        s, n = jkm._update(xl, jkm.assign_blocked(xl, jnp.asarray(c)),
                           N_CLUSTERS)
        s, n = np.asarray(s), np.asarray(n)
        want_s = s if want_s is None else want_s + s
        want_n = n if want_n is None else want_n + n
    mesh = collectives.Mesh(["cpu"] * n_shards, ("data",))
    parts = collectives.Split(mesh, "data").place(torch.from_numpy(x))
    outs = mesh.run(lambda coord: kmeans.sharded_step(
        parts[coord], torch.from_numpy(c), N_CLUSTERS, ("data",),
        pos=mesh.position(coord)))
    mesh.close()
    outs = list(outs.values())
    _all_equal(outs)
    sums, counts = outs[0]
    np.testing.assert_array_equal(counts.numpy(), want_n)
    np.testing.assert_allclose(sums.numpy(), want_s, rtol=SUM_TOL,
                               atol=SUM_TOL)


def test_kmeans_fit_sharded_learns_and_agrees(reference_run, inputs):
    """The reference test's size (1,024 × 16, 8 clusters, 5 steps, 8
    shards): every position returns the same centroids bit for bit, the
    cost beats the random init's, and it lands within 10% of the
    reference's sharded fit (other draws, so not equal)."""
    x = torch.from_numpy(inputs["points"])
    mesh = collectives.Mesh(["cpu"] * 8, ("data",))
    parts = collectives.Split(mesh, "data").place(x)
    outs = list(mesh.run(lambda coord: kmeans.kmeans_fit_sharded(
        1, parts[coord], N_CLUSTERS, n_iters=ITERS,
        pos=mesh.position(coord))).values())
    mesh.close()
    _all_equal(outs)
    c = outs[0]
    assert c.shape == (N_CLUSTERS, DIM) and c.dtype == torch.float32
    cost = float(kmeans.kmeans_cost(x, c, kmeans.assign_blocked(x, c)))
    c0 = x[:N_CLUSTERS]
    cost0 = float(kmeans.kmeans_cost(x, c0, kmeans.assign_blocked(x, c0)))
    assert cost < cost0, (cost, cost0)
    assert abs(cost - float(reference_run["fit_cost"])) <= 0.1 * cost


def _emulated_fit(seed: int, parts: list, n_clusters: int, n_iters: int
                  ) -> torch.Tensor:
    """The sharded fit on one thread: a generator per position seeded
    alike, the rank-order adds of psum, pmean as psum / S."""
    gens = [torch.Generator().manual_seed(seed) for _ in parts]

    def pmean(xs):
        acc = xs[0]
        for v in xs[1:]:
            acc = acc + v
        return acc / len(xs)

    c = pmean([p[torch.randint(0, p.shape[0], (n_clusters,), generator=g)]
               for p, g in zip(parts, gens)])
    for _ in range(n_iters):
        stats = [kmeans._update(p, kmeans.assign_blocked(p, c), n_clusters)
                 for p in parts]
        sums, counts = stats[0]
        for s, n in stats[1:]:
            sums, counts = sums + s, counts + n
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        c = pmean([kmeans._reseed_empty(g, new, counts, p)
                   for p, g in zip(parts, gens)])
    return c


def test_kmeans_fit_sharded_reseeds_from_the_same_draws_everywhere():
    """Four positions each hold 3 distinct points (repeated) and 12
    clusters are fitted, so clusters go empty and are reseeded every
    step: the fit equals a one-thread run with one generator per
    position seeded alike, bit for bit (a generator shared by the
    worker threads, or draws that differ between positions, would
    not)."""
    rng = np.random.default_rng(7)
    parts = [torch.from_numpy(np.repeat(rng.standard_normal((3, 4)), 20,
                                        axis=0).astype(np.float32))
             for _ in range(4)]
    mesh = collectives.Mesh(["cpu"] * 4, ("data",))
    outs = list(mesh.run(lambda coord: kmeans.kmeans_fit_sharded(
        5, parts[coord[0]], 12, n_iters=4,
        pos=mesh.position(coord))).values())
    mesh.close()
    _all_equal(outs)
    want = _emulated_fit(5, parts, 12, 4)
    assert torch.equal(outs[0], want)
    stats = [kmeans._update(p, kmeans.assign_blocked(p, want), 12)
             for p in parts]
    assert (sum(n for _, n in stats) < 0.5).any()   # reseeding was needed


# --------------------------------------------------------------------------
# int8 compression with error feedback
# --------------------------------------------------------------------------

def test_compress_with_ef_matches_the_reference_bitwise():
    """50 steps of ``compress_with_ef`` → ``decompress`` on three leaves
    (a 2-D f32, a bf16 vector, values on exact half steps): payloads,
    scales, decompressed values and error feedback equal to the
    reference's bit for bit."""
    rng = np.random.default_rng(11)
    g_np = {"w": rng.standard_normal((32, 16)).astype(np.float32) * 3e-3,
            "h": np.array([127.0, 63.5, -0.5, 1.5, 2.5, 0.0], np.float32),
            "v": rng.standard_normal(40).astype(np.float32)}
    jg = {"w": jnp.asarray(g_np["w"]), "h": jnp.asarray(g_np["h"]),
          "v": jnp.asarray(g_np["v"]).astype(jnp.bfloat16)}
    tg = {"w": torch.from_numpy(g_np["w"]), "h": torch.from_numpy(g_np["h"]),
          "v": torch.from_numpy(g_np["v"]).to(torch.bfloat16)}
    jef, tef = jcomp.ef_init(jg), compression.ef_init(tg)
    for step in range(50):
        jc, jef = jcomp.compress_with_ef(jg, jef)
        tc, tef = compression.compress_with_ef(tg, tef)
        jd, td = jcomp.decompress(jc), compression.decompress(tc)
        for k in g_np:
            assert tc[k].q.dtype == torch.int8, k
            np.testing.assert_array_equal(tc[k].q.numpy(),
                                          np.asarray(jc[k].q))
            np.testing.assert_array_equal(tc[k].scale.numpy(),
                                          np.asarray(jc[k].scale))
            np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
            np.testing.assert_array_equal(tef[k].numpy(),
                                          np.asarray(jef[k]))


def test_compression_error_feedback_converges():
    """The reference's own test: accumulated decompressed gradients
    converge to the accumulated true ones within half a quantization
    step amortised over 50 steps (rtol 0.02, atol 2e-4); an all-zero
    leaf keeps the 1e-12 floor of its scale."""
    g = {"w": torch.tensor([1.0, -0.5, 0.25, 1e-4]), "z": torch.zeros(3)}
    ef = compression.ef_init(g)
    total = torch.zeros(4)
    for _ in range(50):
        c, ef = compression.compress_with_ef(g, ef)
        total = total + compression.decompress(c)["w"]
    np.testing.assert_allclose((total / 50).numpy(), g["w"].numpy(),
                               rtol=0.02, atol=2e-4)
    assert float(c["z"].scale) == np.float32(1e-12)
    assert not c["z"].q.any()


# --------------------------------------------------------------------------
# checkpoints: the elastic restore and the mutable restore
# --------------------------------------------------------------------------

@pytest.mark.parametrize("where", ["device", "split2", "split4"])
def test_restore_resharded_places_a_reference_checkpoint(tmp_path, where):
    """A checkpoint the reference wrote ({params, opt}) restored onto a
    device, or with dim 0 split over 2 or 4 CPU positions (the elastic
    path: another device count than the save's): every block on its
    position, reassembled equal to the saved leaf bit for bit, and a
    ``None`` placement left where ``restore`` puts it."""
    params = {"table": jnp.arange(64, dtype=jnp.float32).reshape(8, 8),
              "bias": jnp.linspace(-1, 1, 4)}
    opt = {"mu": params["table"] * 0.5}
    path = jckpt.save(str(tmp_path), 1, {"params": params, "opt": opt})
    like = {"params": {"table": torch.zeros(8, 8), "bias": torch.zeros(4)},
            "opt": {"mu": torch.zeros(8, 8)}}
    if where == "device":
        placements = {"params": torch.device("cpu"), "opt": None}
        got = ckpt.restore_resharded(path, like, placements)
        np.testing.assert_array_equal(got["params"]["table"].numpy(),
                                      np.asarray(params["table"]))
        np.testing.assert_array_equal(got["opt"]["mu"].numpy(),
                                      np.asarray(opt["mu"]))
        return
    n = int(where[-1])
    mesh = collectives.Mesh([["cpu"] * (n // 2)] * 2, ("pod", "data"))
    split = collectives.Split(mesh, ("pod", "data"))
    got = ckpt.restore_resharded(path, like, {
        "params": {"table": split, "bias": None},
        "opt": collectives.Split(mesh, "pod")})
    pieces = got["params"]["table"]
    assert set(pieces) == set(mesh.positions())
    for coord, block in pieces.items():
        r = mesh.rank(("pod", "data"), coord)
        assert block.shape == (8 // n, 8)
        np.testing.assert_array_equal(
            block.numpy(), np.asarray(params["table"])[r * 8 // n:
                                                       (r + 1) * 8 // n])
    assert torch.equal(split.join(pieces),
                       torch.from_numpy(np.array(params["table"])))
    mu = got["opt"]["mu"]
    assert torch.equal(mu[(0, 0)], mu[(0, n // 2 - 1)])
    assert torch.equal(collectives.Split(mesh, "pod").join(mu),
                       torch.from_numpy(np.array(opt["mu"])))
    np.testing.assert_array_equal(got["params"]["bias"].numpy(),
                                  np.asarray(params["bias"]))
    mesh.close()


KW = dict(n_clusters=8, k1_terms=4, pq_m=4, pq_k=16, cluster_capacity=64,
          term_capacity=32, kmeans_iters=2)
DELTA = dict(delta_capacity=32, delta_cluster_capacity=8,
             delta_term_capacity=8)
HOLD = 24


@pytest.fixture(scope="module")
def mutated():
    c = synthetic.generate(seed=2, n_docs=400, n_queries=8, hidden=16,
                           vocab_size=256, n_topics=8)
    mut = seg.MutableHybridIndex.create(
        0, c.doc_emb[:-HOLD], c.doc_tokens[:-HOLD], c.vocab_size,
        codec="opq", device="cpu", **DELTA, **KW)
    mut.add_docs(c.doc_emb[-HOLD:], c.doc_tokens[-HOLD:])
    mut.delete_docs(np.arange(0, 40, 3))
    return c, mut


def _results_equal(a, b) -> None:
    for f in ("doc_ids", "scores", "n_candidates"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_restore_mutable_round_trips(mutated, tmp_path):
    """save_mutable → restore_mutable into a fresh index of the same
    shapes: search equal bit for bit, counters equal, and later
    mutations behave as on the never-saved index (the reference's
    tests/test_segments.py round trip)."""
    c, mut = mutated
    search = dict(kc=4, k2=4, top_r=15)
    qe, qt = c.query_emb, c.query_tokens
    path = ckpt.save_mutable(str(tmp_path), 7, mut)
    like = seg.MutableHybridIndex.create(
        1, c.doc_emb[:-HOLD], c.doc_tokens[:-HOLD], c.vocab_size,
        codec="opq", device="cpu", **DELTA, **KW)
    back = ckpt.restore_mutable(path, like)
    _results_equal(mut.search(qe, qt, **search), back.search(qe, qt, **search))
    assert back.delta_count == mut.delta_count
    assert back.n_deleted == mut.n_deleted and back.seed == mut.seed
    extra_e, extra_t = c.doc_emb[:6] + 0.01, c.doc_tokens[:6]
    np.testing.assert_array_equal(mut.add_docs(extra_e, extra_t),
                                  back.add_docs(extra_e, extra_t))
    _results_equal(mut.search(qe, qt, **search), back.search(qe, qt, **search))


def test_restore_mutable_refuses_as_the_reference(mutated, tmp_path):
    """A codec other than the target's, a plain index checkpoint and a
    target of other shapes are refused, the first two with the
    reference's messages."""
    c, mut = mutated
    path = ckpt.save_mutable(str(tmp_path), 0, mut)
    flat = seg.MutableHybridIndex.create(
        0, c.doc_emb[:-HOLD], c.doc_tokens[:-HOLD], c.vocab_size,
        codec="flat", device="cpu", **DELTA, **KW)
    with pytest.raises(ValueError, match=r"was built with codec 'opq' but "
                       r"the restore target uses 'flat'$"):
        ckpt.restore_mutable(path, flat)
    plain = ckpt.save_index(str(tmp_path), 1, mut.base)
    with pytest.raises(ValueError, match=r"is not a mutable-index "
                       r"checkpoint \(no 'mutable' manifest entry\); use "
                       r"restore_index$"):
        ckpt.restore_mutable(plain, mut)
    smaller = seg.MutableHybridIndex.create(
        0, c.doc_emb[:-HOLD], c.doc_tokens[:-HOLD], c.vocab_size,
        codec="opq", device="cpu", **dict(DELTA, delta_capacity=16), **KW)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_mutable(path, smaller)


# --------------------------------------------------------------------------
# the data pipeline
# --------------------------------------------------------------------------

def _factory(seed: int, batch: int) -> dict:
    toks = np.random.default_rng(seed).integers(0, 128, (batch, 8))
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def test_dataloader_matches_the_reference():
    """Local sizes and batches step for step before and after the
    ejection drill of tests/test_fault_tolerance.py (12 examples over
    hosts [0, 1, 2], then host 1 ejected), for every host."""
    for host in (0, 2):
        mine = pipeline.Dataloader(_factory, global_batch=12, seed=3,
                                   host_id=host, healthy_hosts=[0, 1, 2])
        ref = jpipe.Dataloader(_factory, global_batch=12, seed=3,
                               host_id=host, healthy_hosts=[0, 1, 2])
        for hosts in (None, [0, 2]):
            if hosts is not None:
                mine.reshard(hosts)
                ref.reshard(hosts)
            assert mine.local_batch_size() == ref.local_batch_size()
            for step, (a, b) in enumerate(zip(mine, ref)):
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
                if step == 3:
                    break
    loader = pipeline.Dataloader(_factory, 12, host_id=0,
                                 healthy_hosts=[0, 1, 2])
    assert loader.local_batch_size() == 4
    loader.reshard([0, 2])
    assert loader.local_batch_size() == 6
    assert jfault.reshard_bounds(12, [0, 2]) == {0: (0, 6), 2: (6, 12)}


def test_shard_batch_splits_as_the_reference(reference_run, inputs,
                                             pod_mesh):
    """The batch axis over (pod, data) gives position (p, d) the block
    the reference's ``shard_batch`` puts on device p·4 + d; over "data"
    alone both pods hold the same four blocks; a tensor on a position's
    device is split into views."""
    batch = {"x": inputs["batch"], "y": torch.arange(16.0)}
    pieces = pipeline.shard_batch(batch, pod_mesh, ("pod", "data"))
    for coord, part in pieces.items():
        r = pod_mesh.rank(("pod", "data"), coord)
        np.testing.assert_array_equal(part["x"].numpy(),
                                      reference_run["batch_shards"][r])
        assert torch.equal(part["y"], torch.arange(2.0 * r, 2.0 * r + 2))
        assert part["y"].data_ptr() == batch["y"][2 * r:].data_ptr()
    by_data = pipeline.shard_batch(batch, pod_mesh, "data")
    for (p, d), part in by_data.items():
        np.testing.assert_array_equal(part["x"].numpy(),
                                      inputs["batch"][4 * d:4 * d + 4])
    with pytest.raises(ValueError, match="cannot split"):
        pipeline.shard_batch({"x": np.zeros((6, 2))}, pod_mesh, "data")


# --------------------------------------------------------------------------
# single-device leftovers
# --------------------------------------------------------------------------

def test_list_size_histogram_matches_the_reference():
    rng = np.random.default_rng(4)
    docs = np.arange(300, dtype=np.int32)
    lists = rng.integers(0, 17, 300).astype(np.int32)
    scores = rng.random(300).astype(np.float32)
    want = jil.list_size_histogram(jil.build(docs, lists, scores, 17, 32))
    got = il.list_size_histogram(il.build(docs, lists, scores, 17, 32,
                                          device="cpu"))
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def pq_case():
    """The reference test_core.py ADC case's shapes: 400 × 32 points,
    m 4, k 16; the reference's codebook and codes, 8 queries."""
    key = jax.random.key(5)
    x = jax.random.normal(key, (400, 32))
    q = jax.random.normal(jax.random.fold_in(key, 1), (8, 32))
    cb = jpq.train_pq(jax.random.fold_in(key, 2), x, m=4, k=16, n_iters=5)
    codes = jpq.pq_encode(cb, x)
    return q, cb, codes


def test_adc_score_matches_the_reference(pq_case):
    """Candidate scores over per-query LUTs within rtol = atol = 1e-5 of
    the reference's (the m-term sums' order), and equal to ⟨q, decode⟩
    within 1e-4 as the reference test holds it."""
    q, cb, codes = pq_case
    cand = np.broadcast_to(np.arange(50)[None], (8, 50))
    lut = jpq.adc_lut(cb, q)
    want = np.asarray(jpq.adc_score(lut, codes[cand]))
    tcb = pq.PQCodebook(torch.from_numpy(np.array(cb.codewords)))
    tcodes = torch.from_numpy(np.array(codes))
    got = pq.adc_score(pq.adc_lut(tcb, torch.from_numpy(np.array(q))),
                       tcodes[torch.from_numpy(cand.copy())])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    expect = np.asarray(q) @ np.asarray(jpq.pq_decode(cb, codes[:50])).T
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-4, atol=1e-4)


def test_pq_full_scores_matches_the_reference(pq_case):
    """Exhaustive (B, n) scores within rtol = atol = 1e-5."""
    q, cb, codes = pq_case
    want = np.asarray(jpq.pq_full_scores(cb, q, codes))
    got = pq.pq_full_scores(
        pq.PQCodebook(torch.from_numpy(np.array(cb.codewords))),
        torch.from_numpy(np.array(q)),
        torch.from_numpy(np.array(codes)))
    assert got.shape == (8, 400)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

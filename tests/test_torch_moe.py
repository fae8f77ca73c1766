"""Port parity of the MoE layer (``repro_torch.models.moe``) against the
live JAX package on the CPU: ``forward`` at both reduced MoE configs'
widths, at capacity factor 1.25 (assignments drop) and 4.0 (none drop),
its routes at bf16 on OLMoE's router width, the combine's bits, the
top-k's tie order, and ``forward_shard_map`` on CPU mesh positions
against ``forward`` and against the reference's ``forward_shard_map`` on
8 emulated devices (one subprocess).

The reference's routes are read off its own steps (``layers.dense``,
``softmax``, ``lax.top_k``, the one-hot cumsum of ``moe.py:57-72``) and
the port's from :func:`repro_torch.models.moe.record_routes`.

Tolerances: routes (expert, position, kept) exactly equal; at f32 the
outputs, ``aux_loss`` and ``dropped_frac`` within rtol = atol = 1e-5 and
every gradient (x and each parameter) within rtol = atol = 1e-5; the
bf16 combine bit for bit; ``forward_shard_map`` against ``forward`` at
capacity factor 8.0 within 3e-4 (the reference's own bound,
``tests/test_perf_impls.py``), against the reference's shard_map within
1e-5, its ``dropped_frac`` exactly.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro_torch import tree
from repro_torch.distributed import collectives
from repro_torch.models import moe

torch.set_num_threads(2)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
SHARD_TOL = dict(rtol=3e-4, atol=3e-4)
ARCHS = ("mixtral-8x22b", "olmoe-1b-7b")
B, S = 2, 24


def _dims(arch: str) -> tuple:
    cfg = jregistry.get(arch).make_reduced()
    return cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.moe_top_k


def _np_params(d: int, f: int, e: int, seed: int = 0) -> dict:
    return jax.tree.map(np.asarray, jmoe.init(jax.random.key(seed), d, f, e))


def _torch(params: dict) -> dict:
    return tree.map(lambda a: torch.from_numpy(np.array(a)), params)


def _x(shape, seed: int = 1) -> np.ndarray:
    """Rows with a shared offset, so the router's load is skewed and
    capacity factor 1.25 drops assignments."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) + rng.normal(size=shape[-1])).astype(
        np.float32)


def _jroutes(params, x, n_experts: int, top_k: int, cf: float) -> tuple:
    """The reference forward's (expert, position, kept), from its own
    steps."""
    b, s, d = x.shape
    n = b * s
    logits = jlayers.dense(params["router"], x.reshape(n, d)).astype(
        jnp.float32)
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    capacity = max(int(n * top_k * cf / n_experts), 1)
    flat_e = top_e.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, n_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - 1,
                              flat_e[:, None], axis=1)[:, 0]
    return (np.asarray(top_e), np.asarray(pos).reshape(n, top_k),
            np.asarray(pos < capacity).reshape(n, top_k))


def _routes_equal(route: moe.Route, want: tuple) -> None:
    for got, w, what in zip(route[:3], want, ("expert", "position",
                                              "kept")):
        np.testing.assert_array_equal(got.numpy(), w, err_msg=what)


@pytest.mark.parametrize("cf", [1.25, 4.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_reference(arch, cf):
    """Routes exactly, outputs, aux and dropped within 1e-5; at cf 1.25
    some assignments drop, at 4.0 none."""
    d, f, e, k = _dims(arch)
    params, x = _np_params(d, f, e), _x((B, S, d))
    jp = jax.tree.map(jnp.asarray, params)
    want, wstats = jmoe.forward(jp, jnp.asarray(x), n_experts=e, top_k=k,
                                capacity_factor=cf)
    with moe.record_routes() as routes:
        got, stats = moe.forward(_torch(params), torch.from_numpy(x),
                                 n_experts=e, top_k=k, capacity_factor=cf)
    assert len(routes) == 1
    _routes_equal(routes[0], _jroutes(jp, jnp.asarray(x), e, k, cf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(stats.aux_loss),
                               float(wstats.aux_loss), **TOL)
    np.testing.assert_allclose(float(stats.dropped_frac),
                               float(wstats.dropped_frac), **TOL)
    assert (float(stats.dropped_frac) > 0) == (cf == 1.25)
    assert stats.aux_loss.dtype == torch.float32
    assert stats.aux_loss.dim() == stats.dropped_frac.dim() == 0


@pytest.mark.parametrize("cf", [1.25, 4.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(arch, cf):
    """d(Σ out·g + aux) with respect to x and every parameter (the router
    through the routing weights and through P_e) within 1e-5; g is the
    cotangent of a mean over the B·S tokens."""
    d, f, e, k = _dims(arch)
    params, x = _np_params(d, f, e, seed=2), _x((B, S, d), seed=3)
    g = _x((B, S, d), seed=4) / (B * S)

    def jloss(p, xx):
        out, st = jmoe.forward(p, xx, n_experts=e, top_k=k,
                               capacity_factor=cf)
        return jnp.sum(out * g) + st.aux_loss

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = tree.map(lambda t: t.requires_grad_(True), _torch(params))
    tx = torch.from_numpy(x).requires_grad_(True)
    out, st = moe.forward(tp, tx, n_experts=e, top_k=k, capacity_factor=cf)
    (torch.sum(out * torch.from_numpy(g)) + st.aux_loss).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    want = {p: np.asarray(a) for p, a in
            ((jax.tree_util.keystr(p), a) for p, a in
             jax.tree_util.tree_flatten_with_path(jgp)[0])}
    got = tree.leaves_with_paths(tp)
    assert sorted(p for p, _ in got) == sorted(want)
    for path, leaf in got:
        np.testing.assert_allclose(leaf.grad.numpy(), want[path],
                                   err_msg=path, **TOL)
    assert float(tp["router"]["w"].grad.abs().max()) > 0


def test_bf16_routes_at_olmoe_router_width_equal_the_reference():
    """d 2,048, E 64, k 8, 4,096 tokens (numpy seed 0) at bf16: the
    router logits round to bf16 and tie often, and every route (expert
    set and order, position, kept) equals the reference's; the outputs
    stay within bf16's reach of the reference's (d_ff cut to 16: the
    routes do not see it)."""
    d, e, k = 2048, 64, 8
    params = _np_params(d, 16, e)
    x = _x((1, 4096, d), seed=0)
    jp = jax.tree.map(jnp.asarray, params)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    with moe.record_routes() as routes:
        got, stats = moe.forward(_torch(params), tx, n_experts=e, top_k=k)
    want_routes = _jroutes(jp, jx, e, k, 1.25)
    logits = routes[0].logits
    top = torch.sort(logits, dim=-1, descending=True).values
    assert bool((top[:, k - 1] == top[:, k]).any())      # ties at the cut
    _routes_equal(routes[0], want_routes)
    want, wstats = jmoe.forward(jp, jx, n_experts=e, top_k=k)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    assert float(stats.dropped_frac) == pytest.approx(
        float(wstats.dropped_frac), abs=1e-6)


def test_bf16_combine_is_bitwise_the_reference_segment_sum():
    """n 2,048, k 8, d 256: the same bf16 slot rows and weights give the
    reference's segment_sum bit for bit; one f32 sum rounded once does
    not."""
    rng = np.random.default_rng(5)
    n, k, d = 2048, 8, 256
    rows = rng.normal(size=(n * k, d)).astype(np.float32)
    w = rng.random(n * k).astype(np.float32)
    jrows, jw = (jnp.asarray(a).astype(jnp.bfloat16) for a in (rows, w))
    want = jax.ops.segment_sum(jrows * jw[:, None],
                               jnp.repeat(jnp.arange(n), k),
                               num_segments=n).astype(jnp.bfloat16)
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32))).bfloat16()
    trows, tw = (torch.from_numpy(a).bfloat16() for a in (rows, w))
    got = moe.combine(trows, tw, k)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    once = (trows * tw[:, None]).view(n, k, d).float().sum(1).bfloat16()
    assert not torch.equal(once, want)


def test_tied_probabilities_go_to_the_lower_expert_as_lax_top_k():
    """Router columns duplicated in pairs: every token ties across each
    pair, and the port's top-k takes the lower expert first, as
    ``lax.top_k``; ``torch.topk`` picks otherwise on some tokens."""
    rng = np.random.default_rng(7)
    d, e, k = 16, 16, 3
    half = rng.normal(size=(d, e // 2)).astype(np.float32)
    w = np.repeat(half, 2, axis=1)               # columns 2i, 2i+1 equal
    x = rng.normal(size=(256, d)).astype(np.float32)
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(w), -1)
    jprobs = jnp.asarray(probs.numpy())
    want_w, want_e = jax.lax.top_k(jprobs, k)
    got_w, got_e = moe.top_k(probs, k)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    assert (got_e[:, 0] % 2 == 0).all()          # the pair's lower one
    loose = torch.topk(probs, k).indices
    assert not np.array_equal(loose.numpy(), np.asarray(want_e))


def test_positions_equal_the_one_hot_cumsum():
    """The stable-sort positions equal the reference's cumsum over the
    (N·k, E) one-hot on a skewed draw, and the counts its column sums."""
    rng = np.random.default_rng(8)
    e = 8
    flat = rng.choice(e, size=3000, p=np.r_[0.5, np.full(7, 0.5 / 7)])
    onehot = np.eye(e, dtype=np.int64)[flat]
    want = np.take_along_axis(np.cumsum(onehot, 0) - 1, flat[:, None],
                              1)[:, 0]
    pos, counts = moe._positions(torch.from_numpy(flat), e)
    np.testing.assert_array_equal(pos.numpy(), want)
    np.testing.assert_array_equal(counts.numpy(), onehot.sum(0))


# --------------------------------------------------------------------------
# forward_shard_map on CPU mesh positions
# --------------------------------------------------------------------------

def _cpu_mesh(n_data: int, n_model: int) -> collectives.Mesh:
    return collectives.Mesh([["cpu"] * n_model] * n_data, ("data", "model"))


@pytest.mark.parametrize("geometry", [(2, 2), (2, 1), (4, 2)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_forward_shard_map_matches_forward_where_nothing_drops(geometry):
    """At capacity factor 8.0 (nothing drops locally or globally) the
    mesh layout's output equals ``forward``'s within 3e-4 (the
    reference's bound), and its aux the mean over the data positions of
    ``forward``'s aux on each one's rows; so do the gradients of
    Σ out·g + aux with respect to x and every parameter."""
    d, f, e, k = 32, 64, 4, 2
    n_data = geometry[0]
    params, x = _np_params(d, f, e), _x((4, 16, d), seed=5)
    g = torch.from_numpy(_x((4, 16, d), seed=6)) / x[..., 0].size
    kw = dict(n_experts=e, top_k=k, capacity_factor=8.0)

    def oracle(p, xx):
        out, st = moe.forward(p, xx, **kw)
        auxes = [moe.forward(p, blk, **kw)[1].aux_loss
                 for blk in xx.chunk(n_data)]
        return out, st.dropped_frac, sum(auxes) / n_data

    def sharded(p, xx):
        mesh = _cpu_mesh(*geometry)
        out, st = moe.forward_shard_map(p, xx, mesh=mesh, **kw)
        mesh.close()
        return out, st.dropped_frac, st.aux_loss

    outs = []
    for fn in (oracle, sharded):
        tp = tree.map(lambda t: t.requires_grad_(True), _torch(params))
        tx = torch.from_numpy(x).requires_grad_(True)
        out, dropped, aux = fn(tp, tx)
        (torch.sum(out * g) + aux).backward()
        outs.append((out.detach(), float(dropped), aux.detach(), tx.grad,
                     [t.grad for t in tree.leaves(tp)]))
    (want, wdrop, waux, wgx, wgp), (got, drop, aux, gx, gp) = outs
    assert drop == wdrop == 0.0
    torch.testing.assert_close(got, want, **SHARD_TOL)
    torch.testing.assert_close(aux, waux, **SHARD_TOL)
    torch.testing.assert_close(gx, wgx, **SHARD_TOL)
    for a, b in zip(gp, wgp):
        torch.testing.assert_close(a, b, **SHARD_TOL)


_REFERENCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.models import moe
from repro.distributed import compat, sharding as shd
inp = dict(np.load(sys.argv[1]))
mp = {"router": {"w": jnp.asarray(inp["router"])},
      "w_gate": jnp.asarray(inp["w_gate"]), "w_up": jnp.asarray(inp["w_up"]),
      "w_down": jnp.asarray(inp["w_down"])}
mesh = compat.make_mesh((2, 4), ("data", "model"))
with shd.use_mesh(mesh):
    xs = jax.device_put(jnp.asarray(inp["x"]),
                        NamedSharding(mesh, P("data", None, None)))
    mps = jax.device_put(mp, jax.tree.map(
        lambda _: NamedSharding(mesh, P()), mp))
    out, st = jax.jit(lambda m, xx: moe.forward_shard_map(
        m, xx, n_experts=4, top_k=2, capacity_factor=1.25))(mps, xs)
np.savez(sys.argv[2], out=np.asarray(out), aux=np.asarray(st.aux_loss),
         dropped=np.asarray(st.dropped_frac))
"""


def test_forward_shard_map_matches_the_reference_at_local_capacity(
        tmp_path):
    """(data 2, model 4) at capacity factor 1.25: each data position's
    32 tokens fill their own 20-slot buffers (local capacity), so
    assignments drop as the reference's shard_map drops them — dropped
    share exactly, outputs and aux within 1e-5."""
    d, f, e, k = 32, 64, 4, 2
    params, x = _np_params(d, f, e), _x((4, 16, d), seed=9)
    np.savez(tmp_path / "in.npz", x=x, router=params["router"]["w"],
             w_gate=params["w_gate"], w_up=params["w_up"],
             w_down=params["w_down"])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(_ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _REFERENCE,
                           str(tmp_path / "in.npz"),
                           str(tmp_path / "out.npz")], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp_path / "out.npz") as z:
        want = dict(z)
    mesh = _cpu_mesh(2, 4)
    with torch.no_grad(), moe.record_routes() as routes:
        out, st = moe.forward_shard_map(_torch(params), torch.from_numpy(x),
                                        n_experts=e, top_k=k,
                                        capacity_factor=1.25, mesh=mesh)
    mesh.close()
    assert len(routes) == 8 and {r.where for r in routes} == set(
        mesh.positions())
    assert all(torch.equal(r.kept, r.position < 20) for r in routes)
    np.testing.assert_allclose(out.numpy(), want["out"], **TOL)
    np.testing.assert_allclose(float(st.aux_loss), float(want["aux"]),
                               **TOL)
    assert float(st.dropped_frac) == float(want["dropped"]) > 0


def test_forward_shard_map_without_a_mesh_is_forward_and_checks_shapes():
    d, f, e, k = 32, 64, 4, 2
    params, x = _torch(_np_params(d, f, e)), torch.from_numpy(
        _x((4, 16, d), seed=10))
    a, sa = moe.forward_shard_map(params, x, n_experts=e, top_k=k)
    b, sb = moe.forward(params, x, n_experts=e, top_k=k)
    assert torch.equal(a, b) and torch.equal(sa.aux_loss, sb.aux_loss)
    for grid, axes in (([["cpu"] * 3] * 2, ("data", "model")),
                       (["cpu"] * 2, ("shard",))):
        mesh = collectives.Mesh(grid, axes)
        with pytest.raises(ValueError):
            moe.forward_shard_map(params, x, n_experts=e, top_k=k,
                                  mesh=mesh)
        mesh.close()


@pytest.mark.parametrize("remat", [False, True])
def test_transformer_runs_moe_impl_shard_map_on_the_mesh_it_is_given(remat):
    """``moe_impl="shard_map"``: with no mesh the layer is ``forward`` (as
    the reference off a mesh), bit for bit; on a (2, 2) CPU mesh at
    capacity factor 8.0 the logits and the xent gradients (aux weight 0:
    the mesh's aux is local, see above) equal the gspmd path's within
    3e-4, under remat too (the recompute runs the positions again), and
    each layer's aux is the mesh's."""
    from repro_torch import optim
    from repro_torch.models import transformer as tfm
    cfg = tfm.TransformerConfig(
        n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
        vocab_size=64, n_experts=4, moe_top_k=2, capacity_factor=8.0,
        compute_dtype=torch.float32, remat=remat)
    params = tfm.init(torch.Generator().manual_seed(3), cfg)
    tokens = torch.randint(0, 64, (4, 8),
                           generator=torch.Generator().manual_seed(4))
    sm = dataclasses.replace(cfg, moe_impl="shard_map")
    a, aux_a = tfm.logits_fn(params, cfg, tokens)
    b, aux_b = tfm.logits_fn(params, sm, tokens)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    mesh = _cpu_mesh(2, 2)
    try:
        c, aux_c = tfm.logits_fn(params, sm, tokens, mesh)
        torch.testing.assert_close(c, a, **SHARD_TOL)
        assert float(aux_c) != float(aux_a)
        grads = [optim.value_and_grad(
            lambda p, cf, t: tfm.loss_fn(p, cf, t, t, aux_weight=0.0,
                                         mesh=m),
            tree.map(torch.clone, params), cf, tokens, has_aux=True)[1]
            for cf, m in ((cfg, None), (sm, mesh))]
    finally:
        mesh.close()
    for (path, g), (_, h) in zip(*(tree.leaves_with_paths(x)
                                   for x in grads)):
        torch.testing.assert_close(h, g, msg=path, **SHARD_TOL)

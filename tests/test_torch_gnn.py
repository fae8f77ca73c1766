"""Port parity of the graph family: ``repro_torch.models.gnn`` (GatedGCN:
``init``, ``forward``, ``loss_fn``, ``forward_partitioned``,
``loss_fn_partitioned``), ``repro_torch.data.graph``,
``repro_torch.configs.gatedgcn``, ``checkpoint.gnn_params_from_numpy`` and
the tree helpers on a ``GraphBatch``, against the live JAX package on the
CPU.

The models run at ``make_reduced()`` (3 layers, d 16) and at the
reference test's molecule config, on parameters the reference
initialises and carries across by ``gnn_params_from_numpy``.  The data
generators' arrays must equal the reference's bit for bit (dtype
included).  Tolerances: losses and logits within rtol = atol = 1e-5,
gradients within rtol = atol = 1e-4 (f32 sums in other orders); the
partitioned loss within the reference's own bound
(``tests/test_perf_impls.py``, rtol 1e-5) of ``loss_fn``.  A cell step
(lr 1e-4) is held by its update (new − old) within rtol 1e-3,
atol 1e-6, and its first moment within rtol 1e-4, atol 1e-6.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import registry as jregistry
from repro.configs import shapes as jshapes
from repro.data import graph as jgraph
from repro.models import gnn as jgnn
from repro_torch import optim, tree
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import registry, shapes
from repro_torch.data import graph
from repro_torch.distributed import collectives
from repro_torch.launch import train
from repro_torch.models import gnn

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-3, atol=1e-6)
MOMENT_TOL = dict(rtol=1e-4, atol=1e-6)
FIELDS = ("node_feat", "edge_src", "edge_dst", "edge_mask", "node_mask",
          "labels", "graph_id")
#: the reference test's molecule config (``tests/test_archs.py``)
MOLECULE = dict(n_layers=3, d_hidden=16, d_feat=16, n_classes=10,
                graph_level=True, remat=False)


def _leaves(jtree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(jtree)[0]}


def _carried(jcfg, seed: int = 0):
    """(port cfg, reference params, the port's params from them)."""
    cfg = gnn.GatedGCNConfig(**dataclasses.asdict(jcfg))
    jparams = jgnn.init(jax.random.key(seed), jcfg)
    return cfg, jparams, ckpt.gnn_params_from_numpy(
        _leaves(jparams), cfg, device="cpu")


def _same_batch(got: gnn.GraphBatch, want) -> None:
    for f in FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.n_graphs == want.n_graphs


@functools.lru_cache(maxsize=None)
def _graphs():
    """A reduced-config graph pair (reference, port) and the molecule
    pair."""
    jcfg = jregistry.get("gatedgcn").make_reduced()
    jg = jgraph.random_graph(0, 200, 900, jcfg.d_feat, jcfg.n_classes)
    g = graph.random_graph(0, 200, 900, jcfg.d_feat, jcfg.n_classes,
                           device="cpu")
    jm = jgraph.molecule_batch(0, 8, 30, 64, 16, 10)
    m = graph.molecule_batch(0, 8, 30, 64, 16, 10, device="cpu")
    return jcfg, jg, g, jm, m


def _tree_close(got, want: dict, tol=TOL) -> None:
    paths = tree.leaves_with_paths(got)
    assert sorted(p for p, _ in paths) == sorted(want)
    for path, leaf in paths:
        np.testing.assert_allclose(leaf.detach().numpy(), want[path],
                                   err_msg=path, **tol)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def test_random_graph_and_molecule_batch_are_bitwise_the_reference():
    _, jg, g, jm, m = _graphs()
    _same_batch(g, jg)
    _same_batch(m, jm)
    _same_batch(graph.random_graph(3, 50, 90, 5, 3, n_communities=40,
                                   device="cpu"),
                jgraph.random_graph(3, 50, 90, 5, 3, n_communities=40))


def test_neighbor_sampler_is_bitwise_the_reference():
    _, jg, g, _, _ = _graphs()
    want = jgraph.NeighborSampler(200, np.asarray(jg.edge_src),
                                  np.asarray(jg.edge_dst)).sample(
        4, np.arange(16), (5, 3), np.asarray(jg.node_feat),
        np.asarray(jg.labels))
    got = graph.NeighborSampler(200, g.edge_src, g.edge_dst).sample(
        4, np.arange(16), (5, 3), g.node_feat, g.labels, device="cpu")
    _same_batch(got, want)
    assert got.node_feat.shape[0] == 16 * 21


@pytest.mark.parametrize("n_shards", [3, 4])
def test_partition_by_dst_is_bitwise_the_reference(n_shards):
    _, jg, g, _, _ = _graphs()
    _same_batch(graph.partition_by_dst(g, n_shards),
                jgraph.partition_by_dst(jg, n_shards))


# --------------------------------------------------------------------------
# config, registry, parameters
# --------------------------------------------------------------------------

def test_gatedgcn_config_matches_the_reference_for_every_shape():
    arch, want = registry.get("gatedgcn"), jregistry.get("gatedgcn")
    assert (arch.family, arch.source) == (want.family, want.source)
    assert list(arch.shapes) == list(jshapes.GNN_SHAPES)
    for name, shape in shapes.GNN_SHAPES.items():
        assert (dataclasses.asdict(arch.make_config(shape))
                == dataclasses.asdict(want.make_config(
                    jshapes.GNN_SHAPES[name]))), name
    assert (dataclasses.asdict(arch.make_config())
            == dataclasses.asdict(want.make_config()))
    assert (dataclasses.asdict(arch.make_reduced())
            == dataclasses.asdict(want.make_reduced()))


def test_gnn_params_from_numpy_refuses_a_wrong_layout():
    jcfg = jregistry.get("gatedgcn").make_reduced()
    cfg, jparams, params = _carried(jcfg)
    leaves = _leaves(jparams)
    assert params["layers"]["E1"]["w"].shape == (3, 16, 16)
    # the init draws the reference's layout
    mine = gnn.init(torch.Generator().manual_seed(0), cfg)
    assert ({p: tuple(x.shape) for p, x in tree.leaves_with_paths(mine)}
            == {p: a.shape for p, a in leaves.items()})
    bad = dict(leaves)
    bad["['layers']['E1']['w']"] = bad["['layers']['E1']['w']"][:2]
    with pytest.raises(ValueError, match="E1"):
        ckpt.gnn_params_from_numpy(bad, cfg, device="cpu")
    unstacked = dict(leaves)
    unstacked["['layers']['B2']['w']"] = leaves["['layers']['B2']['w']"][0]
    with pytest.raises(ValueError, match="B2"):
        ckpt.gnn_params_from_numpy(unstacked, cfg, device="cpu")
    missing = {k: v for k, v in leaves.items() if "head" not in k}
    with pytest.raises(KeyError, match="head"):
        ckpt.gnn_params_from_numpy(missing, cfg, device="cpu")
    with pytest.raises(ValueError, match="embed_h"):
        ckpt.gnn_params_from_numpy(
            leaves, dataclasses.replace(cfg, d_feat=25), device="cpu")


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _case(kind: str, remat: bool):
    """(reference cfg, batch, params; port cfg, batch, params; the
    reference's loss and gradients) of a node or molecule case."""
    jcfg, jg, g, jm, m = _graphs()
    if kind == "molecule":
        jcfg, jg, g = jgnn.GatedGCNConfig(**MOLECULE), jm, m
    jcfg = dataclasses.replace(jcfg, remat=remat)
    cfg, jparams, params = _carried(jcfg)
    (want, _), wgrads = jax.value_and_grad(
        lambda p: jgnn.loss_fn(p, jcfg, jg), has_aux=True)(jparams)
    return jcfg, jg, jparams, cfg, g, params, want, wgrads


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("kind", ["node", "molecule"])
def test_forward_loss_and_gradients_match_the_reference(kind, remat):
    jcfg, jg, jparams, cfg, g, params, want, wgrads = _case(kind, remat)
    logits = gnn.forward(params, cfg, g)
    np.testing.assert_allclose(
        logits.numpy(), np.asarray(jgnn.forward(jparams, jcfg, jg)),
        **LOSS_TOL)
    (loss, aux), grads = optim.value_and_grad(gnn.loss_fn, params, cfg, g,
                                              has_aux=True)
    np.testing.assert_allclose(float(loss), float(want), **LOSS_TOL)
    assert float(aux["loss"]) == float(loss)
    _tree_close(grads, _leaves(wgrads))


@pytest.mark.parametrize("kind", ["node", "molecule"])
def test_one_cell_step_matches_the_reference(kind):
    """The reference's ``launch/cells.py`` step (clip 1.0, AdamW at lr
    1e-4, no weight decay) with remat on: loss, grad norm, each
    parameter's update and the first moment."""
    _, _, jparams, cfg, g, params, want, wgrads = _case(kind, True)
    clipped, norm = joptim.clip_by_global_norm(wgrads, 1.0)
    jnew, jstate = joptim.adam_update(
        clipped, joptim.adam_init(jparams), jparams,
        joptim.AdamConfig(lr=1e-4, weight_decay=0.0))
    stepped = tree.map(torch.clone, params)      # the step is in place
    new, state, metrics = train.cell_step(gnn.loss_fn, cfg, stepped,
                                          optim.adam_init(stepped), g)
    np.testing.assert_allclose(float(metrics["loss"]), float(want),
                               **LOSS_TOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(norm),
                               **TOL)
    old, jnew = _leaves(jparams), _leaves(jnew)
    _tree_close(tree.map(torch.sub, new, params),
                {p: jnew[p] - old[p] for p in jnew}, STEP_TOL)
    _tree_close(state.mu, _leaves(jstate.mu), MOMENT_TOL)


def test_a_cell_step_on_a_sampled_minibatch_lowers_its_loss():
    """The minibatch cell: loss on the seeds only (labels -1 elsewhere);
    a step at lr 1e-2 lowers it, as the reference's smoke checks."""
    jcfg, _, g, _, _ = _graphs()
    cfg = gnn.GatedGCNConfig(**dataclasses.asdict(jcfg))
    sub = graph.NeighborSampler(200, g.edge_src, g.edge_dst).sample(
        0, np.arange(16), (5, 3), g.node_feat, g.labels, device="cpu")
    params = gnn.init(torch.Generator().manual_seed(0), cfg)
    before = float(gnn.loss_fn(params, cfg, sub)[0])
    (_, _), grads = optim.value_and_grad(gnn.loss_fn, params, cfg, sub,
                                         has_aux=True)
    new, _ = optim.adam_update(grads, optim.adam_init(params), params,
                               optim.AdamConfig(lr=1e-2))
    assert float(gnn.loss_fn(new, cfg, sub)[0]) < before
    new, state, metrics = train.cell_step(gnn.loss_fn, cfg, params,
                                          optim.adam_init(params), sub)
    assert int(state.step) == 1 and float(metrics["grad_norm"]) > 0


@pytest.mark.parametrize("remat", [False, True])
def test_partitioned_loss_and_gradient_on_four_positions(remat):
    """loss_fn_partitioned on 4 CPU mesh positions against the
    reference's loss_fn on the unpartitioned graph: loss within 1e-5,
    every gradient leaf within 1e-4."""
    jcfg, jg, g, _, _ = _graphs()
    jcfg = dataclasses.replace(jcfg, remat=remat, impl="partitioned")
    cfg, jparams, params = _carried(jcfg)
    (want, _), wgrads = jax.value_and_grad(
        lambda p: jgnn.loss_fn(p, jcfg, jg), has_aux=True)(jparams)
    mesh = collectives.Mesh(["cpu"] * 4, ("data",))
    gp = graph.partition_by_dst(g, 4)
    (loss, _), grads = optim.value_and_grad(
        lambda p, b: gnn.loss_fn_partitioned(p, cfg, b, mesh), params, gp,
        has_aux=True)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    _tree_close(grads, _leaves(wgrads))
    # off the mesh the partitioned layout gives loss_fn's value
    off = gnn.loss_fn_partitioned(params, cfg, gp)[0]
    np.testing.assert_allclose(float(off), float(want), rtol=1e-5)
    # a (2, 2) mesh splits the nodes over both axes, in rank order
    grid = collectives.Mesh([["cpu"] * 2] * 2, ("data", "model"))
    loss2 = gnn.loss_fn_partitioned(params, cfg, gp, grid)[0]
    np.testing.assert_allclose(float(loss2), float(want), rtol=1e-5)
    with pytest.raises(ValueError, match="axes"):
        gnn.forward_partitioned(params, cfg, gp,
                                collectives.Mesh(["cpu"] * 4, ("pod",)))


def test_tree_helpers_rebuild_a_graph_batch():
    _, _, g, _, m = _graphs()
    assert [p for p, _ in tree.leaves_with_paths(m)] == [
        f".{f}" for f in FIELDS]
    moved = tree.to(m, "meta")
    assert isinstance(moved, gnn.GraphBatch) and moved.n_graphs == 8
    assert all(getattr(moved, f).is_meta for f in FIELDS)
    doubled = tree.map(lambda x: x * 2, m)
    assert isinstance(doubled, gnn.GraphBatch) and doubled.n_graphs == 8
    assert torch.equal(doubled.node_feat, m.node_feat * 2)
    back = tree.unflatten(g, tree.leaves(m))
    assert back.n_graphs == g.n_graphs == 1
    assert torch.equal(back.labels, m.labels)
    with pytest.raises(ValueError, match="more leaves"):
        tree.unflatten(g, tree.leaves(m) + [m.labels])
    # numpy leaves become tensors on the way
    host = gnn.GraphBatch(*(getattr(g, f).numpy() for f in FIELDS))
    assert isinstance(tree.to(host, "cpu").edge_src, torch.Tensor)

"""Port parity of the recsys family's training half: ``bce_loss``,
``dlrm_loss``, ``sasrec_loss``, ``dien_loss``, ``mind_loss`` and the
training cells' step (``launch.train.cell_step``, the reference's
``launch/cells.py`` ``train_step``) against the live JAX package, on the
CPU.

Each arch runs at its ``make_reduced()`` config on parameters the
reference initialises, carried across by
``checkpoint.recsys_params_from_numpy``, and on the reference data
generators' batches with PAD_ID added to exercise the masks.  SASRec's
attention takes the flash kernel's plain version forward and the
reference's recompute backward.

Tolerances: losses within rtol = atol = 1e-5; gradients and the second
moment after a step within rtol = atol = 1e-4 (f32; the two frameworks
sum matmuls and reductions in different orders).  A first AdamW step at
lr 1e-4 moves a parameter by about 1e-4, so the step is held by what it
moves: each parameter's update (new − old) within rtol 1e-3, atol 1e-6,
and the first moment (0.1 × the clipped gradient) within rtol 1e-4,
atol 1e-6; a dropped, zero or mis-scaled update fails either.  The tie
cases (a logit of exactly 0 in ``bce_loss``, an all-PAD MIND history
whose interests are all zero) must split the gradient as JAX does.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import registry as jregistry
from repro.data import recsys as jdata
from repro.models import recsys as jrec
from repro_torch import optim, tree
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.launch import train
from repro_torch.models import recsys

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
#: a step's update (new − old, about lr = 1e-4) and first moment
STEP_TOL = dict(rtol=1e-3, atol=1e-6)
MOMENT_TOL = dict(rtol=1e-4, atol=1e-6)
ARCHS = ("dlrm-rm2", "sasrec", "dien", "mind")
_INIT = {"dlrm-rm2": jrec.dlrm_init, "sasrec": jrec.sasrec_init,
         "dien": jrec.dien_init, "mind": jrec.mind_init}
_LOSS = {"dlrm-rm2": jrec.dlrm_loss, "sasrec": jrec.sasrec_loss,
         "dien": jrec.dien_loss, "mind": jrec.mind_loss}
#: the reference's ``launch/cells.py`` optimizer
JADAM = joptim.AdamConfig(lr=1e-4, weight_decay=0.0)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _port_cfg(cfg):
    return getattr(recsys, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _leaves(jtree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(jtree)[0]}


def _carried(arch: str, seed: int = 0):
    """(reduced cfg, reference params, the port's params from them)."""
    cfg = jregistry.get(arch).make_reduced()
    jparams = _INIT[arch](jax.random.key(seed), cfg)
    params = ckpt.recsys_params_from_numpy(arch, _leaves(jparams),
                                           _port_cfg(cfg), device="cpu")
    return cfg, jparams, params


def _pad_rows(ids: np.ndarray, n_pad: int) -> np.ndarray:
    """Left-pad the first rows with PAD_ID, as short histories arrive."""
    ids = ids.copy()
    for i in range(min(ids.shape[0] - 1, 3)):
        ids[i, :min((i + 1) * n_pad, ids.shape[1] - 1)] = jrec.PAD_ID
    return ids


def _batch(arch: str, cfg, n: int = 8, seed: int = 0):
    """The reference generator's batch with PADs, as (JAX, port)."""
    if arch == "dlrm-rm2":
        jb = jdata.dlrm_batch(seed, n, n_sparse=cfg.n_sparse,
                              n_rows=cfg.n_rows)
        sparse = np.asarray(jb.sparse).copy()
        sparse[0, 1] = jrec.PAD_ID
        jb = jb._replace(sparse=jnp.asarray(sparse))
    elif arch == "sasrec":
        jb = jdata.sasrec_batch(seed, n, seq_len=cfg.seq_len,
                                n_items=cfg.n_items)
        jb = jb._replace(items=jnp.asarray(_pad_rows(np.asarray(jb.items),
                                                     3)),
                         targets=jnp.asarray(_pad_rows(
                             np.asarray(jb.targets), 2)))
    elif arch == "dien":
        jb = jdata.dien_batch(seed, n, seq_len=cfg.seq_len,
                              n_items=cfg.n_items)
        hist = _pad_rows(np.asarray(jb.history), 4)
        hist[3, :] = jrec.PAD_ID
        jb = jb._replace(history=jnp.asarray(hist))
    else:
        jb = jdata.mind_batch(seed, n, seq_len=cfg.seq_len,
                              n_items=cfg.n_items)
        jb = jb._replace(history=jnp.asarray(_pad_rows(
            np.asarray(jb.history), 2)))
    port = getattr(recsys, type(jb).__name__)(*(_t(a) for a in jb))
    return jb, port


def _tree_close(got, want: dict, tol=TOL) -> None:
    """Every leaf of the port's tree against the reference's leaf of the
    same path."""
    paths = tree.leaves_with_paths(got)
    assert sorted(p for p, _ in paths) == sorted(want)
    for path, leaf in paths:
        np.testing.assert_allclose(leaf.detach().numpy(), want[path],
                                   err_msg=path, **tol)


def _jgrad(arch, jparams, cfg, jb):
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: _LOSS[arch](p, cfg, b), has_aux=True))(jparams, jb)
    return loss, grads


@functools.lru_cache(maxsize=None)
def _reference(arch: str) -> dict:
    """The reference's loss, gradients and one cell step on ``_batch``,
    computed once per arch."""
    cfg, jparams, params = _carried(arch)
    jb, tb = _batch(arch, cfg)
    loss, grads = _jgrad(arch, jparams, cfg, jb)
    clipped, norm = joptim.clip_by_global_norm(grads, 1.0)
    new, state = joptim.adam_update(clipped, joptim.adam_init(jparams),
                                    jparams, JADAM)
    return dict(cfg=cfg, params=params, batch=tb, loss=float(loss),
                grads=_leaves(grads), norm=float(norm), new=_leaves(new),
                old=_leaves(jparams),
                mu=_leaves(state.mu), nu=_leaves(state.nu),
                step=int(state.step))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_match_the_reference(arch):
    ref = _reference(arch)
    (loss, aux), grads = optim.value_and_grad(
        recsys.LOSSES[arch], ref["params"], _port_cfg(ref["cfg"]),
        ref["batch"], has_aux=True)
    np.testing.assert_allclose(float(loss), ref["loss"], **LOSS_TOL)
    assert float(aux["loss"]) == float(loss)
    _tree_close(grads, ref["grads"])
    # the table gradient lands only on the rows the batch read
    table = grads["tables"] if arch == "dlrm-rm2" else (
        grads["item_embed"]["table"])
    rows = table.reshape(-1, table.shape[-1])
    assert 0 < int((rows.abs().sum(-1) > 0).sum()) < rows.shape[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_one_cell_step_matches_the_reference(arch):
    """value_and_grad, clip 1.0, AdamW at lr 1e-4: parameters, moments
    and step after one step, and the step's loss and grad norm."""
    ref = _reference(arch)
    params = ref["params"]
    stepped = tree.map(torch.clone, params)      # the step is in place
    new, state, metrics = train.cell_step(
        recsys.LOSSES[arch], _port_cfg(ref["cfg"]), stepped,
        optim.adam_init(stepped), ref["batch"])
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"],
                               **LOSS_TOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]), ref["norm"],
                               **TOL)
    _tree_close(tree.map(torch.sub, new, params),
                {p: ref["new"][p] - ref["old"][p] for p in ref["new"]},
                STEP_TOL)
    _tree_close(state.mu, ref["mu"], MOMENT_TOL)
    _tree_close(state.nu, ref["nu"])
    assert int(state.step) == ref["step"] == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_a_checkpoint_of_params_and_adam_state_restores_leaf_for_leaf(
        arch, tmp_path):
    """Save → restore of a parameter tree with lists (an MLP's layers)
    and its Adam state: every leaf comes back at its own path, into a
    target of zeros, and ``restore_resharded`` places through a list."""
    cfg, _, params = _carried(arch)
    state = optim.adam_init(params)
    state = state._replace(mu=tree.map(lambda p: p + 1.0, params),
                           nu=tree.map(lambda p: p * 2.0, params))
    saved = {"params": params, "opt": state}
    ckpt.save(str(tmp_path), 1, saved)
    like = tree.map(torch.zeros_like, saved)
    path = str(tmp_path / "step_00000001")
    placements = {"params": {k: ([torch.device("cpu")] * len(v)
                                 if isinstance(v, list) else None)
                             for k, v in params.items()}, "opt": None}
    for got in (ckpt.restore(path, like),
                ckpt.restore_resharded(path, like, placements)):
        want = tree.leaves_with_paths(saved)
        assert [p for p, _ in tree.leaves_with_paths(got)] == [
            p for p, _ in want]
        for (p, a), (_, b) in zip(tree.leaves_with_paths(got), want):
            assert torch.equal(a, b), p


@pytest.mark.parametrize("arch", ARCHS)
def test_an_adam_step_at_lr_1e2_lowers_the_loss(arch):
    """The reference's own check (``tests/test_archs.py``): one step at
    lr 1e-2 on a batch lowers the loss on that batch."""
    cfg, _, params = _carried(arch)
    _, tb = _batch(arch, cfg, n=16)
    loss = recsys.LOSSES[arch]
    pcfg = _port_cfg(cfg)
    before = float(loss(params, pcfg, tb)[0])
    (_, _), grads = optim.value_and_grad(loss, params, pcfg, tb,
                                         has_aux=True)
    new, _ = optim.adam_update(grads, optim.adam_init(params), params,
                               optim.AdamConfig(lr=1e-2))
    assert float(loss(new, pcfg, tb)[0]) < before


# --------------------------------------------------------------------------
# ties: the gradient of a max splits as JAX splits it
# --------------------------------------------------------------------------

def test_bce_loss_tie_at_zero_splits_the_gradient_as_jax():
    logits = np.array([0.0, 0.0, 1.5, -2.0, 0.0, 3.0], np.float32)
    labels = np.array([1.0, 0.0, 1.0, 0.0, 0.5, 0.0], np.float32)
    want_l, want_g = jax.value_and_grad(jrec.bce_loss)(
        jnp.asarray(logits), jnp.asarray(labels))
    x = _t(logits).requires_grad_(True)
    loss = recsys.bce_loss(x, _t(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_l), **LOSS_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                               rtol=1e-6, atol=1e-7)


def test_mind_all_pad_history_splits_the_max_over_interests_as_jax():
    cfg, jparams, params = _carried("mind")
    jb, tb = _batch("mind", cfg, n=4)
    hist = np.asarray(jb.history).copy()
    hist[1, :] = jrec.PAD_ID                       # four zero capsules
    jb = jb._replace(history=jnp.asarray(hist))
    tb = tb._replace(history=_t(hist))
    caps = recsys.mind_interests(params, _port_cfg(cfg), tb.history)
    assert not caps[1].any()
    want_loss, want_grads = _jgrad("mind", jparams, cfg, jb)
    (loss, _), grads = optim.value_and_grad(
        recsys.mind_loss, params, _port_cfg(cfg), tb, has_aux=True)
    np.testing.assert_allclose(float(loss), float(want_loss), **LOSS_TOL)
    _tree_close(grads, _leaves(want_grads))
    # the candidates of the all-PAD row score 0 under every interest, so
    # its table rows' gradient comes from that row alone through the tie
    cand = np.concatenate([np.asarray(jb.target)[1:2],
                           np.asarray(jb.negatives)[1]])
    others = np.concatenate([np.asarray(jb.target)[[0, 2, 3]],
                             np.asarray(jb.negatives)[[0, 2, 3]].ravel(),
                             hist[[0, 2, 3]].ravel()])
    alone = sorted(set(cand.tolist()) - set(others.tolist()))
    assert alone
    got = grads["item_embed"]["table"][alone].numpy()
    want = np.asarray(want_grads["item_embed"]["table"])[alone]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_dien_interest_states_hold_one_autograd_node():
    """The GRU's interest states are stacked and its steps read unbind's
    views: autograd holds no in-place copy and no whole-sequence slice a
    step (the gradients against JAX's scan are the tests above)."""
    cfg, _, params = _carried("dien")
    _, tb = _batch("dien", cfg, n=4)
    pcfg = _port_cfg(cfg)
    hist = recsys._dien_embed(params, pcfg, tb.history).requires_grad_(True)
    mask = (tb.history != recsys.PAD_ID).float()
    with torch.enable_grad():
        states = recsys._interest_states(
            {"gru1": {k: v.requires_grad_(True)
                      for k, v in params["gru1"].items()}}, pcfg, hist, mask)
    assert type(states.grad_fn).__name__.startswith("Stack")
    seen, todo = set(), [states.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    names = {type(fn).__name__ for fn in seen}
    assert not any("CopySlices" in n or n.startswith("Select")
                   for n in names), names
    assert "UnbindBackward0" in names

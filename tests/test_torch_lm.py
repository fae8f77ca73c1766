"""Port parity of the LM family's training half, dense and MoE:
``repro_torch.models.transformer`` (``logits_fn`` with its MoE aux loss,
``loss_fn``, ``cell_loss``, ``hidden_states`` under remat,
``_mlp_forward`` at bf16, ``n_params`` / ``n_active_params``),
``repro_torch.configs`` (``llama3_8b``, ``internlm2_1_8b``,
``stablelm_3b``, ``mixtral_8x22b``, ``olmoe_1b_7b``),
``checkpoint.lm_params_from_numpy`` and checkpoints of MoE parameters both
ways, and one training-cell step (``launch.train.cell_step``, the
reference's ``launch/cells.py::_lm_train_cell``), against the live JAX
package on the CPU.

Each arch runs at its ``make_reduced()`` config (2 layers, d 64, f32) on
parameters the reference's ``transformer.init`` draws, carried across by
``lm_params_from_numpy``; attention takes the flash kernel's plain
version forward and the reference's recompute backward.

Tolerances: logits and losses within rtol = atol = 1e-5; gradients and
the second moment within rtol = atol = 1e-4 (f32 sums in other orders);
a step's update (new − old, about lr = 1e-4) within rtol 1e-3,
atol 1e-6, its first moment within rtol 1e-4, atol 1e-6.  At bf16 the
reference's compiled scan keeps some products above bf16 between ops
(XLA's excess precision), so the two diverge by a few bf16 ulps a layer:
there the logits and every gradient leaf are held in norm, within
:data:`BF16_LOGITS_REL` and :data:`BF16_GRAD_REL` of the reference's,
and the loss within :data:`BF16_LOSS`.  Those bounds cannot see one
bf16 rounding of the logits, so the logits are also held to the f32
product of the bf16 hidden state and unembedding within 1e-6.  The MLP
block alone at bf16 (C7) must put at most 1% of its outputs beyond one
bf16 ulp of the reference's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.checkpoint import checkpoint as jckpt
from repro.configs import registry as jregistry
from repro.models import transformer as jtfm
from repro_torch import optim, tree
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import train
from repro_torch.models import moe
from repro_torch.models import transformer as tfm

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-3, atol=1e-6)
MOMENT_TOL = dict(rtol=1e-4, atol=1e-6)
#: bf16: ||got - want|| / ||want|| of the logits and of each gradient
#: leaf, about twice the largest read on the CPU (logits 0.0070-0.0080,
#: gradient leaves up to 0.0123-0.0149 over the three archs)
BF16_LOGITS_REL = 0.02
BF16_GRAD_REL = 0.03
#: bf16: |loss - reference loss| / reference loss (read: up to 8.7e-5)
BF16_LOSS = 1e-3
ARCHS = ("llama3-8b", "internlm2-1.8b", "stablelm-3b")
#: the MoE archs run every f32 case (their reduced configs: 4 experts
#: top-2 with a window of 8, and 8 experts top-2; B·S = 48 tokens at
#: capacity factor 1.25)
MOE_ARCHS = ("mixtral-8x22b", "olmoe-1b-7b")
F32_ARCHS = ARCHS + MOE_ARCHS
#: the reference's ``launch/cells.py`` optimizer
JADAM = joptim.AdamConfig(lr=1e-4, weight_decay=0.0)
B, S = 2, 24


def _leaves(jtree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(jtree)[0]}


def _port_cfg(jcfg) -> tfm.TransformerConfig:
    return ckpt.enc_cfg_from_fields(dataclasses.asdict(jcfg))


def _jcfg(arch: str, **kw):
    return dataclasses.replace(jregistry.get(arch).make_reduced(), **kw)


@functools.lru_cache(maxsize=None)
def _jparams(arch: str):
    return jtfm.init(jax.random.key(0), _jcfg(arch))


def _params(arch: str) -> dict:
    """A fresh copy of the port's parameters, carried from the
    reference's draw."""
    return ckpt.lm_params_from_numpy(_leaves(_jparams(arch)),
                                     _port_cfg(_jcfg(arch)), device="cpu")


def _batch(arch: str) -> tuple[np.ndarray, np.ndarray]:
    """Tokens with PADs (id -1, read as row 0) and next-token labels
    with ignored (-1) positions."""
    rng = np.random.default_rng(len(arch))
    vocab = _jcfg(arch).vocab_size
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    tokens[1, -3:] = -1
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :4] = -1
    return tokens, labels


def _tree_close(got, want: dict, tol=TOL) -> None:
    paths = tree.leaves_with_paths(got)
    assert sorted(p for p, _ in paths) == sorted(want)
    for path, leaf in paths:
        np.testing.assert_allclose(leaf.detach().float().numpy(),
                                   want[path], err_msg=path, **tol)


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, dtype=np.float64)
    return float(np.linalg.norm(got.double().numpy() - want)
                 / np.linalg.norm(want))


@functools.lru_cache(maxsize=None)
def _reference(arch: str, remat: bool = False,
               dtype: str = "float32") -> dict:
    """The reference's logits, loss, gradients and one cell step on
    ``_batch``, computed once per case."""
    jcfg = _jcfg(arch, remat=remat, compute_dtype=getattr(jnp, dtype))
    jparams = _jparams(arch)
    tokens, labels = (jnp.asarray(a) for a in _batch(arch))
    logits, aux = jtfm.logits_fn(jparams, jcfg, tokens)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jcfg, tokens, labels), has_aux=True))(
        jparams)
    clipped, norm = joptim.clip_by_global_norm(grads, 1.0)
    new, state = joptim.adam_update(clipped, joptim.adam_init(jparams),
                                    jparams, JADAM)
    return dict(cfg=_port_cfg(jcfg), logits=np.asarray(logits),
                aux=float(aux), loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=_leaves(grads), norm=float(norm), new=_leaves(new),
                old=_leaves(jparams), mu=_leaves(state.mu),
                nu=_leaves(state.nu))


def _torch_batch(arch: str) -> dict:
    tokens, labels = _batch(arch)
    return {"tokens": torch.from_numpy(tokens),
            "labels": torch.from_numpy(labels)}


# --------------------------------------------------------------------------
# logits, loss, gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", F32_ARCHS)
def test_logits_and_loss_match_the_reference(arch):
    """Logits, the aux loss (the layers' Switch losses summed; zero for a
    dense arch), loss and its metrics within 1e-5."""
    ref = _reference(arch)
    batch = _torch_batch(arch)
    params = _params(arch)
    logits, aux = tfm.logits_fn(params, ref["cfg"], batch["tokens"])
    assert logits.dtype == torch.float32 and logits.shape == (
        B, S, ref["cfg"].vocab_size)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], **LOSS_TOL)
    assert aux.dim() == 0 and aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), ref["aux"], **LOSS_TOL)
    assert (float(aux) > 0) == ref["cfg"].is_moe
    loss, metrics = tfm.loss_fn(params, ref["cfg"], batch["tokens"],
                                batch["labels"])
    np.testing.assert_allclose(float(loss), ref["loss"], **LOSS_TOL)
    assert sorted(metrics) == sorted(ref["metrics"]) == [
        "loss", "moe_aux", "xent"]
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), ref["metrics"][k], **LOSS_TOL)
    cell, _ = tfm.cell_loss(params, ref["cfg"], batch)
    assert float(cell) == float(loss)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", F32_ARCHS)
def test_every_gradient_leaf_matches_the_reference(arch, remat):
    ref = _reference(arch, remat)
    assert ref["cfg"].remat is remat
    (loss, _), grads = optim.value_and_grad(
        tfm.cell_loss, _params(arch), ref["cfg"], _torch_batch(arch),
        has_aux=True)
    np.testing.assert_allclose(float(loss), ref["loss"], **LOSS_TOL)
    _tree_close(grads, ref["grads"])


def test_remat_recomputes_each_layer_and_its_attention(monkeypatch):
    """Under remat and autograd each layer's forward runs again in the
    backward (its attention too: 2 L attention forwards a step); without
    autograd, or without remat, once."""
    calls = []
    forward = fa_ops._FlashAttention.forward

    def counting(ctx, *args):
        calls.append(1)
        return forward(ctx, *args)

    monkeypatch.setattr(fa_ops._FlashAttention, "forward",
                        staticmethod(counting))
    arch = "llama3-8b"
    batch = _torch_batch(arch)
    for remat, want in ((True, 4), (False, 2)):
        cfg = dataclasses.replace(_port_cfg(_jcfg(arch)), remat=remat)
        calls.clear()
        optim.value_and_grad(tfm.cell_loss, _params(arch), cfg, batch,
                             has_aux=True)
        assert len(calls) == want, remat
    calls.clear()
    with torch.no_grad():
        tfm.logits_fn(_params(arch), cfg, batch["tokens"])
    assert len(calls) == 2


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_remat_recompute_routes_each_moe_layer_as_its_forward(arch):
    """Under remat each MoE layer runs twice a step; the recompute's
    routes (expert, position, kept) and router logits equal the
    forward's, and the step's gradients equal a step without remat."""
    cfg = dataclasses.replace(_port_cfg(_jcfg(arch)), remat=True)
    batch = _torch_batch(arch)
    with moe.record_routes() as routes:
        (_, _), grads = optim.value_and_grad(tfm.cell_loss, _params(arch),
                                             cfg, batch, has_aux=True)
    assert len(routes) == 2 * cfg.n_layers
    first, again = routes[:cfg.n_layers], routes[cfg.n_layers:][::-1]
    for a, b in zip(first, again):
        for x, y in zip(a[:4], b[:4]):
            assert torch.equal(x, y)
    (_, _), plain = optim.value_and_grad(
        tfm.cell_loss, _params(arch), dataclasses.replace(cfg, remat=False),
        batch, has_aux=True)
    for (path, g), (_, h) in zip(tree.leaves_with_paths(grads),
                                 tree.leaves_with_paths(plain)):
        assert torch.equal(g, h), path


@pytest.mark.parametrize("arch", F32_ARCHS)
def test_one_cell_step_matches_the_reference(arch):
    """value_and_grad, clip 1.0, AdamW at lr 1e-4: the updates, moments
    and step, the step's loss and grad norm; the step runs in place, and
    gives ``train_step``'s bits."""
    ref = _reference(arch)
    params = _params(arch)
    stepped = _params(arch)
    ids = [id(t) for t in tree.leaves(stepped)]
    new, state, metrics = train.cell_step(
        tfm.cell_loss, ref["cfg"], stepped, optim.adam_init(stepped),
        _torch_batch(arch))
    assert [id(t) for t in tree.leaves(new)] == ids
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"],
                               **LOSS_TOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]), ref["norm"],
                               **TOL)
    _tree_close(tree.map(torch.sub, new, params),
                {p: ref["new"][p] - ref["old"][p] for p in ref["new"]},
                STEP_TOL)
    _tree_close(state.mu, ref["mu"], MOMENT_TOL)
    _tree_close(state.nu, ref["nu"])
    assert int(state.step) == 1
    new2, state2, loss2, gnorm2 = train.train_step(
        lambda p, b: tfm.cell_loss(p, ref["cfg"], b), params,
        optim.adam_init(params), _torch_batch(arch), 1.0, train.CELL_ADAM,
        train.CELL_CLIP)
    assert float(loss2) == float(metrics["loss"])
    for a, b in zip(tree.leaves((new, state.mu, state.nu)),
                    tree.leaves((new2, state2.mu, state2.nu))):
        assert torch.equal(a, b)
    assert float(gnorm2) == float(metrics["grad_norm"])
    assert int(state2.step) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_a_bf16_run_matches_the_reference(arch):
    """The reduced config at bf16 compute (fp32 parameters): logits,
    loss and every gradient leaf within the module's bf16 tolerances."""
    ref = _reference(arch, False, "bfloat16")
    assert ref["cfg"].compute_dtype == torch.bfloat16
    batch = _torch_batch(arch)
    logits, _ = tfm.logits_fn(_params(arch), ref["cfg"], batch["tokens"])
    assert logits.dtype == torch.float32
    assert _rel(logits, ref["logits"]) < BF16_LOGITS_REL
    (loss, _), grads = optim.value_and_grad(
        tfm.cell_loss, _params(arch), ref["cfg"], batch, has_aux=True)
    assert abs(float(loss) - ref["loss"]) < BF16_LOSS * ref["loss"]
    for path, g in tree.leaves_with_paths(grads):
        assert g.dtype == torch.float32, path
        assert _rel(g, ref["grads"][path]) < BF16_GRAD_REL, path


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_are_the_f32_product_of_the_bf16_hidden_state(arch):
    """At bf16 the logits are the f32 product of the bf16 final hidden
    state and the bf16 unembedding, as the reference's
    ``preferred_element_type=f32`` gives them: never a bf16 product
    widened to f32, which is up to 2**-9 off."""
    cfg = dataclasses.replace(_port_cfg(_jcfg(arch)),
                              compute_dtype=torch.bfloat16)
    params = _params(arch)
    tokens = _torch_batch(arch)["tokens"]
    with torch.no_grad():
        x, _ = tfm.hidden_states(params, cfg, tokens)
        logits, _ = tfm.logits_fn(params, cfg, tokens)
    assert x.dtype == torch.bfloat16 and logits.dtype == torch.float32
    want = x.float() @ params["unembed"]["w"].bfloat16().float()
    torch.testing.assert_close(logits, want, rtol=1e-6, atol=1e-6)
    rounded = (x @ params["unembed"]["w"].bfloat16()).float()
    assert not torch.allclose(rounded, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("batched", [False, True])
def test_matmul_f32_keeps_the_product_f32_and_rounds_gradients_once(
        batched):
    """bf16 operands: the product is the f32 product of the widened
    operands (no bf16 rounding); the gradients are the products of the
    bf16-rounded cotangent, rounded once to bf16 (b a weight, or batched
    like a)."""
    from repro_torch.models import layers
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.normal(size=(2, 3, 16)).astype(
        np.float32)).bfloat16().requires_grad_(True)
    shape = (2, 16, 5) if batched else (16, 5)
    b = torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).bfloat16().requires_grad_(True)
    out = layers.matmul_f32(a, b)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, a.float() @ b.float(), rtol=1e-6,
                               atol=1e-6)
    g = torch.from_numpy(rng.normal(size=(2, 3, 5)).astype(np.float32))
    ga, gb = torch.autograd.grad(out, (a, b), g)
    gr = g.bfloat16().float()
    want_a = gr @ b.float().transpose(-1, -2)
    want_b = (a.float().transpose(-1, -2) @ gr)
    if not batched:
        want_b = want_b.sum(0)
    assert ga.dtype == gb.dtype == torch.bfloat16
    torch.testing.assert_close(ga.float(), want_a.bfloat16().float(),
                               rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(gb.float(), want_b.bfloat16().float(),
                               rtol=1e-2, atol=1e-2)
    with pytest.raises(ValueError, match="operands"):
        layers.matmul_f32(a, b.float())


def _ulps_beyond_one(got: torch.Tensor, want) -> float:
    """The share of ``got`` more than one bf16 ulp of ``want`` away."""
    want = np.asarray(want, dtype=np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    return float(np.mean(np.abs(got.float().numpy() - want) > ulp))


def test_mlp_block_at_bf16_keeps_the_gate_and_up_products_f32():
    """C7: the SwiGLU at bf16 (d 256, d_ff 1,024, 4 × 64 rows) against
    the reference's, which keeps x W_gate and x W_up in f32 through silu
    and the product: at most 1% of outputs beyond one bf16 ulp (rounding
    both products to bf16 first puts 26% beyond)."""
    rng = np.random.default_rng(0)
    d, f = 256, 1024
    x = rng.normal(size=(4, 64, d)).astype(np.float32)
    p = {"w_gate": {"w": rng.normal(size=(d, f)).astype(np.float32)
                    * d ** -0.5},
         "w_up": {"w": rng.normal(size=(d, f)).astype(np.float32)
                  * d ** -0.5},
         "w_down": {"w": rng.normal(size=(f, d)).astype(np.float32)
                    * f ** -0.5}}
    want = jtfm._mlp_forward(jax.tree.map(jnp.asarray, p),
                             jnp.asarray(x).astype(jnp.bfloat16))
    got = tfm._mlp_forward(
        tree.map(lambda a: torch.from_numpy(np.asarray(a, np.float32)), p),
        torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == (4, 64, d)
    assert _ulps_beyond_one(got, want.astype(jnp.float32)) <= 0.01


# --------------------------------------------------------------------------
# configs, sizes, parameters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_n_params_and_n_active_params_match_the_reference(arch):
    got, want = registry.get(arch).make_config(), (
        jregistry.get(arch).make_config())
    assert got.n_params() == want.n_params()
    assert got.n_active_params() == want.n_active_params() == (
        got.n_params())
    assert got.compute_dtype == torch.bfloat16 and got.remat
    # the MoE branch, on the MoE archs' published configs
    for arch_id in MOE_ARCHS:
        jmoe = jregistry.get(arch_id).make_config()
        mine = registry.get(arch_id).make_config()
        assert mine.is_moe and mine.remat
        assert mine.n_params() == jmoe.n_params()
        assert mine.n_active_params() == jmoe.n_active_params() < (
            mine.n_params())


def test_lm_params_from_numpy_refuses_a_wrong_layout():
    arch = "internlm2-1.8b"
    cfg = _port_cfg(_jcfg(arch))
    leaves = _leaves(_jparams(arch))
    params = ckpt.lm_params_from_numpy(leaves, cfg, device="cpu")
    assert params["layers"]["attn"]["wk"]["w"].shape == (2, 64, 32)
    # the port's own init draws the reference's layout
    mine = tfm.init(torch.Generator().manual_seed(0), cfg)
    assert ({p: tuple(x.shape) for p, x in tree.leaves_with_paths(mine)}
            == {p: a.shape for p, a in leaves.items()})
    bad = dict(leaves)
    bad["['layers']['attn']['wk']['w']"] = np.zeros((2, 64, 64), np.float32)
    with pytest.raises(ValueError, match="wk"):
        ckpt.lm_params_from_numpy(bad, cfg, device="cpu")
    unstacked = dict(leaves)
    unstacked["['layers']['mlp']['w_up']['w']"] = (
        leaves["['layers']['mlp']['w_up']['w']"][0])
    with pytest.raises(ValueError, match="w_up"):
        ckpt.lm_params_from_numpy(unstacked, cfg, device="cpu")
    missing = {k: v for k, v in leaves.items() if "unembed" not in k}
    with pytest.raises(KeyError, match="unembed"):
        ckpt.lm_params_from_numpy(missing, cfg, device="cpu")
    with pytest.raises(KeyError, match="bias"):
        ckpt.lm_params_from_numpy(
            dict(leaves, **{"['final_norm']['bias']": np.zeros(64)}), cfg,
            device="cpu")
    with pytest.raises(ValueError, match="embed"):
        ckpt.lm_params_from_numpy(
            leaves, dataclasses.replace(cfg, vocab_size=500), device="cpu")
    # an MoE config wants the moe leaves, not the mlp ones
    with pytest.raises(KeyError, match="moe"):
        ckpt.lm_params_from_numpy(
            leaves, dataclasses.replace(cfg, n_experts=4), device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_params_from_numpy_carries_the_moe_leaves(arch):
    """The reference's MoE leaves (router (L, d, E), w_gate / w_up
    (L, E, d, f), w_down (L, E, f, d)) arrive leaf for leaf; the port's
    init draws that layout; a leaf of the wrong shape is refused."""
    cfg = _port_cfg(_jcfg(arch))
    leaves = _leaves(_jparams(arch))
    n, d, f, e = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    params = ckpt.lm_params_from_numpy(leaves, cfg, device="cpu")
    got = params["layers"]["moe"]
    assert got["router"]["w"].shape == (n, d, e)
    assert got["w_gate"].shape == got["w_up"].shape == (n, e, d, f)
    assert got["w_down"].shape == (n, e, f, d)
    assert "mlp" not in params["layers"]
    for path, leaf in tree.leaves_with_paths(params):
        assert np.array_equal(leaf.numpy(), leaves[path]), path
    mine = tfm.init(torch.Generator().manual_seed(0), cfg)
    assert ({p: tuple(x.shape) for p, x in tree.leaves_with_paths(mine)}
            == {p: a.shape for p, a in leaves.items()})
    assert mine["layers"]["moe"]["router"]["w"].dtype == torch.float32
    bad = dict(leaves)
    bad["['layers']['moe']['w_down']"] = np.zeros((n, e, d, f), np.float32)
    with pytest.raises(ValueError, match="w_down"):
        ckpt.lm_params_from_numpy(bad, cfg, device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_checkpoints_round_trip_with_the_reference(arch, tmp_path):
    """{params, Adam state} of an MoE config saved by the port restores in
    the reference (its leaf order and shapes, the 4-D expert leaves
    included) and the reference's save restores in the port, bit for
    bit both ways."""
    cfg = _port_cfg(_jcfg(arch))
    params = _params(arch)
    state = optim.adam_init(params)
    state = state._replace(mu=tree.map(lambda p: p + 1.0, params),
                           nu=tree.map(lambda p: p * 2.0, params))
    saved = {"params": params, "opt": {"mu": state.mu, "nu": state.nu}}
    ckpt.save(str(tmp_path / "port"), 1, saved)
    jparams = _jparams(arch)
    jlike = {"params": jparams, "opt": {"mu": jparams, "nu": jparams}}
    back = jckpt.restore(str(tmp_path / "port" / "step_00000001"), jlike)
    want = {p: a for p, a in tree.leaves_with_paths(saved)}
    got = _leaves(back)
    assert sorted(got) == sorted(want)
    for path, arr in got.items():
        assert np.array_equal(arr, want[path].numpy()), path
    jpath = jckpt.save(str(tmp_path / "ref"), 2, back)
    mine = ckpt.restore(jpath, tree.map(torch.zeros_like, saved))
    for (path, a), (_, b) in zip(tree.leaves_with_paths(mine),
                                 tree.leaves_with_paths(saved)):
        assert torch.equal(a, b), path
    assert cfg.is_moe


# --------------------------------------------------------------------------
# the flash backward's row blocks (the LM's S 4,096 recompute)
# --------------------------------------------------------------------------

#: (Hq, Hkv, Sq, Sk, causal, window): causal, windowed both ways, GQA,
#: Sq != Sk, and a non-causal window whose last rows see no key
FLASH_BWD_CASES = {
    "causal_gqa": (4, 2, 37, 37, True, 0),
    "causal_window": (2, 2, 40, 40, True, 6),
    "full": (2, 1, 33, 29, False, 0),
    "window_both_ways": (2, 2, 30, 30, False, 5),
    "dead_rows": (2, 2, 40, 9, False, 4),
}


@pytest.mark.parametrize("name", sorted(FLASH_BWD_CASES))
def test_flash_backward_in_row_blocks_matches_one_recompute(name,
                                                            monkeypatch):
    """With the plane bound cut so each block holds 3 query rows, the
    gradients through the blocks (each over its live keys) equal
    autograd through the whole plain attention within 1e-5."""
    hq, hkv, sq, sk, causal, window = FLASH_BWD_CASES[name]
    rng = np.random.default_rng(len(name))
    q, k, v = (torch.from_numpy(rng.normal(size=(2, h, s, 16)).astype(
        np.float32)) for h, s in ((hq, sq), (hkv, sk), (hkv, sk)))
    g = torch.from_numpy(rng.normal(size=(2, hq, sq, 16)).astype(np.float32))
    monkeypatch.setattr(fa_ops, "BWD_PLANE", 2 * hq * sk * 3)
    assert fa_ops._bwd_rows(q, k) == 3
    inputs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, _ = fa_ops.flash_attention(*inputs, causal, window)
    got = torch.autograd.grad(out, inputs, g)
    ref_in = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        fa_ref.attention(*ref_in, causal=causal, window=window), ref_in, g)
    for a, b, what in zip(got, want, "qkv"):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=what)

"""Port parity of HI²_sup training: ``repro_torch.optim``,
``repro_torch.core.distill``, the differentiable ``flash_attention``,
``repro_torch.launch.train.fit`` / ``train_hi2_sup`` and the
``{"params", "opt"}`` checkpoints, on the CPU against the live JAX
package at small widths (2 layers, d 64, 4 heads, V 512, L 16).

The two packages cannot draw the same random initialisation, so every
trajectory starts from the reference's own: ``train_hi2_sup`` with
``n_steps=0`` returns it, and the port's ``fit`` runs from it through
the port's batch stream (numpy, the reference's draws).

Tolerances: rtol = atol = 1e-4 (DESIGN.md §11) for the loss, its aux
terms, every gradient leaf, the attention gradients and the parameters
after 5 AdamW steps; 1e-6 for the schedules and 1e-5 for AdamW and the
clip on given gradients (float32 elementwise arithmetic, no
reductions but the norm's); exact for the numpy batch stream, the
in-batch draws, and the port's own runs against themselves (resume,
monitor).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import optim as joptim
from repro.core import bm25 as jbm25
from repro.core import distill as jdistill
from repro.core import hybrid_index as jhi
from repro.data import synthetic as jsynthetic
from repro.kernels.flash_attention import ops as jfa
from repro.launch import train as jtrain
from repro.models import transformer as jtfm
from repro_torch import optim
from repro_torch import tree as tree_mod
from repro_torch.benchmarks import sup_distill
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import bm25
from repro_torch.core import distill
from repro_torch.core import hybrid_index as hi
from repro_torch.core import term_selector as ts
from repro_torch.distributed.fault import StragglerMonitor
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import train
from repro_torch.models import attention, layers
from repro_torch.models import transformer as tfm

torch.set_num_threads(2)

TOL = 1e-4
CFG = jtrain.SupTrainConfig(n_clusters=16, encoder_layers=2, encoder_dim=64,
                            encoder_heads=4, n_steps=0, batch_queries=8,
                            n_negatives=3, n_inbatch=4, refine_weight=0.5,
                            kmeans_iters=4, seed=0)
STEPS = 5


def _port_cfg(jcfg, **kw):
    return train.SupTrainConfig(**{**dataclasses.asdict(jcfg), **kw})


@functools.lru_cache(maxsize=1)
def _setup():
    """The corpus, the reference's initial parameters (n_steps=0), φ(D),
    the encoder config in the port's terms, and the negative pool."""
    corpus = jsynthetic.generate(seed=0, n_docs=600, n_queries=64,
                                 hidden=32, vocab_size=512, n_topics=16,
                                 make_model_b=False)
    params0, jcfg, assign, losses = jtrain.train_hi2_sup(corpus, CFG,
                                                         log_every=0)
    assert losses == []
    enc_cfg = ckpt.enc_cfg_from_fields(dataclasses.asdict(jcfg))
    pool = jsynthetic.hard_negatives(corpus, CFG.n_negatives, seed=CFG.seed)
    return dict(corpus=corpus, jparams=params0, jcfg=jcfg,
                assign=np.asarray(assign), enc_cfg=enc_cfg, pool=pool)


def _to_port(jtree, enc_cfg):
    leaves = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
              jax.tree_util.tree_flatten_with_path(jtree)[0]}
    return ckpt.distill_params_from_numpy(leaves, enc_cfg, device="cpu")


def _assert_trees_close(got, want, tol=TOL, what=""):
    """Every leaf of the port's tree within tol of the reference's, in
    the reference's leaf order (paths from index_leaves)."""
    paths = [p for p, _ in hi.index_leaves(got)]
    g_leaves = tree_mod.leaves(got)
    w_leaves = jax.tree_util.tree_leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for path, g, w in zip(paths, g_leaves, w_leaves):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=tol, atol=tol,
                                   err_msg=f"{what}{path}")


def _batch(step=0, n_inbatch=CFG.n_inbatch):
    s = _setup()
    cfg = _port_cfg(CFG, n_inbatch=n_inbatch)
    return train.sup_batches(s["corpus"], cfg, s["pool"], s["assign"])(step)


def _jbatch(batch):
    return jdistill.DistillBatch(*[
        jnp.asarray(x.numpy().astype(np.int32) if not x.is_floating_point()
                    else x.numpy()) for x in batch])


def _jloss(refine_weight=CFG.refine_weight):
    s = _setup()

    def enc(p, toks):
        return jtfm.encode(p, s["jcfg"], toks)[0]

    return lambda p, b: jdistill.loss_fn(
        p, b, encoder_apply=enc, vocab_size=s["corpus"].vocab_size,
        refine_weight=refine_weight)


def _jbatches(n_inbatch=CFG.n_inbatch):
    return lambda step: _jbatch(_batch(step, n_inbatch))


# --------------------------------------------------------------------------
# optim: schedules, AdamW, clipping
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["constant", "linear_warmup",
                                  "cosine_decay", "warmup_cosine"])
def test_schedules_match_reference(name):
    args = {"constant": (), "linear_warmup": (7,), "cosine_decay": (30, 0.1),
            "warmup_cosine": (5, 30)}[name]
    got_fn, want_fn = getattr(optim, name)(*args), getattr(joptim,
                                                            name)(*args)
    for step in range(40):
        got, want = got_fn(step), want_fn(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6, err_msg=f"step {step}")
    # an integer tensor step gives the same scale as the int
    np.testing.assert_array_equal(
        got_fn(torch.tensor(3, dtype=torch.int32)).numpy(), got_fn(3).numpy())


def _random_tree(rng):
    return {"a": rng.normal(size=(4, 5)).astype(np.float32),
            "b": {"c": rng.normal(size=(3,)).astype(np.float32),
                  "d": rng.normal(size=(2, 2)).astype(np.float32) * 1e-3}}


def _tmap(fn, tree):
    if isinstance(tree, dict):
        return {k: _tmap(fn, v) for k, v in tree.items()}
    return fn(tree)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_update_matches_reference(weight_decay):
    rng = np.random.default_rng(0)
    p_np = _random_tree(rng)
    conf = dict(lr=2e-3, weight_decay=weight_decay)
    p = _tmap(torch.from_numpy, p_np)
    jp = _tmap(jnp.asarray, p_np)
    state, jstate = optim.adam_init(p), joptim.adam_init(jp)
    assert state.step.dtype == torch.int32 and state.step.dim() == 0
    sched, jsched = optim.warmup_cosine(2, 6), joptim.warmup_cosine(2, 6)
    for step in range(4):
        g_np = _random_tree(rng)
        p, state = optim.adam_update(_tmap(torch.from_numpy, g_np), state, p,
                                     optim.AdamConfig(**conf), sched(step))
        jp, jstate = joptim.adam_update(_tmap(jnp.asarray, g_np), jstate, jp,
                                        joptim.AdamConfig(**conf),
                                        jsched(step))
    assert int(state.step) == int(jstate.step) == 4
    for got, want in ((p, jp), (state.mu, jstate.mu), (state.nu, jstate.nu)):
        for g, w in zip(tree_mod.leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-7)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    tree_np = _random_tree(np.random.default_rng(1))
    got, norm = optim.clip_by_global_norm(_tmap(torch.from_numpy, tree_np),
                                          max_norm)
    want, jnorm = joptim.clip_by_global_norm(_tmap(jnp.asarray, tree_np),
                                             max_norm)
    np.testing.assert_allclose(norm.numpy(), np.asarray(jnorm), rtol=1e-5)
    np.testing.assert_allclose(optim.global_norm(got).numpy(),
                               min(max_norm, float(jnorm)), rtol=1e-5)
    for g, w in zip(tree_mod.leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)


def test_accumulate_grads_matches_reference():
    rng = np.random.default_rng(2)
    w_np = rng.normal(size=(3,)).astype(np.float32)
    mbs = {"x": rng.normal(size=(4, 5, 3)).astype(np.float32),
           "y": rng.normal(size=(4, 5)).astype(np.float32)}

    def loss(p, mb, xp):
        return xp.mean((mb["x"] @ p["w"] - mb["y"]) ** 2)

    got_l, got_g = optim.accumulate_grads(
        lambda p, mb: loss(p, mb, torch), {"w": torch.from_numpy(w_np)},
        _tmap(torch.from_numpy, mbs))
    want_l, want_g = joptim.accumulate_grads(
        lambda p, mb: loss(p, mb, jnp), {"w": jnp.asarray(w_np)},
        _tmap(jnp.asarray, mbs))
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)
    np.testing.assert_allclose(got_g["w"].numpy(), np.asarray(want_g["w"]),
                               rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# flash_attention under autograd
# --------------------------------------------------------------------------

FLASH_GRAD_CASES = {   # b, hq, hkv, sq, sk, d, causal, window
    "encoder": (1, 2, 2, 64, 64, 16, False, 0),
    "ragged": (1, 2, 2, 37, 37, 16, False, 0),
    "causal_window": (1, 2, 2, 40, 40, 16, True, 9),
    "gqa": (1, 4, 2, 24, 24, 16, True, 0),
}


def _flash_inputs(name):
    b, hq, hkv, sq, sk, d, causal, window = FLASH_GRAD_CASES[name]
    rng = np.random.default_rng(sorted(FLASH_GRAD_CASES).index(name))
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    w = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    return q, k, v, w, causal, window


def _torch_flash_grads(fn, q, k, v, w):
    ts_ = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fn(*ts_)
    # the loss depends on the forward's output, so the gradients do too
    (torch.from_numpy(w) * out * out).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts_]


@pytest.mark.parametrize("name", sorted(FLASH_GRAD_CASES))
def test_flash_attention_gradients_match_reference_custom_vjp(name):
    """The Function's (dq, dk, dv) against ``jax.grad`` through the
    reference's ``flash_attention`` (Pallas in interpret mode forward,
    ``ref.attention`` recompute backward), and against autograd through
    the port's plain version."""
    q, k, v, w, causal, window = _flash_inputs(name)
    out, grads = _torch_flash_grads(
        lambda *a: fa_ops.flash_attention(*a, causal, window)[0], q, k, v, w)

    def jloss(q_, k_, v_):
        o = jfa.flash_attention(q_, k_, v_, causal, window, None)
        return jnp.sum(jnp.asarray(w) * o * o)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, wg, n in zip(grads, want, "qkv"):
        np.testing.assert_allclose(g, np.asarray(wg), rtol=TOL, atol=TOL,
                                   err_msg=f"d{n}")
    plain_out, plain = _torch_flash_grads(
        lambda *a: fa_ref.attention(*a, causal=causal, window=window), q, k,
        v, w)
    np.testing.assert_allclose(out, plain_out, rtol=TOL, atol=TOL)
    for g, pg, n in zip(grads, plain, "qkv"):
        np.testing.assert_allclose(g, pg, rtol=TOL, atol=TOL, err_msg=f"d{n}")


def test_flash_attention_lse_is_not_differentiable():
    q, k, v, *_ = _flash_inputs("encoder")
    ts_ = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out, lse = fa_ops.flash_attention(*ts_, False, 0)
    assert out.requires_grad and not lse.requires_grad
    with torch.no_grad():
        ref_out, ref_lse = fa_ref.flash_attention(*ts_, False, 0)
    assert torch.equal(out.detach(), ref_out) and torch.equal(lse, ref_lse)
    # a CPU call launches no kernel
    assert fa_ops.launches == 0


# --------------------------------------------------------------------------
# score vectors (Eq. 12)
# --------------------------------------------------------------------------

def test_score_vector_values_and_gradients_match_reference():
    """Repeated tokens with equal scores (the gradient splits evenly
    among tied maxima), repeated tokens with unequal scores, a PAD-only
    row and PAD tails; a loss weighting every (row, term)."""
    rng = np.random.default_rng(3)
    v = 40
    tokens = rng.integers(0, v, (5, 12)).astype(np.int32)
    tokens[0, [1, 4, 7]] = 5                    # a three-way tie
    tokens[1, [0, 2]] = 9                       # repeats, unequal scores
    tokens[2] = -1                              # PAD only
    tokens[3, 8:] = -1                          # PAD tail
    scores = rng.random((5, 12)).astype(np.float32) + 0.1
    scores[0, [1, 4, 7]] = 0.75
    weights = rng.normal(size=(5, v)).astype(np.float32)

    st = torch.from_numpy(scores).requires_grad_(True)
    got = bm25.score_vector(torch.from_numpy(tokens), st, v)
    (torch.from_numpy(weights) * got).sum().backward()
    jsv = np.asarray(jbm25.score_vector(jnp.asarray(tokens),
                                        jnp.asarray(scores), v))
    jgrad = np.asarray(jax.grad(lambda s: jnp.sum(
        jnp.asarray(weights) * jbm25.score_vector(jnp.asarray(tokens), s,
                                                  v)))(jnp.asarray(scores)))
    np.testing.assert_array_equal(got.detach().numpy(), jsv)
    np.testing.assert_allclose(st.grad.numpy(), jgrad, rtol=1e-6, atol=1e-7)
    # the tie's gradient is split three ways, PAD positions get none
    np.testing.assert_allclose(st.grad[0, [1, 4, 7]].numpy(),
                               weights[0, 5] / 3, rtol=1e-6)
    assert (st.grad.numpy()[tokens < 0] == 0).all()
    assert (got[2] == 0).all()
    np.testing.assert_array_equal(
        ts.score_vectors(torch.from_numpy(tokens), st, v).detach().numpy(),
        jsv)


# --------------------------------------------------------------------------
# the distillation loss (Eq. 9-13 + §15)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_inbatch", [0, 4])
@pytest.mark.parametrize("refine_weight", [0.0, 0.5])
def test_loss_fn_value_aux_and_gradients_match_reference(refine_weight,
                                                         n_inbatch):
    s = _setup()
    batch = _batch(1, n_inbatch)
    assert batch.doc_tokens.shape[1] == 1 + CFG.n_negatives + n_inbatch
    params = _to_port(s["jparams"], s["enc_cfg"])
    loss = train.sup_loss(s["enc_cfg"], s["corpus"].vocab_size,
                          refine_weight)
    (got, aux), grads = optim.value_and_grad(loss, params, batch,
                                             has_aux=True)
    (want, jaux), jgrads = jax.value_and_grad(
        _jloss(refine_weight), has_aux=True)(s["jparams"], _jbatch(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL, atol=TOL)
    assert set(aux) == set(jaux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    _assert_trees_close(grads, jgrads, what="grad ")
    # the encoder never reads unembed: a zero gradient, as under JAX
    assert not grads.encoder["unembed"]["w"].any()


def test_teacher_override_carries_no_gradient():
    s = _setup()
    batch = _batch(2)
    params = tree_mod.map(lambda t: t.requires_grad_(True),
                          _to_port(s["jparams"], s["enc_cfg"]))
    teacher = distill.teacher_scores(batch).requires_grad_(True)

    def enc(p, toks):
        return tfm.encode(p, s["enc_cfg"], toks)[0]

    total, aux = distill.loss_fn(params, batch, enc, s["corpus"].vocab_size,
                                 refine_weight=0.5, teacher=teacher)
    (g,) = torch.autograd.grad(total, [teacher], allow_unused=True)
    assert g is None
    base = aux["kl_cluster"] + aux["kl_term"] + aux["commit"]
    np.testing.assert_allclose(float(total.detach()),
                               float((base + 0.5 * aux["kl_refine"]).detach()),
                               rtol=1e-6)
    assert float(aux["commit"].detach()) > 0
    assert torch.equal(distill.kl(teacher, teacher).detach(),
                       torch.zeros(teacher.shape[0]))


def test_batch_stream_and_in_batch_draws_are_the_reference():
    """The port's batch stream is the reference's numpy draws: in-batch
    negatives are other rows' positives, and equal the reference's
    ``add_in_batch_negatives`` on the same generator state."""
    s = _setup()
    b = _batch(3)
    corpus = s["corpus"]
    qrels = corpus.qrels
    rows = [int(np.nonzero((corpus.query_emb == b.query_emb[i].numpy()).all(
        1))[0][0]) for i in range(b.query_emb.shape[0])]
    # column 0 is each query's own positive, φ read from the reference's
    np.testing.assert_array_equal(b.doc_tokens[:, 0].numpy(),
                                  corpus.doc_tokens[qrels[rows]])
    np.testing.assert_array_equal(b.doc_emb[:, 0].numpy(),
                                  corpus.doc_emb[qrels[rows]])
    np.testing.assert_array_equal(b.doc_assign[:, 0].numpy(),
                                  s["assign"][qrels[rows]])
    assert torch.equal(b.doc_tokens, _batch(3).doc_tokens)
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    cand = np.arange(24).reshape(8, 3)
    pos = np.arange(8) * 10
    np.testing.assert_array_equal(
        distill.add_in_batch_negatives(rng_a, cand, pos, 4),
        jdistill.add_in_batch_negatives(rng_b, cand, pos, 4))
    out = distill.add_in_batch_negatives(np.random.default_rng(0), cand,
                                         pos, 4)
    for r in range(8):
        assert set(out[r, 3:]) <= set(pos) - {pos[r]}
    with pytest.raises(ValueError, match="batch of >= 2"):
        distill.add_in_batch_negatives(np.random.default_rng(0), cand[:1],
                                       pos[:1], 2)
    cands = distill.sample_candidates(torch.Generator().manual_seed(0),
                                      torch.arange(6) * 5, 100, 4)
    assert cands.shape == (6, 5) and torch.equal(cands[:, 0],
                                                 torch.arange(6) * 5)


# --------------------------------------------------------------------------
# fit: trajectory, resume, monitor
# --------------------------------------------------------------------------

def _port_fit(params, n_steps, n_total=STEPS, **kw):
    s = _setup()
    cfg = _port_cfg(CFG, n_steps=n_total)
    return train.fit(
        train.sup_loss(s["enc_cfg"], s["corpus"].vocab_size,
                       cfg.refine_weight), params,
        train.sup_batches(s["corpus"], cfg, s["pool"], s["assign"]),
        n_steps, adam=optim.AdamConfig(lr=cfg.lr),
        schedule=optim.warmup_cosine(cfg.warmup_steps, n_total),
        log_every=0, device="cpu", **kw)


def _jax_fit(params, n_steps, n_total=STEPS, **kw):
    return jtrain.fit(_jloss(), params, _jbatches(), n_steps,
                      adam=joptim.AdamConfig(lr=CFG.lr),
                      schedule=joptim.warmup_cosine(CFG.warmup_steps,
                                                    n_total),
                      log_every=0, **kw)


@functools.lru_cache(maxsize=1)
def _reference_run():
    """The reference's own train_hi2_sup for STEPS steps (from the same
    KMeans and init as n_steps=0)."""
    s = _setup()
    cfg = dataclasses.replace(CFG, n_steps=STEPS)
    params, _, assign, losses = jtrain.train_hi2_sup(
        s["corpus"], cfg, log_every=0, negatives=s["pool"])
    np.testing.assert_array_equal(np.asarray(assign), s["assign"])
    return params, losses


def test_fit_trajectory_matches_reference_train_hi2_sup():
    s = _setup()
    params, losses = _port_fit(_to_port(s["jparams"], s["enc_cfg"]), STEPS)
    jparams, jlosses = _reference_run()
    assert len(losses) == len(jlosses) == STEPS
    np.testing.assert_allclose(losses, jlosses, rtol=TOL, atol=TOL)
    _assert_trees_close(params, jparams, what="params ")


@pytest.mark.parametrize("problem", ["quadratic", "sup"])
def test_fit_resume_is_bit_identical(tmp_path, problem):
    """Stopped at step 2 and resumed from the checkpoint, the port's fit
    lands on exactly the straight run's parameters (resume restores the
    params AND the optimizer state; the step-keyed stream replays)."""
    if problem == "quadratic":
        params = {"w": torch.zeros(4), "b": torch.ones(2)}

        def loss_fn(p, batch):
            target, scale = batch
            loss = torch.sum((p["w"] - target) ** 2) + scale * torch.sum(
                p["b"] ** 2)
            return loss, {"loss": loss}

        def batches(i):
            rng = np.random.default_rng(i)
            return (rng.normal(size=4).astype(np.float32),
                    1.0 + 0.1 * (i % 3))

        def run(n, **kw):
            return train.fit(loss_fn, params, batches, n, log_every=0,
                             device="cpu", **kw)
        n_total = 6
    else:
        s = _setup()
        params = _to_port(s["jparams"], s["enc_cfg"])
        n_total = 4

        def run(n, **kw):
            return _port_fit(params, n, n_total, **kw)
    straight, _ = run(n_total)
    ckpt_dir = str(tmp_path / "ckpt")
    run(2, ckpt_dir=ckpt_dir, save_every=2)                 # "killed" at 2
    resumed, losses = run(n_total, ckpt_dir=ckpt_dir, save_every=2)
    assert len(losses) == n_total - 2
    for a, b in zip(tree_mod.leaves(straight), tree_mod.leaves(resumed)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_fit_checkpoint_resumes_across_packages(tmp_path, direction):
    """A fit checkpoint ({"params", "opt"}, step 2) written by one
    package resumes in the other, which runs on to step 5 and lands
    within tolerance of the reference's straight 5-step run."""
    s = _setup()
    ckpt_dir = str(tmp_path / "ckpt")
    if direction == "jax_to_port":
        _jax_fit(s["jparams"], 2, ckpt_dir=ckpt_dir, save_every=2)
        params, losses = _port_fit(_to_port(s["jparams"], s["enc_cfg"]),
                                   STEPS, ckpt_dir=ckpt_dir, save_every=2)
    else:
        _port_fit(_to_port(s["jparams"], s["enc_cfg"]), 2,
                  ckpt_dir=ckpt_dir, save_every=2)
        params, losses = _jax_fit(s["jparams"], STEPS, ckpt_dir=ckpt_dir,
                                  save_every=2)
        params = _to_port(params, s["enc_cfg"])
    assert len(losses) == STEPS - 2
    jparams, jlosses = _reference_run()
    np.testing.assert_allclose(losses, jlosses[2:], rtol=TOL, atol=TOL)
    _assert_trees_close(params, jparams, what=f"{direction} ")
    # the step-2 checkpoint holds the reference's leaves, in its order
    state = optim.adam_init(_to_port(s["jparams"], s["enc_cfg"]))
    manifest = ckpt.load_manifest(f"{ckpt_dir}/step_00000002")
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(
                {"params": s["jparams"],
                 "opt": joptim.adam_init(s["jparams"])})[0]]
    assert [leaf["path"] for leaf in manifest["leaves"]] == want
    assert [p for p, _ in hi.index_leaves(
        {"params": _to_port(s["jparams"], s["enc_cfg"]),
         "opt": state})] == want


def test_straggler_monitor_does_not_perturb_training():
    s = _setup()
    params = _to_port(s["jparams"], s["enc_cfg"])
    p_none, l_none = _port_fit(params, 3)
    monitor = StragglerMonitor(window=4, factor=1.0, max_strikes=1)
    p_mon, l_mon = _port_fit(params, 3, monitor=monitor)
    assert l_none == l_mon and len(monitor.durations) == 3
    for a, b in zip(tree_mod.leaves(p_none), tree_mod.leaves(p_mon)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# negative mining, init, the port's own training
# --------------------------------------------------------------------------

def test_mine_hard_negatives_on_a_reference_index(tmp_path):
    """The port mines from a JAX-built index loaded with load_index: the
    same negatives wherever the two searches return the same ids."""
    corpus = _setup()["corpus"]
    index = jhi.build(jax.random.key(0), jnp.asarray(corpus.doc_emb),
                      jnp.asarray(corpus.doc_tokens), corpus.vocab_size,
                      n_clusters=16, k1_terms=6, pq_m=4, pq_k=32,
                      kmeans_iters=4)
    path = jckpt.save_index(str(tmp_path), 0, index)
    tindex = ckpt.load_index(path, device="cpu")
    args = (corpus.query_emb, corpus.query_tokens, corpus.qrels, 6)
    got = distill.mine_hard_negatives(tindex, *args)
    want = jdistill.mine_hard_negatives(index, *args)
    assert got.shape == want.shape == (corpus.query_emb.shape[0], 6)
    assert got.dtype == np.int32
    assert got.min() >= 0 and got.max() < corpus.doc_emb.shape[0]
    assert not (got == corpus.qrels[:, None]).any()
    ids = hi.search(tindex, corpus.query_emb, corpus.query_tokens, kc=6,
                    k2=8, top_r=14, device="cpu").doc_ids.numpy()
    jids = np.asarray(jhi.search(index, jnp.asarray(corpus.query_emb),
                                 jnp.asarray(corpus.query_tokens), kc=6,
                                 k2=8, top_r=14).doc_ids)
    same = (ids == jids).all(axis=1)
    assert same.mean() >= 0.9, same.mean()
    np.testing.assert_array_equal(got[same], want[same])
    np.testing.assert_array_equal(
        got, distill.mine_hard_negatives(tindex, *args))


def _std(t):
    return float(t.float().std())


def test_init_shapes_dtypes_and_scales():
    """tfm.init gives the reference's leaves (paths, shapes, dtypes) at
    the reference's scales; init_mlp and attention.init likewise."""
    s = _setup()
    jenc = s["jparams"].encoder
    gen = torch.Generator().manual_seed(0)
    enc = tfm.init(gen, s["enc_cfg"])
    jflat = jax.tree_util.tree_flatten_with_path(jenc)[0]
    got = hi.index_leaves(enc)
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in jflat]
    for (path, t), (_, w) in zip(got, jflat):
        assert tuple(t.shape) == w.shape and t.dtype == torch.float32, path
        if "norm" in path:
            assert (t == 1).all(), path
        else:
            np.testing.assert_allclose(_std(t), float(np.std(np.asarray(w))),
                                       rtol=0.15, err_msg=path)
    d, f = 64, 256
    np.testing.assert_allclose(_std(enc["layers"]["mlp"]["w_down"]["w"]),
                               f ** -0.5, rtol=0.05)
    np.testing.assert_allclose(_std(enc["embed"]["table"]), 0.02, rtol=0.05)
    a = attention.init(torch.Generator().manual_seed(1), d, 4, 2, 16)
    assert a["wk"]["w"].shape == (d, 32) and a["wo"]["w"].shape == (d, d)
    np.testing.assert_allclose(_std(a["wq"]["w"]), d ** -0.5, rtol=0.05)
    assert layers.rmsnorm_init(8)["scale"].tolist() == [1.0] * 8
    # one seed, one draw
    again = tfm.init(torch.Generator().manual_seed(0), s["enc_cfg"])
    assert all(torch.equal(x, y) for x, y in
               zip(tree_mod.leaves(enc), tree_mod.leaves(again)))
    # an MoE config draws the reference's moe leaves (no mlp) at its
    # scales: the router at d^-½ in f32, the experts at d^-½ and f^-½
    jmoe = jtfm.init(jax.random.key(0), dataclasses.replace(s["jcfg"],
                                                            n_experts=4))
    moe = tfm.init(gen, dataclasses.replace(s["enc_cfg"], n_experts=4))
    jflat = jax.tree_util.tree_flatten_with_path(jmoe)[0]
    assert [(p, tuple(t.shape)) for p, t in hi.index_leaves(moe)] == [
        (jax.tree_util.keystr(p), w.shape) for p, w in jflat]
    got = moe["layers"]["moe"]
    for t, scale in ((got["router"]["w"], d ** -0.5),
                     (got["w_gate"], d ** -0.5), (got["w_up"], d ** -0.5),
                     (got["w_down"], f ** -0.5)):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(_std(t), scale, rtol=0.05)


def test_init_mlp_matches_reference_distribution():
    mlp = ts.init_mlp(torch.Generator().manual_seed(0), 64)
    jmlp = _setup()["jparams"].term_mlp
    for name, t, w in zip(mlp._fields, mlp, jmlp):
        assert tuple(t.shape) == w.shape and t.dtype == torch.float32, name
    assert not mlp.b1.any() and not mlp.b2.any()
    np.testing.assert_allclose(_std(mlp.w1), 64 ** -0.5, rtol=0.05)
    np.testing.assert_allclose(_std(mlp.w2), 64 ** -0.5, rtol=0.3)
    assert torch.equal(mlp.w1, ts.init_mlp(torch.Generator().manual_seed(0),
                                           64).w1)


def test_port_train_hi2_sup_meets_the_loss_contract():
    """The port's own train_hi2_sup (its KMeans and init) on the CPU:
    contract (b) of benchmarks/sup_distill.py — the windowed loss means
    fall — and the trained parameters index through build_sup_index."""
    corpus = _setup()["corpus"]
    cfg = _port_cfg(CFG, n_steps=60, encoder_layers=1, encoder_dim=32,
                    encoder_heads=2, batch_queries=16)
    params, enc_cfg, assign, losses = train.train_hi2_sup(
        corpus, cfg, log_every=0, device="cpu")
    assert len(losses) == 60 and np.isfinite(losses).all()
    traj = sup_distill.trajectory(losses)
    assert traj["loss_last"] < traj["loss_first"], traj
    assert traj["frac_improving_windows"] >= sup_distill.MONOTONE_FRAC, traj
    assert assign.shape == (corpus.doc_emb.shape[0],)
    index = train.build_sup_index(corpus, params, enc_cfg, assign,
                                  k1_terms=6, codec="flat", device="cpu")
    assert index.n_docs == corpus.doc_emb.shape[0]

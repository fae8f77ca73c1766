"""Port parity of the LM family's decode half, dense and MoE:
``repro_torch.models.attention`` (``KVCache``, ``init_cache``,
``cache_capacity``, ``decode_step``) and ``repro_torch.models.transformer``
(``init_decode_caches``, ``serve_step``, ``prefill_step``, ``prefill``),
against the live JAX package on the CPU.

Each arch runs at its ``make_reduced()`` config (f32) on parameters the
reference's ``transformer.init`` draws, carried across by
``checkpoint.lm_params_from_numpy``; a windowed variant of llama3-8b's
(window 6) and mixtral-8x22b's own window of 8 decode past the window, so
their caches roll.  An MoE decode step routes its B = 2 tokens at
capacity ``max(int(2·2·1.25/E), 1)`` = 1, so assignments drop there as in
the reference; ``prefill`` and ``prefill_step`` agree only where nothing
drops (capacity factor E/k).  Logits within rtol = atol = 1e-4; the
caches' k and v within rtol = atol = 1e-5 (the same projections, f32 sums
in other orders); ``cache_pos`` equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import attention as jatt
from repro.models import transformer as jtfm
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.models import attention, moe, transformer as tfm

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
#: each arch, and llama3-8b's reduced config with a 6-slot window
CASES = ("llama3-8b", "internlm2-1.8b", "stablelm-3b", "llama3-8b-window6",
         "mixtral-8x22b", "olmoe-1b-7b")
MOE_CASES = ("mixtral-8x22b", "olmoe-1b-7b")
B, S = 2, 12


def _leaves(jtree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(jtree)[0]}


def _jcfg(case: str):
    """The reduced config, its window replaced where ``case`` names one."""
    arch, _, window = case.partition("-window")
    cfg = jregistry.get(arch).make_reduced()
    return dataclasses.replace(cfg, window=int(window)) if window else cfg


@functools.lru_cache(maxsize=None)
def _jparams(case: str):
    return jtfm.init(jax.random.key(1), _jcfg(case))


def _carried(case: str):
    """(reference cfg, reference params, port cfg, port params)."""
    jcfg = _jcfg(case)
    cfg = ckpt.enc_cfg_from_fields(dataclasses.asdict(jcfg))
    return jcfg, _jparams(case), cfg, ckpt.lm_params_from_numpy(
        _leaves(_jparams(case)), cfg, device="cpu")


def _tokens(case: str, s: int = S) -> np.ndarray:
    rng = np.random.default_rng(len(case))
    return rng.integers(0, _jcfg(case).vocab_size, (B, s)).astype(np.int32)


def _caches_close(got: attention.KVCache, want) -> None:
    assert got.k.shape == tuple(want.k.shape)
    assert got.k.dtype == torch.float32 and got.cache_pos.dtype == (
        torch.int32)
    np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k),
                               **CACHE_TOL)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v),
                               **CACHE_TOL)
    np.testing.assert_array_equal(got.cache_pos.numpy(),
                                  np.asarray(want.cache_pos))


def _logits_close(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", CASES)
def test_init_decode_caches_match_the_reference(case):
    jcfg, _, cfg, _ = _carried(case)
    want = jtfm.init_decode_caches(jcfg, B, S)
    got = tfm.init_decode_caches(cfg, B, S, device="cpu")
    assert got.k.shape == (cfg.n_layers, B, cfg.n_kv_heads,
                           attention.cache_capacity(S, cfg.window),
                           cfg.head_dim)
    _caches_close(got, want)
    one = attention.init_cache(B, 2, 5, 16, torch.float32)
    jone = jatt.init_cache(B, 2, 5, 16, jnp.float32)
    _caches_close(one, jone)
    for s, w in ((12, 0), (12, 6), (4, 6), (6, 6)):
        assert attention.cache_capacity(s, w) == jatt.cache_capacity(s, w)


@pytest.mark.parametrize("case", CASES)
def test_serve_step_matches_the_reference_past_the_window(case):
    """S steps of serve_step from empty caches: every step's logits and
    the caches after it (a 6-slot window rolls twice)."""
    jcfg, jparams, cfg, params = _carried(case)
    tokens = _tokens(case)
    jcaches = jtfm.init_decode_caches(jcfg, B, S)
    caches = tfm.init_decode_caches(cfg, B, S, device="cpu")
    for i in range(S):
        want, jcaches = jtfm.serve_step(jparams, jcfg, jcaches,
                                        jnp.asarray(tokens[:, i:i + 1]),
                                        jnp.int32(i))
        k_before = caches.k
        got, caches = tfm.serve_step(params, cfg, caches,
                                     torch.from_numpy(tokens[:, i:i + 1]),
                                     torch.tensor(i, dtype=torch.int32))
        assert caches.k is k_before          # consumed: updated in place
        assert got.shape == (B, 1, cfg.vocab_size)
        _logits_close(got, want)
        _caches_close(caches, jcaches)


@pytest.mark.parametrize("case", CASES)
def test_prefill_step_and_prefill_match_the_reference(case):
    jcfg, jparams, cfg, params = _carried(case)
    tokens = _tokens(case)
    want, jcaches = jtfm.prefill_step(jparams, jcfg, jnp.asarray(tokens))
    got, caches = tfm.prefill_step(params, cfg, torch.from_numpy(tokens))
    assert got.shape == (B, 1, cfg.vocab_size)
    _logits_close(got, want)
    _caches_close(caches, jcaches)
    want, jcaches = jtfm.prefill(jparams, jcfg, jnp.asarray(tokens))
    got, seq = tfm.prefill(params, cfg, torch.from_numpy(tokens))
    _logits_close(got, want)
    _caches_close(seq, jcaches)
    # the one-pass prefill and the sequential oracle leave one state (an
    # MoE layer's decode steps drop at their own capacity: see
    # test_prefill_equals_prefill_step_where_nothing_drops)
    np.testing.assert_array_equal(caches.cache_pos.numpy(),
                                  seq.cache_pos.numpy())
    if not cfg.is_moe:
        np.testing.assert_allclose(caches.k.numpy(), seq.k.numpy(),
                                   **CACHE_TOL)


@pytest.mark.parametrize("case", CASES)
def test_decode_continues_from_prefill_step_as_the_reference(case):
    """prefill_step over the first S tokens, then 5 serve_steps on its
    caches (past the capacity: slot pos % C evicts the oldest)."""
    jcfg, jparams, cfg, params = _carried(case)
    tokens = _tokens(case, S + 5)
    _, jcaches = jtfm.prefill_step(jparams, jcfg, jnp.asarray(tokens[:, :S]))
    _, caches = tfm.prefill_step(params, cfg, torch.from_numpy(tokens[:, :S]))
    for i in range(S, S + 5):
        want, jcaches = jtfm.serve_step(jparams, jcfg, jcaches,
                                        jnp.asarray(tokens[:, i:i + 1]),
                                        jnp.int32(i))
        got, caches = tfm.serve_step(params, cfg, caches,
                                     torch.from_numpy(tokens[:, i:i + 1]),
                                     i)
        _logits_close(got, want)
        _caches_close(caches, jcaches)


def test_windowed_rolling_decode_matches_logits_fn_at_each_position():
    """The reference's own oracle (``tests/test_perf_impls.py``): decode
    through a 6-slot rolling cache equals the full forward's logits at
    every position, far past the window."""
    case = "llama3-8b-window6"
    _, _, cfg, params = _carried(case)
    tokens = torch.from_numpy(_tokens(case, 30))
    full, _ = tfm.logits_fn(params, cfg, tokens)
    caches = tfm.init_decode_caches(cfg, B, 30, device="cpu")
    assert caches.k.shape[3] == 6
    for i in range(30):
        got, caches = tfm.serve_step(params, cfg, caches, tokens[:, i:i + 1],
                                     torch.tensor(i))
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, i].numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=str(i))


def test_decode_step_matches_the_reference_on_a_partly_filled_cache():
    """One layer's decode_step against the reference's on a cache with
    empty slots and a stale (future) position, bf16 cache included."""
    rng = np.random.default_rng(3)
    d, hq, hkv, dh, c = 32, 4, 2, 8, 7
    p = {k: {"w": rng.normal(size=(d, n)).astype(np.float32) * d ** -0.5}
         for k, n in (("wq", hq * dh), ("wk", hkv * dh), ("wv", hkv * dh))}
    p["wo"] = {"w": rng.normal(size=(hq * dh, d)).astype(np.float32)
               * (hq * dh) ** -0.5}
    pos_slots = np.array([0, 1, 2, -1, 9, 5, -1], np.int32)
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, TOL),
                               (torch.bfloat16, jnp.bfloat16,
                                dict(rtol=2e-2, atol=2e-2))):
        k = rng.normal(size=(B, hkv, c, dh)).astype(np.float32)
        v = rng.normal(size=(B, hkv, c, dh)).astype(np.float32)
        x = rng.normal(size=(B, 1, d)).astype(np.float32)
        jc = jatt.KVCache(jnp.asarray(k, jdtype), jnp.asarray(v, jdtype),
                          jnp.asarray(pos_slots))
        tc = attention.KVCache(torch.from_numpy(k).to(dtype),
                               torch.from_numpy(v).to(dtype),
                               torch.from_numpy(pos_slots.copy()))
        kw = dict(n_heads=hq, n_kv_heads=hkv, d_head=dh, window=4)
        want, jc = jatt.decode_step(jax.tree.map(jnp.asarray, p), jc,
                                    jnp.asarray(x, jdtype), jnp.int32(6),
                                    **kw)
        got, tc = attention.decode_step(
            {k_: {"w": torch.from_numpy(a["w"])} for k_, a in p.items()},
            tc, torch.from_numpy(x).to(dtype), torch.tensor(6), **kw)
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   **tol)
        np.testing.assert_array_equal(tc.cache_pos.numpy(),
                                      np.asarray(jc.cache_pos))
        np.testing.assert_allclose(tc.k.float().numpy(),
                                   np.asarray(jc.k.astype(jnp.float32)),
                                   **tol)


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_decode_drops_at_its_step_capacity_as_the_reference(case):
    """A serve_step routes its B tokens at capacity 1 an expert: every
    layer's routes equal the reference's steps on the same hidden rows,
    and some assignment drops over the S steps."""
    jcfg, jparams, cfg, params = _carried(case)
    tokens = _tokens(case)
    caches = tfm.init_decode_caches(cfg, B, S, device="cpu")
    dropped = 0
    with moe.record_routes() as routes:
        for i in range(S):
            _, caches = tfm.serve_step(params, cfg, caches,
                                       torch.from_numpy(tokens[:, i:i + 1]),
                                       i)
    assert len(routes) == S * cfg.n_layers
    for r in routes:
        assert r.expert.shape == (B, cfg.moe_top_k)
        assert bool((r.kept == (r.position < 1)).all())
        dropped += int((~r.kept).sum())
    assert dropped > 0


@pytest.mark.parametrize("case", MOE_CASES)
def test_prefill_equals_prefill_step_where_nothing_drops(case):
    """At capacity factor E/k each expert holds every token of a call, so
    the sequential prefill (B tokens a step) and the one-pass
    prefill_step route alike: logits within 1e-4, caches within 1e-5,
    each as the reference's at that factor."""
    jcfg, jparams, cfg, params = _carried(case)
    cf = cfg.n_experts / cfg.moe_top_k
    jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    cfg = dataclasses.replace(cfg, capacity_factor=cf)
    tokens = _tokens(case)
    one, caches = tfm.prefill_step(params, cfg, torch.from_numpy(tokens))
    seq, seq_caches = tfm.prefill(params, cfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(one.numpy(), seq.numpy(), **TOL)
    np.testing.assert_allclose(caches.k.numpy(), seq_caches.k.numpy(),
                               **CACHE_TOL)
    np.testing.assert_array_equal(caches.cache_pos.numpy(),
                                  seq_caches.cache_pos.numpy())
    want, jcaches = jtfm.prefill(jparams, jcfg, jnp.asarray(tokens))
    _logits_close(seq, want)
    _caches_close(seq_caches, jcaches)

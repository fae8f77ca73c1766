"""Port parity of the encoder stack: ``repro_torch.models`` (layers,
attention, transformer encode) against ``repro.models`` on the same
seeded numpy parameters and inputs, on the CPU (where attention takes
the flash kernel's plain version).  The reference's attention runs both
of its routes: the chunked XLA path (``use_flash=False``) and the Pallas
kernel in interpret mode (``use_flash=True``).

Tolerance: rtol=atol=1e-4 (f32 throughout; the two frameworks sum the
matmuls in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_8b
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.models import attention, layers, transformer

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def test_layers_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    w = rng.normal(size=(16, 12)).astype(np.float32)
    table = rng.normal(size=(10, 16)).astype(np.float32)
    ids = np.array([[0, 3, -1, 9], [-1, -1, 2, 5]], np.int32)
    scale = rng.normal(size=16).astype(np.float32)
    tx = torch.from_numpy(x)
    _close(layers.dense({"w": torch.from_numpy(w)}, tx),
           jlayers.dense({"w": jnp.asarray(w)}, jnp.asarray(x)))
    got = layers.embedding_lookup({"table": torch.from_numpy(table)},
                                  torch.from_numpy(ids))
    want = jlayers.embedding_lookup({"table": jnp.asarray(table)},
                                    jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[0, 2].numpy(), table[0])  # PAD → row 0
    _close(layers.rmsnorm({"scale": torch.from_numpy(scale)}, tx),
           jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    _close(layers.rope_freqs(16, 500_000.0), jlayers.rope_freqs(16, 500_000.0))
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [3, 9, 27, 81, 0, 1, 2]])
    xr = rng.normal(size=(2, 3, 7, 16)).astype(np.float32)
    got = layers.apply_rope(torch.from_numpy(xr), torch.from_numpy(pos)[:, None])
    _close(got, jlayers.apply_rope(jnp.asarray(xr), jnp.asarray(pos)[:, None]))
    # the half-split convention: feature i rotates against i + d/2
    one = np.zeros((1, 1, 1, 16), np.float32)
    one[..., 0] = 1.0
    rot = layers.apply_rope(torch.from_numpy(one), torch.tensor([[[1]]]))
    assert rot[0, 0, 0, 8] != 0 and rot[0, 0, 0, 1] == 0


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

ATTN_CASES = {
    # name: (hq, hkv, d_head, causal, window, seq)
    "mha_bidirectional": (4, 4, 16, False, 0, 24),
    "gqa_causal": (4, 2, 16, True, 0, 33),
    "mqa_causal_window": (8, 1, 8, True, 8, 40),
    "bidirectional_window": (4, 2, 16, False, 5, 21),
}


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_attention_forward_matches_the_reference(name, use_flash):
    hq, hkv, dh, causal, window, s = ATTN_CASES[name]
    d_model = 32
    params = _np_tree(jattn.init(jax.random.key(len(name)), d_model, hq,
                                 hkv, dh))
    x = np.random.default_rng(len(name)).normal(size=(2, s, d_model)).astype(
        np.float32)
    kw = dict(n_heads=hq, n_kv_heads=hkv, d_head=dh, causal=causal,
              window=window, use_flash=use_flash)
    want, (wk, wv) = jattn.forward(jax.tree_util.tree_map(jnp.asarray,
                                                          params),
                                   jnp.asarray(x), return_kv=True, **kw)
    got, (gk, gv) = attention.forward(_torch_tree(params), torch.from_numpy(x),
                                      return_kv=True, **kw)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


# --------------------------------------------------------------------------
# transformer encode / hidden_states
# --------------------------------------------------------------------------

def _sup_encoder_cfg():
    """The encoder ``train_hi2_sup`` builds for SupTrainConfig's default
    depth and width (train.py:130-134), at a small vocabulary."""
    sc = jtrain.SupTrainConfig()
    return jtfm.TransformerConfig(
        n_layers=sc.encoder_layers, d_model=sc.encoder_dim,
        n_heads=sc.encoder_heads, n_kv_heads=sc.encoder_heads,
        d_ff=sc.encoder_dim * 4, vocab_size=300, causal=False,
        compute_dtype=jnp.float32, remat=False)


ENCODER_CASES = {
    "hi2_sup_encoder": lambda: _sup_encoder_cfg(),
    "llama3_8b_reduced_causal": lambda: dataclasses.replace(
        llama3_8b.make_reduced(), causal=True),
    "llama3_8b_reduced_window32": lambda: dataclasses.replace(
        llama3_8b.make_reduced(), causal=True, window=32),
}


@pytest.mark.parametrize("name", sorted(ENCODER_CASES))
def test_encode_matches_the_reference(name):
    jcfg = ENCODER_CASES[name]()
    cfg = ckpt.enc_cfg_from_fields(dataclasses.asdict(jcfg))
    assert cfg.head_dim == jcfg.head_dim and cfg.causal == jcfg.causal
    params = _np_tree(jtfm.init(jax.random.key(3), jcfg))
    rng = np.random.default_rng(len(name))
    tokens = rng.integers(0, jcfg.vocab_size, (3, 48)).astype(np.int32)
    tokens[0, 40:] = -1                  # PAD tail: attends as token 0
    tokens[2, ::7] = -1
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    want_h, want_p = jtfm.encode(jparams, jcfg, jnp.asarray(tokens))
    got_h, got_p = transformer.encode(_torch_tree(params), cfg,
                                      torch.from_numpy(tokens))
    _close(got_h, want_h)
    _close(got_p, want_p)
    want_hs, _ = jtfm.hidden_states(jparams, jcfg, jnp.asarray(tokens))
    _close(transformer.hidden_states(_torch_tree(params), cfg,
                                     torch.from_numpy(tokens)), want_hs)


def test_unported_transformer_paths_raise():
    cfg = transformer.TransformerConfig(
        n_layers=1, d_model=8, n_heads=2, n_kv_heads=2, d_ff=16,
        vocab_size=10, n_experts=4)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        transformer.hidden_states({}, cfg, torch.zeros(1, 2, dtype=torch.long))
    for fn in (transformer.logits_fn, transformer.prefill_step,
               transformer.serve_step):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            fn({}, cfg, None)

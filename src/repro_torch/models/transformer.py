"""Transformer, encoder mode (port of ``repro/models/transformer.py``:
``TransformerConfig``, ``_mlp_forward``, ``_layer_forward``,
``hidden_states`` and ``encode`` — the HI²_sup term-scorer backbone, the
paper's Eq. 7 BERT slot).

Parameters are the reference's pytree as nested dicts of tensors:
``embed.table``, ``final_norm.scale``, ``unembed.w`` and ``layers``,
whose every leaf carries a leading L axis (the reference stacks the
layers and runs them with ``lax.scan``; here a loop takes layer i's
slice).  ``remat`` is a training option and changes nothing in a
forward pass.

Not yet ported: MoE layers (``n_experts > 0``), the LM heads
``logits_fn`` / ``loss_fn`` and the decode path ``init_decode_caches`` /
``prefill_step`` / ``serve_step``; each raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import attention, layers


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None           # default d_model // n_heads
    # MoE (n_experts=0 → dense)
    n_experts: int = 0
    moe_top_k: int = 2
    capacity_factor: float = 1.25
    # attention
    causal: bool = True
    window: int = 0                        # SWA window; 0 = full attention
    rope_theta: float = 10000.0
    # numerics / structure
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    use_flash: bool = False                # routes nothing (attention.py)
    remat: bool = True
    moe_impl: str = "gspmd"

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


def _not_yet_ported(what: str):
    raise NotImplementedError(f"{what} is not yet ported to repro_torch")


def _mlp_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x W_gate) · x W_up) W_down, in x's dtype."""
    w_gate = p["w_gate"]["w"].to(x.dtype)
    w_up = p["w_up"]["w"].to(x.dtype)
    w_down = p["w_down"]["w"].to(x.dtype)
    h = torch.nn.functional.silu(torch.matmul(x, w_gate).float())
    h = (h * torch.matmul(x, w_up).float()).to(x.dtype)
    return torch.matmul(h, w_down).to(x.dtype)


def _layer_forward(lp: dict, cfg: TransformerConfig, x: torch.Tensor
                   ) -> torch.Tensor:
    """One pre-norm block: x + attn(norm(x)), then + mlp(norm(·))."""
    if cfg.is_moe:
        _not_yet_ported("the MoE layer (n_experts > 0)")
    h = layers.rmsnorm(lp["attn_norm"], x)
    h = attention.forward(
        lp["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim, causal=cfg.causal, window=cfg.window,
        rope_theta=cfg.rope_theta, use_flash=cfg.use_flash)
    x = x + h
    h = layers.rmsnorm(lp["mlp_norm"], x)
    return x + _mlp_forward(lp["mlp"], h)


def _layer(stacked, i: int):
    """Layer i's parameters: index i of every stacked leaf."""
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def hidden_states(params: dict, cfg: TransformerConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) token ids → (B, S, D) final hidden states in
    ``cfg.compute_dtype``.  No key-padding mask: as in the reference,
    PAD positions (id -1, read as row 0) attend and are attended to."""
    if cfg.is_moe:
        _not_yet_ported("the MoE layer (n_experts > 0)")
    x = layers.embedding_lookup(params["embed"], tokens).to(
        cfg.compute_dtype)
    for i in range(cfg.n_layers):
        x = _layer_forward(_layer(params["layers"], i), cfg, x)
    return layers.rmsnorm(params["final_norm"], x)


def encode(params: dict, cfg: TransformerConfig, tokens: torch.Tensor,
           pad_id: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """Encoder mode: (hidden (B, S, D), pooled (B, D)), the pooled
    embedding being the mean over non-PAD positions."""
    hidden = hidden_states(params, cfg, tokens)
    mask = (tokens != pad_id)[..., None].to(hidden.dtype)
    pooled = (hidden * mask).sum(dim=1) / torch.clamp(mask.sum(dim=1),
                                                      min=1.0)
    return hidden, pooled


def logits_fn(*args, **kwargs):
    _not_yet_ported("transformer.logits_fn (the LM head)")


def loss_fn(*args, **kwargs):
    _not_yet_ported("transformer.loss_fn (the LM loss)")


def init_decode_caches(*args, **kwargs):
    _not_yet_ported("transformer.init_decode_caches (decode)")


def prefill_step(*args, **kwargs):
    _not_yet_ported("transformer.prefill_step (decode)")


def serve_step(*args, **kwargs):
    _not_yet_ported("transformer.serve_step (decode)")

"""Transformer: dense and MoE decoder LMs (GQA, RoPE, sliding windows)
and the bidirectional encoder mode (port of ``repro/models/transformer.py``:
``TransformerConfig`` with ``n_params`` / ``n_active_params``,
``_init_layer``, ``init``, ``_mlp_forward``, ``_layer_forward``,
``hidden_states``, ``logits_fn``, ``loss_fn``, ``encode``,
``init_decode_caches``, ``serve_step``, ``prefill_step`` and
``prefill``).

Parameters are the reference's pytree as nested dicts of tensors:
``embed.table``, ``final_norm.scale``, ``unembed.w`` and ``layers``,
whose every leaf carries a leading L axis (the reference stacks the
layers and runs them with ``lax.scan``; here a loop takes layer i's
slice).  Under ``cfg.remat`` and autograd each layer runs inside
``torch.utils.checkpoint`` (non-reentrant), as the reference's
per-layer ``jax.checkpoint``: the forward values are the same and the
backward recomputes the layer, its ``flash_attention`` launch included.
``encode`` carries gradients (HI²_sup distillation trains through it).

Products whose result the reference asks in f32
(``preferred_element_type=jnp.float32`` then no cast: the SwiGLU's gate
and up products, the logits, decode's scores) go through
:func:`repro_torch.models.layers.matmul_f32`, so at bf16 they are never
rounded to bf16.

An MoE config (``n_experts > 0``) has a ``moe`` subtree in each layer
where a dense one has ``mlp`` (:mod:`repro_torch.models.moe`).  The
training forward picks ``moe.forward`` or ``moe.forward_shard_map`` by
``cfg.moe_impl``, the latter on the ``mesh`` its caller passes (the
reference reads an ambient mesh); ``hidden_states`` sums the layers' aux
losses in f32 and ``loss_fn`` adds ``aux_weight`` times the sum.  Decode
and prefill call ``moe.forward`` whatever ``moe_impl`` is, as the
reference does: a decode step routes its B tokens with capacity
``max(int(B·k·cf/E), 1)``, so assignments drop there.

Decode: ``serve_step`` consumes its caches (updates them in place, as
the reference's decode cell donates them), ``prefill_step`` is one
full-sequence forward that also fills the caches in the rolling layout,
and ``prefill`` is the sequential oracle through ``serve_step``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from torch.utils.checkpoint import checkpoint

from repro_torch import device as dev_mod
from repro_torch import tree
from repro_torch.distributed import collectives
from repro_torch.models import attention, layers, moe


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

    def _count(self, experts: int) -> int:
        """Parameters with ``experts`` SwiGLU MLPs a layer (and, under
        MoE, the router)."""
        d, f = self.d_model, self.d_ff
        attn = (d * self.n_heads * self.head_dim * 2
                + d * self.n_kv_heads * self.head_dim * 2)
        mlp = experts * 3 * d * f + (d * self.n_experts if self.is_moe
                                     else 0)
        return (self.vocab_size * d * 2
                + self.n_layers * (attn + mlp + 2 * d) + d)

    def n_params(self) -> int:
        """Total parameter count (embeddings + layers + unembed)."""
        return self._count(self.n_experts if self.is_moe else 1)

    def n_active_params(self) -> int:
        """Activated parameters per token (MoE: only the routed experts)."""
        return self._count(self.moe_top_k if self.is_moe else 1)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_layer(generator: torch.Generator, cfg: TransformerConfig) -> dict:
    """One layer's parameters: the norms at 1, attention at
    ``dense_init``'s scale, then the SwiGLU weights at d_model^-½ (gate,
    up) and d_ff^-½ (down) — or, under MoE, the ``moe`` subtree
    (:func:`repro_torch.models.moe.init`) — drawn in that order."""
    dev = generator.device
    p = {
        "attn_norm": layers.rmsnorm_init(cfg.d_model, cfg.param_dtype, dev),
        "attn": attention.init(generator, cfg.d_model, cfg.n_heads,
                               cfg.n_kv_heads, cfg.head_dim,
                               cfg.param_dtype),
        "mlp_norm": layers.rmsnorm_init(cfg.d_model, cfg.param_dtype, dev),
    }
    if cfg.is_moe:
        p["moe"] = moe.init(generator, cfg.d_model, cfg.d_ff, cfg.n_experts,
                            cfg.param_dtype)
        return p
    s_in, s_out = cfg.d_model ** -0.5, cfg.d_ff ** -0.5
    p["mlp"] = {
        "w_gate": layers.dense_init(generator, cfg.d_model, cfg.d_ff,
                                    cfg.param_dtype, s_in),
        "w_up": layers.dense_init(generator, cfg.d_model, cfg.d_ff,
                                  cfg.param_dtype, s_in),
        "w_down": layers.dense_init(generator, cfg.d_ff, cfg.d_model,
                                    cfg.param_dtype, s_out),
    }
    return p


def init(generator: torch.Generator, cfg: TransformerConfig) -> dict:
    """The reference's parameter tree on ``generator``'s device: the
    embedding, the layers stacked on a leading L axis, the final norm
    and the (encoder-unused) unembedding."""
    embed = layers.embedding_init(generator, cfg.vocab_size, cfg.d_model,
                                  cfg.param_dtype)
    # each layer is drawn, then copied into its slot of the stacked
    # leaves and freed: the layers and a stacked copy of them at once
    # would take twice the weights' memory
    stacked = None
    for i in range(cfg.n_layers):
        layer = _init_layer(generator, cfg)
        if stacked is None:
            stacked = tree.map(lambda t: t.new_empty(
                (cfg.n_layers,) + tuple(t.shape)), layer)
        tree.map(lambda dst, src: dst[i].copy_(src), stacked, layer)
        del layer
    return {
        "embed": embed,
        "layers": stacked,
        "final_norm": layers.rmsnorm_init(cfg.d_model, cfg.param_dtype,
                                          generator.device),
        "unembed": layers.dense_init(generator, cfg.d_model, cfg.vocab_size,
                                     cfg.param_dtype),
    }


# --------------------------------------------------------------------------
# forward (train / prefill / encode)
# --------------------------------------------------------------------------

def _embed(params: dict, cfg: TransformerConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    """Token rows (PAD, any negative id, reads row 0) in the compute
    dtype."""
    return layers.embedding_lookup(params["embed"], tokens).to(
        cfg.compute_dtype)


def _mlp_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU, (silu(x W_gate) · x W_up) W_down: the gate and up products
    stay f32 through silu and the product, which is rounded once to x's
    dtype, as the reference's (``preferred_element_type=jnp.float32``)."""
    w_gate = p["w_gate"]["w"].to(x.dtype)
    w_up = p["w_up"]["w"].to(x.dtype)
    w_down = p["w_down"]["w"].to(x.dtype)
    h = torch.nn.functional.silu(layers.matmul_f32(x, w_gate))
    h = (h * layers.matmul_f32(x, w_up)).to(x.dtype)
    return torch.matmul(h, w_down).to(x.dtype)


def _ffn(lp: dict, cfg: TransformerConfig, x: torch.Tensor,
         moe_fn=moe.forward, **kw) -> tuple[torch.Tensor, torch.Tensor]:
    """A block's second half, x + ffn(norm(x)), and its MoE aux loss
    (a 0-dim f32 zero for a dense config)."""
    h = layers.rmsnorm(lp["mlp_norm"], x)
    if not cfg.is_moe:
        return x + _mlp_forward(lp["mlp"], h), torch.zeros(
            (), dtype=torch.float32, device=x.device)
    h, stats = moe_fn(lp["moe"], h, n_experts=cfg.n_experts,
                      top_k=cfg.moe_top_k,
                      capacity_factor=cfg.capacity_factor, **kw)
    return x + h, stats.aux_loss


def _attention(lp: dict, cfg: TransformerConfig, x: torch.Tensor,
               return_kv: bool = False):
    """A block's full-sequence attention on norm(x)."""
    return attention.forward(
        lp["attn"], layers.rmsnorm(lp["attn_norm"], x),
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_head=cfg.head_dim,
        causal=cfg.causal, window=cfg.window, rope_theta=cfg.rope_theta,
        use_flash=cfg.use_flash, return_kv=return_kv)


def _layer_forward(lp: dict, cfg: TransformerConfig, x: torch.Tensor,
                   mesh: Optional[collectives.Mesh] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """One pre-norm block: x + attn(norm(x)), then + ffn(norm(·)) →
    (x, aux).  The MoE layer is ``moe.forward_shard_map`` on ``mesh``
    when ``cfg.moe_impl`` is ``"shard_map"``, else ``moe.forward``."""
    x = x + _attention(lp, cfg, x)
    if cfg.is_moe and cfg.moe_impl == "shard_map":
        return _ffn(lp, cfg, x, moe.forward_shard_map, mesh=mesh)
    return _ffn(lp, cfg, x)


def hidden_states(params: dict, cfg: TransformerConfig,
                  tokens: torch.Tensor,
                  mesh: Optional[collectives.Mesh] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S) token ids → ((B, S, D) final hidden states in
    ``cfg.compute_dtype``, the layers' MoE aux losses summed in f32).
    No key-padding mask: as in the reference, PAD positions (id -1, read
    as row 0) attend and are attended to.  Under ``cfg.remat`` and
    autograd each layer is checkpointed."""
    x = _embed(params, cfg, tokens)
    remat = cfg.remat and torch.is_grad_enabled()
    auxes = []
    for i in range(cfg.n_layers):
        lp = tree.index(params["layers"], i)
        if remat:
            x, aux = checkpoint(_layer_forward, lp, cfg, x, mesh,
                                use_reentrant=False)
        else:
            x, aux = _layer_forward(lp, cfg, x, mesh)
        auxes.append(aux)
    return layers.rmsnorm(params["final_norm"], x), torch.stack(auxes).sum()


def _logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (..., D) @ unembed in f32, from operands in x's dtype."""
    return layers.matmul_f32(x, params["unembed"]["w"].to(x.dtype))


def logits_fn(params: dict, cfg: TransformerConfig, tokens: torch.Tensor,
              mesh: Optional[collectives.Mesh] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S) → (logits (B, S, V) f32, the MoE aux loss: 0-dim f32, zero
    for a dense config)."""
    x, aux = hidden_states(params, cfg, tokens, mesh)
    return _logits(params, x), aux


def loss_fn(params: dict, cfg: TransformerConfig, tokens: torch.Tensor,
            labels: torch.Tensor, aux_weight: float = 0.01,
            mesh: Optional[collectives.Mesh] = None
            ) -> tuple[torch.Tensor, dict]:
    """Mean next-token cross entropy (labels -1 skipped) plus
    ``aux_weight`` times the MoE aux loss → (loss, {"loss", "xent",
    "moe_aux"})."""
    logits, aux = logits_fn(params, cfg, tokens, mesh)
    xent = layers.softmax_xent(logits, labels)
    loss = xent + aux_weight * aux
    return loss, {"loss": loss, "xent": xent, "moe_aux": aux}


def cell_loss(params: dict, cfg: TransformerConfig, batch: dict
              ) -> tuple[torch.Tensor, dict]:
    """The LM training cell's loss over a batch ``{"tokens", "labels"}``
    (the reference's ``launch/cells.py::_lm_train_cell``), the
    ``loss(params, cfg, batch)`` that
    :func:`repro_torch.launch.train.cell_step` steps."""
    return loss_fn(params, cfg, batch["tokens"], batch["labels"])


def encode(params: dict, cfg: TransformerConfig, tokens: torch.Tensor,
           pad_id: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """Encoder mode: (hidden (B, S, D), pooled (B, D)), the pooled
    embedding being the mean over non-PAD positions."""
    hidden, _ = hidden_states(params, cfg, tokens)
    mask = (tokens != pad_id)[..., None].to(hidden.dtype)
    pooled = (hidden * mask).sum(dim=1) / torch.clamp(mask.sum(dim=1),
                                                      min=1.0)
    return hidden, pooled


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def init_decode_caches(cfg: TransformerConfig, batch: int, seq_len: int,
                       device: dev_mod.DeviceLike = "cuda"
                       ) -> attention.KVCache:
    """Empty caches for every layer, stacked on a leading L axis: k and v
    (L, B, n_kv_heads, C, d_head) in the compute dtype, ``cache_pos``
    (L, C) at -1, C = ``cache_capacity(seq_len, cfg.window)``."""
    dev = dev_mod.resolve(device)
    capacity = attention.cache_capacity(seq_len, cfg.window)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, capacity, cfg.head_dim)
    return attention.KVCache(
        k=torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
        v=torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
        cache_pos=torch.full((cfg.n_layers, capacity), -1,
                             dtype=torch.int32, device=dev))


def _layer_cache(caches: attention.KVCache, i: int) -> attention.KVCache:
    return attention.KVCache(caches.k[i], caches.v[i], caches.cache_pos[i])


@torch.no_grad()
def serve_step(params: dict, cfg: TransformerConfig,
               caches: attention.KVCache, tokens_new: torch.Tensor, pos
               ) -> tuple[torch.Tensor, attention.KVCache]:
    """One token for the whole batch against the KV caches: tokens_new
    (B, 1), ``pos`` the absolute position (a 0-dim tensor, or an int)
    → (logits (B, 1, V) f32, caches).  The caches are consumed: each
    layer's slot ``pos % C`` is written in place and the returned caches
    are the same tensors.  Nothing is read back to the host.  An MoE
    layer routes the B tokens of the step (``moe.forward``)."""
    x = _embed(params, cfg, tokens_new)
    pos = torch.as_tensor(pos, device=x.device)
    for i in range(cfg.n_layers):
        lp = tree.index(params["layers"], i)
        h, _ = attention.decode_step(
            lp["attn"], _layer_cache(caches, i),
            layers.rmsnorm(lp["attn_norm"], x), pos, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, d_head=cfg.head_dim,
            window=cfg.window, rope_theta=cfg.rope_theta)
        x, _ = _ffn(lp, cfg, x + h)
    x = layers.rmsnorm(params["final_norm"], x)
    return _logits(params, x), caches


@torch.no_grad()
def prefill_step(params: dict, cfg: TransformerConfig, tokens: torch.Tensor
                 ) -> tuple[torch.Tensor, attention.KVCache]:
    """Production prefill: one full-sequence forward (B, S) on tokens'
    device → (last-token logits (B, 1, V) f32, the stacked caches).  The
    caches hold the last C = ``cache_capacity(S, window)`` positions in
    the rolling layout, position p in slot p mod C, so that continued
    decode (slot = pos mod C) evicts the oldest position, never a live
    one.  An MoE layer routes all B·S tokens at once (``moe.forward``)."""
    b, s = tokens.shape
    capacity = attention.cache_capacity(s, cfg.window)
    p0 = s - capacity
    shift = p0 % capacity if capacity else 0
    shape = (cfg.n_layers, b, cfg.n_kv_heads, capacity, cfg.head_dim)
    ks = torch.empty(shape, dtype=cfg.compute_dtype, device=tokens.device)
    vs = torch.empty_like(ks)
    x = _embed(params, cfg, tokens)
    for i in range(cfg.n_layers):
        lp = tree.index(params["layers"], i)
        h, (k, v) = _attention(lp, cfg, x, return_kv=True)
        ks[i] = torch.roll(k[..., -capacity:, :], shift, dims=-2)
        vs[i] = torch.roll(v[..., -capacity:, :], shift, dims=-2)
        x, _ = _ffn(lp, cfg, x + h)
    x = layers.rmsnorm(params["final_norm"], x[:, -1:])
    cache_pos = torch.roll(torch.arange(p0, s, dtype=torch.int32,
                                        device=tokens.device), shift)
    return _logits(params, x), attention.KVCache(
        k=ks, v=vs,
        cache_pos=cache_pos.expand(cfg.n_layers, capacity).contiguous())


def prefill(params: dict, cfg: TransformerConfig, tokens: torch.Tensor
            ) -> tuple[torch.Tensor, attention.KVCache]:
    """Sequential prefill through :func:`serve_step`, one position at a
    time (the oracle tests hold :func:`prefill_step` against)."""
    b, s = tokens.shape
    caches = init_decode_caches(cfg, b, s, device=tokens.device)
    logits = None
    for i in range(s):
        logits, caches = serve_step(
            params, cfg, caches, tokens[:, i:i + 1],
            torch.tensor(i, dtype=torch.int32, device=tokens.device))
    return logits, caches

"""RecSys architecture family: DLRM, SASRec, DIEN, MIND — training,
serving and retrieval (port of ``repro/models/recsys.py``, whole:
``PAD_ID``, ``embedding_bag``, ``embedding_bag_ragged``, ``_mlp_init``,
``_mlp``, ``bce_loss``, the four families' configs, batches, ``*_init``,
``*_loss``, their serve functions and the ``*_retrieval`` functions).

Parameters are nested dicts of tensors in the reference's layout, so a
reference parameter tree maps onto them leaf for leaf
(:func:`repro_torch.checkpoint.checkpoint.recsys_params_from_numpy`):
DLRM's tables are one (F, R, D) tensor, SASRec's blocks are stacked on a
leading ``n_blocks`` axis (the reference's ``vmap(block_init)``), MLPs
are lists of ``{"w", "b"}``.  The ``*_init`` functions draw from an
explicit ``torch.Generator`` on the device where the parameters are made
(``jax.random``'s distributions, not its numbers).

SASRec's attention is :func:`repro_torch.models.attention.forward`, so on
the card every block is one ``flash_attention`` launch, at the published
head dim 50 (the kernel's ragged path in its d = 64 instance).  The
reference's two ``lax.scan``s of DIEN are loops over the sequence (the
interest states stacked, so autograd holds one node for them, not one
in-place copy a step).  Row lookups go through
:func:`repro_torch.models.layers.take_rows`, so a table's gradient sums
its rows in row order, the same bits on every run.

Each ``*_loss`` returns ``(loss, {"loss": loss})``, as the reference's.
Where the reference's max has a tie, its gradient splits evenly among
the tied entries (``jnp.maximum``, ``jnp.max``): so does the port's
(``torch.maximum`` and ``torch.amax``; ``clamp``, ``relu`` and
``max(dim).values`` would give it all to one side); ``bce_loss``'s |x|
has JAX's slope 1 at 0.  :data:`LOSSES` and
:data:`INITS` name each arch's pair, as the reference's
``launch/cells.py`` does for its ``recsys/train`` cells.

Every ``*_retrieval`` returns ``(scores, positions)`` of its top ``r``
under the total order (score desc, position asc), as ``jax.lax.top_k``
orders ties (``torch.topk`` has no tie order): for SASRec and MIND the
positions are item ids, for DLRM and DIEN positions in ``candidates``.
The (1, R) candidate products stay ``torch.matmul``: the reference
computes them outside any Pallas kernel.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.core.exec.stages import topk_by_score
from repro_torch.core.kmeans import segment_sum
from repro_torch.models import attention, layers

PAD_ID = -1
#: masked attention logits of DIEN (the reference's finite -1e30)
NEG_INF = -1e30


# --------------------------------------------------------------------------
# EmbeddingBag
# --------------------------------------------------------------------------

def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  mode: str = "sum") -> torch.Tensor:
    """Padded-bag lookup: table (R, D), ids (..., bag) with PAD_ID pads
    → (..., D), the masked sum (or mean) over the bag axis."""
    mask = (ids != PAD_ID)[..., None]
    emb = layers.take_rows(table, ids.clamp(min=0)) * mask
    out = emb.sum(dim=-2)
    if mode == "mean":
        out = out / mask.sum(dim=-2).clamp(min=1)
    return out


def embedding_bag_ragged(table: torch.Tensor, flat_ids: torch.Tensor,
                         offsets: torch.Tensor, n_bags: int
                         ) -> torch.Tensor:
    """Ragged-offset variant (torch-style CSR ``offsets``, the start of
    each bag in ``flat_ids``) → (n_bags, D).  Each bag's rows add in row
    order on every device (:func:`repro_torch.core.kmeans.segment_sum`;
    CUDA's ``index_add_`` adds with atomics); ids before ``offsets[0]``
    belong to no bag and are dropped, as ``segment_sum`` drops them."""
    n = flat_ids.shape[0]
    seg = torch.searchsorted(offsets.long(), torch.arange(
        n, device=flat_ids.device), right=True) - 1
    emb = layers.take_rows(table, flat_ids.clamp(min=0))
    emb = emb * (flat_ids != PAD_ID)[:, None]
    keep = (seg >= 0) & (seg < n_bags)
    return segment_sum(emb[keep], seg[keep], n_bags)[0]


def _mlp_init(generator: torch.Generator, dims: list[int]) -> list[dict]:
    return [{"w": layers.dense_init(generator, dims[i], dims[i + 1])["w"],
             "b": torch.zeros((dims[i + 1],), dtype=torch.float32,
                              device=generator.device)}
            for i in range(len(dims) - 1)]


def _mlp(params: list[dict], x: torch.Tensor,
         final_act: bool = False) -> torch.Tensor:
    for i, p in enumerate(params):
        x = torch.matmul(x, p["w"]) + p["b"]
        if i < len(params) - 1 or final_act:
            x = torch.relu(x)
    return x


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross entropy on logits, in the stable form
    max(x, 0) − x·y + log(1 + e^−|x|).  At x = 0 the gradient is JAX's:
    the max splits it (½), and |x| has slope 1 there (JAX's ``abs``;
    ``torch.abs`` has slope 0), so |x| is written as a select."""
    logits = logits.float()
    magnitude = torch.where(logits >= 0, logits, -logits)
    return torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                      - logits * labels
                      + torch.log1p(torch.exp(-magnitude)))


def top_k(scores: torch.Tensor, r: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` of (B, N) scores: (B, r) scores and positions,
    ties to the lower position."""
    pos = torch.arange(scores.shape[-1], device=scores.device)
    return topk_by_score(scores, pos.expand(scores.shape), r)


def _normal_(generator: torch.Generator, shape, scale: float
             ) -> torch.Tensor:
    """N(0, scale²) drawn and scaled in place (one copy of a table)."""
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device).mul_(scale)


# --------------------------------------------------------------------------
# DLRM  (Naumov et al., arXiv:1906.00091 — RM2 scale)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    n_rows: int = 1_000_000          # rows per sparse table
    bot_mlp: tuple = (13, 512, 256, 64)
    top_mlp_hidden: tuple = (512, 512, 256, 1)


class DLRMBatch(NamedTuple):
    dense: torch.Tensor      # (B, n_dense) f32
    sparse: torch.Tensor     # (B, n_sparse) ids (single-hot)
    labels: torch.Tensor     # (B,) f32 clicks


def dlrm_init(generator: torch.Generator, cfg: DLRMConfig) -> dict:
    """Tables (F, R, D) from N(0, 1/D), then the bottom and top MLPs, on
    ``generator``'s device."""
    tables = _normal_(generator, (cfg.n_sparse, cfg.n_rows, cfg.embed_dim),
                      cfg.embed_dim ** -0.5)
    n_feat = cfg.n_sparse + 1
    top_in = n_feat * (n_feat - 1) // 2 + cfg.bot_mlp[-1]
    return {
        "tables": tables,
        "bot": _mlp_init(generator, list(cfg.bot_mlp)),
        "top": _mlp_init(generator, [top_in] + list(cfg.top_mlp_hidden)),
    }


def dlrm_forward(params: dict, cfg: DLRMConfig, batch: DLRMBatch
                 ) -> torch.Tensor:
    """Click logits (B,): bottom MLP, one row per sparse feature, the
    dot interaction's strict upper triangle (``triu_indices`` order),
    top MLP."""
    dense_v = _mlp(params["bot"], batch.dense, final_act=True)   # (B, D)
    tables = params["tables"]
    f, r, d = tables.shape
    # feature j's id i reads row j·R + i of the (F·R, D) view
    rows = batch.sparse.clamp(min=0).long() + torch.arange(
        f, device=tables.device) * r
    emb = layers.take_rows(tables.reshape(f * r, d), rows)       # (B, F, D)
    feats = torch.cat([dense_v[:, None], emb], dim=1)            # (B, F+1, D)
    inter = torch.bmm(feats, feats.transpose(1, 2))
    iu, ju = torch.triu_indices(f + 1, f + 1, offset=1,
                                device=tables.device)
    top_in = torch.cat([dense_v, inter[:, iu, ju]], dim=-1)
    return _mlp(params["top"], top_in)[:, 0]


def dlrm_loss(params: dict, cfg: DLRMConfig, batch: DLRMBatch
              ) -> tuple[torch.Tensor, dict]:
    loss = bce_loss(dlrm_forward(params, cfg, batch), batch.labels)
    return loss, {"loss": loss}


def dlrm_retrieval(params: dict, cfg: DLRMConfig, dense: torch.Tensor,
                   sparse_ctx: torch.Tensor, candidates: torch.Tensor,
                   top_r: int = 100) -> tuple[torch.Tensor, torch.Tensor]:
    """Score 1 user context against N candidate items: the candidate id
    fills the last sparse slot; everything else broadcasts.  → (1, r)
    scores and positions in ``candidates``."""
    n = candidates.shape[0]
    sparse = torch.cat([sparse_ctx.long().reshape(1, -1).expand(
        n, cfg.n_sparse - 1), candidates.long().reshape(n, 1)], dim=-1)
    batch = DLRMBatch(dense=dense.reshape(1, -1).expand(n, cfg.n_dense),
                      sparse=sparse,
                      labels=torch.zeros((n,), device=candidates.device))
    return top_k(dlrm_forward(params, cfg, batch)[None], top_r)


# --------------------------------------------------------------------------
# SASRec  (Kang & McAuley, arXiv:1808.09781)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    n_items: int = 1_000_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50


class SASRecBatch(NamedTuple):
    items: torch.Tensor      # (B, S) behaviour sequence, PAD_ID padded
    targets: torch.Tensor    # (B, S) next-item labels
    negatives: torch.Tensor  # (B, S) sampled negatives


def sasrec_init(generator: torch.Generator, cfg: SASRecConfig) -> dict:
    """The item and position tables, ``n_blocks`` blocks stacked on a
    leading axis, and the final norm, on ``generator``'s device."""
    d, dev = cfg.embed_dim, generator.device

    def block_init():
        return {
            "attn_norm": layers.layernorm_init(d, device=dev),
            "attn": attention.init(generator, d, cfg.n_heads, cfg.n_heads,
                                   d // cfg.n_heads),
            "ff_norm": layers.layernorm_init(d, device=dev),
            "ff1": layers.dense_init(generator, d, d),
            "ff2": layers.dense_init(generator, d, d),
        }

    stacked = tree.stack([block_init() for _ in range(cfg.n_blocks)])
    return {
        "item_embed": {"table": _normal_(generator, (cfg.n_items, d), 0.02)},
        "pos_embed": layers.embedding_init(generator, cfg.seq_len, d),
        "blocks": stacked,
        "final_norm": layers.layernorm_init(d, device=dev),
    }


def sasrec_hidden(params: dict, cfg: SASRecConfig, items: torch.Tensor
                  ) -> torch.Tensor:
    """(B, S) items → (B, S, D) hidden states: scaled item rows plus
    positions, PAD rows zeroed, pre-norm causal blocks, final norm."""
    s = items.shape[1]
    x = layers.take_rows(params["item_embed"]["table"], items.clamp(min=0))
    x = x * (cfg.embed_dim ** 0.5) + params["pos_embed"]["table"][None, :s]
    x = x * (items != PAD_ID)[..., None]
    for i in range(cfg.n_blocks):
        bp = tree.index(params["blocks"], i)
        h = layers.layernorm(bp["attn_norm"], x)
        h = attention.forward(bp["attn"], h, n_heads=cfg.n_heads,
                              n_kv_heads=cfg.n_heads,
                              d_head=cfg.embed_dim // cfg.n_heads,
                              causal=True, rope_theta=0.0)
        x1 = x + h
        h = layers.layernorm(bp["ff_norm"], x1)
        h = layers.dense(bp["ff2"], torch.relu(layers.dense(bp["ff1"], h)))
        x = x1 + h
    return layers.layernorm(params["final_norm"], x)


def sasrec_loss(params: dict, cfg: SASRecConfig, batch: SASRecBatch
                ) -> tuple[torch.Tensor, dict]:
    """BPR-style binary loss with sampled negatives (the paper's
    objective), averaged over the positions whose target is not PAD."""
    h = sasrec_hidden(params, cfg, batch.items)                 # (B, S, D)
    table = params["item_embed"]["table"]
    pos_e = layers.take_rows(table, batch.targets.clamp(min=0))
    neg_e = layers.take_rows(table, batch.negatives.clamp(min=0))
    pos_s = torch.einsum("bsd,bsd->bs", h, pos_e)
    neg_s = torch.einsum("bsd,bsd->bs", h, neg_e)
    mask = batch.targets != PAD_ID
    loss = -(F.logsigmoid(pos_s) + F.logsigmoid(-neg_s))
    loss = (loss * mask).sum() / mask.sum().clamp(min=1)
    return loss, {"loss": loss}


def sasrec_user_embedding(params: dict, cfg: SASRecConfig,
                          items: torch.Tensor) -> torch.Tensor:
    """Last hidden state = the retrieval query vector, (B, D)."""
    return sasrec_hidden(params, cfg, items)[:, -1]


def sasrec_retrieval(params: dict, cfg: SASRecConfig, items: torch.Tensor,
                     top_r: int = 100) -> tuple[torch.Tensor, torch.Tensor]:
    """items: (1, S) history → (scores, ids) of the top_r of all
    n_items."""
    user = sasrec_user_embedding(params, cfg, items)            # (1, D)
    scores = torch.matmul(user, params["item_embed"]["table"].T)
    return top_k(scores, top_r)


# --------------------------------------------------------------------------
# DIEN  (Zhou et al., arXiv:1809.03672) — GRU + AUGRU interest evolution
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DIENConfig:
    n_items: int = 1_000_000
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp_hidden: tuple = (200, 80)


class DIENBatch(NamedTuple):
    history: torch.Tensor    # (B, S)
    target: torch.Tensor     # (B,)
    labels: torch.Tensor     # (B,) f32


def _gru_init(generator: torch.Generator, d_in: int, d_h: int) -> dict:
    s = (d_in + d_h) ** -0.5
    w = {k: _normal_(generator, (d_in + d_h, d_h), s)
         for k in ("wz", "wr", "wh")}
    return dict(w, **{k: torch.zeros((d_h,), device=generator.device)
                      for k in ("bz", "br", "bh")})


def _gru_cell(p: dict, h: torch.Tensor, x: torch.Tensor,
              att: Optional[torch.Tensor] = None) -> torch.Tensor:
    xh = torch.cat([x, h], dim=-1)
    z = torch.sigmoid(xh @ p["wz"] + p["bz"])
    r = torch.sigmoid(xh @ p["wr"] + p["br"])
    xrh = torch.cat([x, r * h], dim=-1)
    hh = torch.tanh(xrh @ p["wh"] + p["bh"])
    if att is not None:          # AUGRU: attention scales the update gate
        z = z * att[:, None]
    return (1 - z) * h + z * hh


def dien_init(generator: torch.Generator, cfg: DIENConfig) -> dict:
    d_in = cfg.embed_dim * 2     # item ⊕ category embedding (paper)
    top_in = cfg.gru_dim + d_in
    return {
        "item_embed": {"table": _normal_(
            generator, (cfg.n_items, cfg.embed_dim), 0.02)},
        "cat_embed": layers.embedding_init(
            generator, max(cfg.n_items // 100, 16), cfg.embed_dim),
        "gru1": _gru_init(generator, d_in, cfg.gru_dim),
        "augru": _gru_init(generator, cfg.gru_dim, cfg.gru_dim),
        "top": _mlp_init(generator, [top_in] + list(cfg.mlp_hidden) + [1]),
    }


def _dien_embed(params: dict, cfg: DIENConfig, ids: torch.Tensor
                ) -> torch.Tensor:
    cat_t = params["cat_embed"]["table"]
    ids = ids.clamp(min=0)
    return torch.cat([layers.take_rows(params["item_embed"]["table"], ids),
                      layers.take_rows(cat_t, ids % cat_t.shape[0])],
                     dim=-1)


def _interest_states(params: dict, cfg: DIENConfig, hist: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """The interest-extraction GRU over (B, S, 2d) → (B, S, H) states;
    a masked step keeps h.  The steps read ``unbind``'s views and the
    states are stacked, so under autograd each is one node: a step's
    own slice (``hist[:, t]``) would give a backward that fills and adds
    a whole (B, S, 2d) gradient a step."""
    h = torch.zeros((mask.shape[0], cfg.gru_dim), device=hist.device)
    states = []
    for x, m in zip(hist.unbind(1), mask.unbind(1)):
        h = torch.where(m[:, None] > 0, _gru_cell(params["gru1"], h, x), h)
        states.append(h)
    return torch.stack(states, dim=1)


def dien_forward(params: dict, cfg: DIENConfig, batch: DIENBatch
                 ) -> torch.Tensor:
    """Click logits (B,): GRU interests, target attention (masked with
    -1e30), AUGRU evolution, top MLP."""
    hist = _dien_embed(params, cfg, batch.history)              # (B, S, 2d)
    tgt = _dien_embed(params, cfg, batch.target[:, None])[:, 0]  # (B, 2d)
    mask = (batch.history != PAD_ID).float()
    states = _interest_states(params, cfg, hist, mask)          # (B, S, H)

    att = torch.einsum("bsd,bd->bs", states[..., :tgt.shape[-1]], tgt)
    att = torch.softmax(torch.where(mask > 0, att, NEG_INF), dim=-1)

    h = torch.zeros((mask.shape[0], cfg.gru_dim), device=hist.device)
    for x, a, m in zip(states.unbind(1), att.unbind(1), mask.unbind(1)):
        h = torch.where(m[:, None] > 0,
                        _gru_cell(params["augru"], h, x, att=a), h)
    return _mlp(params["top"], torch.cat([h, tgt], dim=-1))[:, 0]


def dien_loss(params: dict, cfg: DIENConfig, batch: DIENBatch
              ) -> tuple[torch.Tensor, dict]:
    loss = bce_loss(dien_forward(params, cfg, batch), batch.labels)
    return loss, {"loss": loss}


def dien_retrieval(params: dict, cfg: DIENConfig, history: torch.Tensor,
                   candidates: torch.Tensor, top_r: int = 100
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """DIEN is target-conditioned (AUGRU depends on the candidate), so
    retrieval re-runs the evolution layer per candidate, batched over
    the candidates; the GRU's interests are computed once.  history (1,
    S) → (1, r) scores and positions in ``candidates``."""
    n = candidates.shape[0]
    hist = _dien_embed(params, cfg, history)                    # (1, S, 2d)
    mask = (history != PAD_ID).float()
    states = _interest_states(params, cfg, hist, mask)[0]       # (S, H)

    tgt = _dien_embed(params, cfg, candidates[:, None])[:, 0]   # (N, 2d)
    att = torch.einsum("sh,nh->ns", states[:, :tgt.shape[-1]], tgt)
    att = torch.softmax(torch.where(mask[0][None] > 0, att, NEG_INF),
                        dim=-1)
    h = torch.zeros((n, cfg.gru_dim), device=candidates.device)
    for t in range(states.shape[0]):
        h = _gru_cell(params["augru"], h,
                      states[t].expand(n, -1), att=att[:, t])
    scores = _mlp(params["top"], torch.cat([h, tgt], dim=-1))[:, 0]
    return top_k(scores[None], top_r)


# --------------------------------------------------------------------------
# MIND  (Li et al., arXiv:1904.08030) — multi-interest capsule routing
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MINDConfig:
    n_items: int = 1_000_000
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    seq_len: int = 50


class MINDBatch(NamedTuple):
    history: torch.Tensor    # (B, S)
    target: torch.Tensor     # (B,) positive item
    negatives: torch.Tensor  # (B, N) sampled negatives


def mind_init(generator: torch.Generator, cfg: MINDConfig) -> dict:
    return {
        "item_embed": {"table": _normal_(
            generator, (cfg.n_items, cfg.embed_dim), 0.02)},
        "bilinear": layers.dense_init(generator, cfg.embed_dim,
                                      cfg.embed_dim),
    }


def mind_interests(params: dict, cfg: MINDConfig, history: torch.Tensor
                   ) -> torch.Tensor:
    """B2I dynamic routing → (B, n_interests, D) user interest capsules;
    routing logits start at 0 (the reference's deterministic variant)."""
    b, s = history.shape
    beh = layers.take_rows(params["item_embed"]["table"],
                           history.clamp(min=0))                 # (B, S, D)
    mask = (history != PAD_ID).float()
    beh_hat = layers.dense(params["bilinear"], beh)
    logits = torch.zeros((b, cfg.n_interests, s), device=history.device)
    caps = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(logits, dim=1) * mask[:, None, :]    # over interests
        caps = torch.einsum("bks,bsd->bkd", w, beh_hat)
        norm2 = torch.sum(caps * caps, dim=-1, keepdim=True)
        caps = caps * (norm2 / (1 + norm2)) / torch.sqrt(norm2 + 1e-9)
        logits = logits + torch.einsum("bkd,bsd->bks", caps, beh_hat)
    return caps


def mind_loss(params: dict, cfg: MINDConfig, batch: MINDBatch
              ) -> tuple[torch.Tensor, dict]:
    """Sampled softmax with label-aware attention: each candidate's score
    is its max over the interests (a tie's gradient split evenly, as
    ``jnp.max``'s), the target in column 0."""
    caps = mind_interests(params, cfg, batch.history)           # (B, K, D)
    cand = torch.cat([batch.target[:, None], batch.negatives], dim=1)
    cand_e = layers.take_rows(params["item_embed"]["table"],
                              cand.clamp(min=0))                # (B, 1+N, D)
    scores = torch.amax(torch.einsum("bkd,bnd->bkn", caps, cand_e), dim=1)
    loss = -torch.log_softmax(scores, dim=-1)[:, 0].mean()
    return loss, {"loss": loss}


def mind_retrieval(params: dict, cfg: MINDConfig, history: torch.Tensor,
                   top_r: int = 100) -> tuple[torch.Tensor, torch.Tensor]:
    """Multi-interest retrieval: the max over the K interest capsules of
    each item's score → (1, r) scores and item ids."""
    caps = mind_interests(params, cfg, history)                 # (1, K, D)
    scores = torch.einsum("bkd,rd->bkr", caps,
                          params["item_embed"]["table"])
    return top_k(scores.max(dim=1).values, top_r)


#: each arch's loss and init (the reference's ``launch/cells.py``
#: ``_REC_LOSS``)
LOSSES = {"dlrm-rm2": dlrm_loss, "sasrec": sasrec_loss, "dien": dien_loss,
          "mind": mind_loss}
INITS = {"dlrm-rm2": dlrm_init, "sasrec": sasrec_init, "dien": dien_init,
         "mind": mind_init}

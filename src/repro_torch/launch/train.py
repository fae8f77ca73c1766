"""Training loops and HI²_sup indexing (port of
``repro/launch/train.py``: ``fit``, ``SupTrainConfig``,
``train_hi2_sup``, ``SupSelectors`` and ``build_sup_index``).

  · :func:`fit` — the generic loop: value and grad, global-norm clip,
    AdamW, ``CheckpointManager`` saves and auto-resume, and the
    straggler monitor as an observer only;
  · :func:`cell_step` — one step of the reference's training cells
    (``launch/cells.py``'s ``train_step`` of the ``recsys/train``,
    ``gnn/*`` and ``lm/train`` cells): the same step at
    :data:`CELL_ADAM`, clipped at 1.0, over a family's
    ``loss(params, cfg, batch)``
    (:data:`repro_torch.models.recsys.LOSSES`,
    :func:`repro_torch.models.gnn.loss_fn`,
    :func:`repro_torch.models.transformer.cell_loss`);
  · :func:`train_hi2_sup` — the paper's joint optimisation (§4.3): the
    cluster embeddings, the term-scorer encoder and its MLP learned by
    KL distillation from the teacher embeddings, on ``device`` (default
    the card; raises without one).  On the card the encoder's attention
    is the hand-written flash kernel forward, differentiated by the
    reference's recompute (:mod:`repro_torch.kernels.flash_attention.
    ops`); every matmul stays f32 (no TF32).  Its batch stream
    (:func:`sup_batches`, numpy-seeded, the reference's ``batches``)
    and loss closure (:func:`sup_loss`) are module-level, so a caller
    can drive :func:`fit` from parameters made elsewhere — the
    reference's own initialisation, say, which the port cannot draw.

The trained selectors drive the same list construction as the
unsupervised path: the cluster side is the argmax over the learned
cluster embeddings, the term side the encoder + MLP saliency of Eq. 7
(:class:`SupSelectors`, :func:`build_sup_index`).  The query path stays
model-free, so an HI²_sup index is served by
:func:`repro_torch.core.hybrid_index.search` like any other.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import device as dev_mod
from repro_torch import tree as tree_mod
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import bm25
from repro_torch.core import cluster_selector as cs_mod
from repro_torch.core import distill
from repro_torch.core import hybrid_index as hi
from repro_torch.core import pruning
from repro_torch.core import term_selector as ts_mod
from repro_torch.data import synthetic
from repro_torch.distributed.fault import StragglerMonitor
from repro_torch.models import transformer as tfm
from repro_torch.optim import (AdamConfig, AdamState, adam_init, adam_update,
                               adam_update_, clip_by_global_norm,
                               clip_by_global_norm_, value_and_grad,
                               warmup_cosine)


# --------------------------------------------------------------------------
# generic loop
# --------------------------------------------------------------------------

def train_step(loss_fn: Callable, params, state: AdamState, batch,
               lr_scale, adam: AdamConfig, clip_norm: float):
    """One step of :func:`fit` → (params, state, loss, gnorm): value and
    grad of ``loss_fn(params, batch) -> (loss, aux)``, clip by the global
    norm, AdamW."""
    (loss, _), grads = value_and_grad(loss_fn, params, batch, has_aux=True)
    grads, gnorm = clip_by_global_norm(grads, clip_norm)
    params, state = adam_update(grads, state, params, adam,
                                lr_scale=lr_scale)
    return params, state, loss, gnorm


#: the training cells' optimizer (the reference's ``launch/cells.py``
#: ``ADAM``) and global-norm clip
CELL_ADAM = AdamConfig(lr=1e-4, weight_decay=0.0)
CELL_CLIP = 1.0


def cell_step(loss: Callable, cfg, params, state: AdamState, batch):
    """One training-cell step → (params, state, {"loss", "grad_norm"}):
    value and grad of ``loss(params, cfg, batch) -> (loss, aux)``, clipped
    at :data:`CELL_CLIP`, AdamW at :data:`CELL_ADAM` — :func:`train_step`'s
    step, the same bits, in place, as the reference's cells donate params
    and state (``launch/cells.py``, ``donate_argnums=(0, 1)``): ``params``
    and ``state`` are consumed and the returned trees hold their tensors
    (an LM's AdamW state at full width fits the card only so).  Clone
    ``params`` first to keep them."""
    (value, _), grads = value_and_grad(loss, params, cfg, batch,
                                       has_aux=True)
    grads, gnorm = clip_by_global_norm_(grads, CELL_CLIP)
    params, state = adam_update_(grads, state, params, CELL_ADAM)
    return params, state, {"loss": value, "grad_norm": gnorm}


def fit(loss_fn: Callable, params: Any, batches: Callable[[int], Any],
        n_steps: int, *, adam: AdamConfig = AdamConfig(lr=1e-3),
        clip_norm: float = 1.0, ckpt_dir: Optional[str] = None,
        save_every: int = 100, log_every: int = 20,
        schedule=None, monitor: Optional[StragglerMonitor] = None,
        device: dev_mod.DeviceLike = "cuda") -> tuple[Any, list[float]]:
    """Generic train loop on ``device``: value and grad + clip + AdamW,
    with checkpointing, resume and straggler monitoring.  ``params`` (a
    tree of tensors) and every ``batches(step)`` (tensors or numpy
    arrays) move to ``device``.

    With ``ckpt_dir``, ``{"params", "opt"}`` is saved every
    ``save_every`` steps in the reference's leaf order, and the newest
    valid checkpoint there is resumed from (the reference's checkpoints
    too), continuing the step-keyed batch stream.  The monitor is an
    observer: it times steps and counts strikes outside the numeric
    path, so any monitor (or none) leaves the trajectory bit-identical.
    ``float(loss)`` is read every step, as in the reference."""
    dev = dev_mod.resolve(device)
    schedule = schedule or (lambda s: 1.0)
    params = tree_mod.to(params, dev)
    state = adam_init(params)
    start = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep_n=2, save_every=save_every)
        step0, restored = mgr.restore_latest({"params": params, "opt": state})
        if step0 is not None:
            params, state, start = restored["params"], restored["opt"], step0

    monitor = monitor or StragglerMonitor()
    losses = []
    for i in range(start, n_steps):
        monitor.step_start()
        params, state, loss, gnorm = train_step(
            loss_fn, params, state, tree_mod.to(batches(i), dev),
            schedule(i), adam, clip_norm)
        losses.append(float(loss))
        monitor.step_end()
        if mgr and mgr.should_save(i + 1):
            mgr.save(i + 1, {"params": params, "opt": state})
        if log_every and (i + 1) % log_every == 0:
            print(f"  step {i+1}/{n_steps} loss={float(loss):.4f} "
                  f"gnorm={float(gnorm):.3f}", flush=True)
    return params, losses


# --------------------------------------------------------------------------
# HI²_sup distillation (paper §4.3, DESIGN.md §15)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SupTrainConfig:
    n_clusters: int = 128
    encoder_layers: int = 2
    encoder_dim: int = 64
    encoder_heads: int = 4
    n_steps: int = 300
    batch_queries: int = 32
    n_negatives: int = 7
    n_inbatch: int = 0          # extra in-batch negatives per row (§15)
    refine_weight: float = 0.0  # λ of the refine-stage KL (§15)
    lr: float = 2e-3
    warmup_steps: int = 20      # linear warmup, then cosine to n_steps
    kmeans_iters: int = 10
    seed: int = 0


def encoder_config(cfg: SupTrainConfig, vocab_size: int
                   ) -> tfm.TransformerConfig:
    """The term scorer's encoder: bidirectional, f32, d_ff = 4·d."""
    return tfm.TransformerConfig(
        n_layers=cfg.encoder_layers, d_model=cfg.encoder_dim,
        n_heads=cfg.encoder_heads, n_kv_heads=cfg.encoder_heads,
        d_ff=cfg.encoder_dim * 4, vocab_size=vocab_size, causal=False,
        compute_dtype=torch.float32, remat=False)


def init_sup(corpus, cfg: SupTrainConfig,
             device: dev_mod.DeviceLike = "cuda"
             ) -> tuple[distill.DistillParams, tfm.TransformerConfig,
                        torch.Tensor]:
    """The initial parameters on ``device`` → (DistillParams, encoder
    config, φ(D)): cluster embeddings from KMeans over the corpus (φ
    frozen afterwards, §4.3), the MLP and encoder drawn from ``cfg.seed``
    (one generator a stream, as the reference splits its key into three:
    the distributions of the reference's init, not its numbers)."""
    dev = dev_mod.resolve(device)
    doc_emb = dev_mod.as_tensor(corpus.doc_emb, dev, torch.float32)
    cluster_sel, doc_assign = cs_mod.init_kmeans(
        hi._generator(cfg.seed, 0, dev), doc_emb, cfg.n_clusters,
        n_iters=cfg.kmeans_iters)
    enc_cfg = encoder_config(cfg, corpus.vocab_size)
    params = distill.DistillParams(
        cluster_embeddings=cluster_sel.embeddings,
        term_mlp=ts_mod.init_mlp(hi._generator(cfg.seed, 1, dev),
                                 cfg.encoder_dim),
        encoder=tfm.init(hi._generator(cfg.seed, 2, dev), enc_cfg))
    return params, enc_cfg, doc_assign


def sup_batches(corpus, cfg: SupTrainConfig, negatives: np.ndarray,
                doc_assign) -> Callable[[int], distill.DistillBatch]:
    """The reference's batch stream: step → a host DistillBatch of
    ``cfg.batch_queries`` queries × (1 positive + ``cfg.n_negatives``
    drawn from the ``negatives`` pool + ``cfg.n_inbatch`` in-batch
    negatives), drawn by numpy from ``cfg.seed * 7919 + step``."""
    negatives = np.asarray(negatives, np.int32)
    if isinstance(doc_assign, torch.Tensor):
        doc_assign = doc_assign.cpu().numpy()
    assign_np = np.asarray(doc_assign)
    nq = corpus.qrels.shape[0]

    def batches(step: int) -> distill.DistillBatch:
        rng = np.random.default_rng(cfg.seed * 7919 + step)
        qi = rng.integers(0, nq, cfg.batch_queries)
        # per-row: own positive first, then a draw from the hard pool
        cols = rng.permuted(
            np.broadcast_to(np.arange(negatives.shape[1]),
                            (cfg.batch_queries, negatives.shape[1])),
            axis=1)[:, :cfg.n_negatives]
        hard = negatives[qi[:, None], cols]
        cand = np.concatenate([corpus.qrels[qi][:, None], hard], axis=1)
        cand = distill.add_in_batch_negatives(rng, cand, corpus.qrels[qi],
                                              cfg.n_inbatch)
        return distill.DistillBatch(
            query_emb=torch.from_numpy(corpus.query_emb[qi]),
            query_tokens=torch.from_numpy(corpus.query_tokens[qi]).long(),
            doc_emb=torch.from_numpy(corpus.doc_emb[cand]),
            doc_tokens=torch.from_numpy(corpus.doc_tokens[cand]).long(),
            doc_assign=torch.from_numpy(assign_np[cand]).long())

    return batches


def sup_loss(enc_cfg: tfm.TransformerConfig, vocab_size: int,
             refine_weight: float = 0.0) -> Callable:
    """``(params, batch) -> (loss, aux)``: :func:`repro_torch.core.
    distill.loss_fn` with the encoder's hidden states as the term
    scorer's input."""
    def encoder_apply(enc_params, tokens):
        hidden, _ = tfm.encode(enc_params, enc_cfg, tokens)
        return hidden

    def loss_fn(p, batch):
        return distill.loss_fn(p, batch, encoder_apply=encoder_apply,
                               vocab_size=vocab_size,
                               refine_weight=refine_weight)
    return loss_fn


def negative_pool(corpus, cfg: SupTrainConfig, negatives=None) -> np.ndarray:
    """``negatives`` (checked to hold ``cfg.n_negatives`` per query), or
    the topic-matched pool of :func:`repro_torch.data.synthetic.
    hard_negatives` by default."""
    if negatives is None:
        negatives = synthetic.hard_negatives(corpus, cfg.n_negatives,
                                             seed=cfg.seed)
    negatives = np.asarray(negatives, np.int32)
    if negatives.shape[1] < cfg.n_negatives:
        raise ValueError(
            f"negatives pool has {negatives.shape[1]} per query, "
            f"cfg.n_negatives={cfg.n_negatives}")
    return negatives


def train_hi2_sup(corpus, cfg: SupTrainConfig, log_every: int = 50, *,
                  negatives: Optional[np.ndarray] = None,
                  ckpt_dir: Optional[str] = None,
                  monitor: Optional[StragglerMonitor] = None,
                  device: dev_mod.DeviceLike = "cuda"):
    """Returns (DistillParams, encoder config, φ assignments, losses),
    trained on ``device``.

    ``corpus`` has the fields of :class:`repro_torch.data.synthetic.
    Corpus` as numpy arrays.  ``negatives`` optionally overrides the
    per-query hard-negative pool ((n_queries, >= cfg.n_negatives) doc
    ids; the §15 recipe mines it from the HI²_unsup index with
    :func:`repro_torch.core.distill.mine_hard_negatives`).
    ``cfg.n_inbatch`` appends in-batch negatives, ``cfg.refine_weight``
    enables the refine-stage KL, ``ckpt_dir`` and ``monitor`` (whose
    ``durations`` then hold the step times) thread through to
    :func:`fit`."""
    dev = dev_mod.resolve(device)
    params, enc_cfg, doc_assign = init_sup(corpus, cfg, dev)
    negatives = negative_pool(corpus, cfg, negatives)
    params, losses = fit(
        sup_loss(enc_cfg, corpus.vocab_size, cfg.refine_weight), params,
        sup_batches(corpus, cfg, negatives, doc_assign), cfg.n_steps,
        adam=AdamConfig(lr=cfg.lr),
        schedule=warmup_cosine(cfg.warmup_steps, cfg.n_steps),
        log_every=log_every, ckpt_dir=ckpt_dir, monitor=monitor, device=dev)
    return params, enc_cfg, doc_assign, losses


@dataclasses.dataclass(frozen=True)
class SupSelectors:
    """The trained selector bundle as a corpus-independent build recipe:
    cluster side = argmax over the learned embeddings, term side =
    encoder + MLP saliency (Eq. 7).  ``params`` are moved to ``device``
    (default the card; raises without one)."""
    params: distill.DistillParams
    enc_cfg: tfm.TransformerConfig
    encode_batch: int = 512
    device: Any = "cuda"

    def __post_init__(self):
        dev = dev_mod.resolve(self.device)
        object.__setattr__(self, "device", dev)
        object.__setattr__(self, "params", self.params.to(dev))

    def position_scores(self, doc_tokens) -> torch.Tensor:
        """Per-position saliency of every document, (n, Ld) f32 on the
        selectors' device, ``encode_batch`` documents at a time."""
        tokens = dev_mod.as_tensor(doc_tokens, self.device, torch.int64)
        chunks = []
        with torch.inference_mode():
            for chunk in tokens.split(self.encode_batch):
                hidden, _ = tfm.encode(self.params.encoder, self.enc_cfg,
                                       chunk)
                chunks.append(ts_mod.mlp_token_scores(
                    self.params.term_mlp, hidden.float(), chunk))
        return torch.cat(chunks)

    def build_inputs(self, doc_emb, doc_tokens, vocab_size: int) -> dict:
        """The selector overrides for :func:`repro_torch.core.
        hybrid_index.build` on an arbitrary corpus; φ is the argmax under
        the learned embeddings."""
        cluster_sel = cs_mod.ClusterSelector(self.params.cluster_embeddings)
        tokens = dev_mod.as_tensor(doc_tokens, self.device, torch.int64)
        pos_scores = self.position_scores(tokens)
        sbar = bm25.average_term_scores(tokens, pos_scores, vocab_size)
        emb = dev_mod.as_tensor(doc_emb, self.device, torch.float32)
        return dict(
            cluster_sel=cluster_sel,
            doc_assign=cs_mod.select_for_doc(cluster_sel, emb),
            term_pos_scores=pos_scores,
            term_sel=ts_mod.TermSelector(avg_scores=sbar))


def build_sup_index(corpus, params: distill.DistillParams,
                    enc_cfg: tfm.TransformerConfig, doc_assign, *,
                    k1_terms: int, codec: str = "opq", pq_m: int = 8,
                    pq_k: int = 256, cluster_capacity=None,
                    term_capacity=None,
                    prune_gamma: Optional[float] = None,
                    encode_batch: int = 512, sparse: bool = False,
                    doc_namespaces=None, seed: int = 1,
                    device: dev_mod.DeviceLike = "cuda",
                    timings: Optional[dict] = None) -> hi.HybridIndex:
    """Assemble HI²_sup on ``device``: the learned cluster embeddings and
    term scores drive the unsupervised path's list construction, with
    the frozen training-time φ(D) (``doc_assign``).  ``corpus`` needs
    ``doc_emb``, ``doc_tokens`` and ``vocab_size``.  ``seed`` stands in
    for the reference's ``jax.random.key(1)``; ``timings``, when a dict,
    receives the seconds of the position scores and of each build
    stage.  ``sparse``/``doc_namespaces`` pass through to
    :func:`repro_torch.core.hybrid_index.build`, so a supervised index
    serves hybrid and filtered search as the unsupervised one does."""
    sel = SupSelectors(params=params, enc_cfg=enc_cfg,
                       encode_batch=encode_batch, device=device)
    dev = sel.device
    t0 = time.perf_counter()
    tokens = dev_mod.as_tensor(corpus.doc_tokens, dev, torch.int64)
    pos_scores = sel.position_scores(tokens)
    sbar = bm25.average_term_scores(tokens, pos_scores, corpus.vocab_size)
    if timings is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timings["position_scores"] = time.perf_counter() - t0
    index = hi.build(
        seed, corpus.doc_emb, tokens, corpus.vocab_size,
        n_clusters=sel.params.cluster_embeddings.shape[0],
        k1_terms=k1_terms, codec=codec, pq_m=pq_m, pq_k=pq_k,
        cluster_capacity=cluster_capacity, term_capacity=term_capacity,
        cluster_sel=cs_mod.ClusterSelector(sel.params.cluster_embeddings),
        doc_assign=doc_assign, term_pos_scores=pos_scores,
        term_sel=ts_mod.TermSelector(avg_scores=sbar),
        sparse=sparse, doc_namespaces=doc_namespaces, device=dev,
        timings=timings)
    if prune_gamma is not None:
        index = dataclasses.replace(
            index, term_lists=pruning.prune_percentile(index.term_lists,
                                                       prune_gamma))
    return index

"""HI²_sup indexing (port of ``repro/launch/train.py``: ``SupSelectors``
and ``build_sup_index``; the training drivers ``fit`` and
``train_hi2_sup`` come with supervised training and raise).

The trained selectors drive the same list construction as the
unsupervised path (paper §4.3): the cluster side is the argmax over the
learned cluster embeddings, the term side the encoder + MLP saliency of
Eq. 7, computed here on ``device`` — the transformer's attention is the
hand-written flash kernel on the card.  The query path stays model-free,
so an HI²_sup index is served by :func:`repro_torch.core.hybrid_index.
search` like any other.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from repro_torch import device as dev_mod
from repro_torch.core import bm25
from repro_torch.core import cluster_selector as cs_mod
from repro_torch.core import distill
from repro_torch.core import hybrid_index as hi
from repro_torch.core import pruning
from repro_torch.core import term_selector as ts_mod
from repro_torch.models import transformer as tfm


def fit(*args, **kwargs):
    raise NotImplementedError("launch.train.fit (the training loop) is not "
                              "yet ported to repro_torch")


def train_hi2_sup(*args, **kwargs):
    raise NotImplementedError("launch.train.train_hi2_sup (HI²_sup "
                              "distillation) is not yet ported to "
                              "repro_torch; load the reference's trained "
                              "parameters with checkpoint.load_distill")


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

"""Joint optimisation of HI²_sup, paper §4.3 Eq. 9–13 (port of
``repro/core/distill.py``).

Trainable parameters (:class:`DistillParams`)
    · cluster embeddings  e_C                       (cluster selector)
    · term-scorer encoder + 2-layer MLP f(·)        (term selector)

Objective, per query Q with candidate docs D (positive + hard negatives
+ in-batch negatives):

    L = KL(Θ ∥ CS) + KL(Θ ∥ TS) + L_commit [+ λ·KL(Θ ∥ CS+TS)]
    Θ  = softmax(⟨e_Q, e_D⟩)                         Eq. 10 (teacher)
    CS = softmax(⟨e_Q, e_{C_φ(D)}⟩)                  Eq. 11
    TS = softmax(⟨s_Q, s_D⟩)                         Eq. 12
    L_commit = −Σ_D log softmax(⟨e_D, e_C⟩)[φ(D)]    Eq. 13

The optional λ term distills through the refine stage (DESIGN.md §15).
Θ is always detached: the teacher is a frozen embedding model (Eq. 10),
and the ``teacher=`` override of :func:`loss_fn` carries no gradient
either.  φ(D) is frozen after the KMeans init.

On the card the loss is repeatable bit for bit: the gather of cluster
embeddings (and the encoder's embedding lookup) sum their gradient rows
in row order (:func:`repro_torch.models.layers.take_rows`), the
commitment term's ``gather`` writes one gradient element per row (an
atomic add into zero, exact whatever the order), and the score vectors
are a max (:func:`repro_torch.core.bm25.score_vector`).

Negative candidates come from three mines of increasing hardness
(DESIGN.md §15): uniform (:func:`sample_candidates`), topic-matched
(:func:`repro_torch.data.synthetic.hard_negatives`) and index-mined
(:func:`mine_hard_negatives`), plus per-batch in-batch negatives
(:func:`add_in_batch_negatives`, numpy, the reference's draws).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import tree as tree_mod
from repro_torch.core import term_selector as ts_mod
from repro_torch.models import layers


class DistillParams(NamedTuple):
    cluster_embeddings: torch.Tensor   # (L, h)
    term_mlp: ts_mod.TermMLP
    encoder: dict                      # the term-scorer encoder's params

    def to(self, device) -> "DistillParams":
        return tree_mod.to(self, device)


class DistillBatch(NamedTuple):
    """One training step's inputs. B queries × D candidate docs each."""
    query_emb: torch.Tensor       # (B, h)   teacher/query embeddings (frozen)
    query_tokens: torch.Tensor    # (B, Lq)  padded token ids
    doc_emb: torch.Tensor         # (B, D, h) frozen doc embeddings
    doc_tokens: torch.Tensor      # (B, D, Ld)
    doc_assign: torch.Tensor      # (B, D) — φ(D), frozen


def kl(p_logits: torch.Tensor, q_logits: torch.Tensor) -> torch.Tensor:
    """KL(softmax(p) ∥ softmax(q)), batched over leading dims."""
    logp = torch.log_softmax(p_logits, dim=-1)
    logq = torch.log_softmax(q_logits, dim=-1)
    return torch.sum(torch.exp(logp) * (logp - logq), dim=-1)


def teacher_scores(batch: DistillBatch) -> torch.Tensor:
    """Θ's logits (Eq. 10): exact inner products of the frozen teacher
    embeddings over the candidate axis, (B, D) f32."""
    return torch.einsum("bh,bdh->bd", batch.query_emb.float(),
                        batch.doc_emb.float())


def loss_fn(params: DistillParams, batch: DistillBatch,
            encoder_apply: Callable[..., torch.Tensor], vocab_size: int,
            refine_weight: float = 0.0,
            teacher: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, dict]:
    """Eq. 9 + Eq. 13 (+ the §15 refine-stage KL when ``refine_weight``
    > 0) → (total, aux).  ``encoder_apply(params.encoder, tokens) ->
    (B, L, h)``.  ``teacher`` optionally overrides the Eq. 10 logits;
    either way it is detached."""
    b, d, ld = batch.doc_tokens.shape

    # --- teacher (Eq. 10) -------------------------------------------------
    if teacher is None:
        teacher = teacher_scores(batch)
    teacher = teacher.detach()

    # --- cluster-selector student (Eq. 11) --------------------------------
    c_emb = layers.take_rows(params.cluster_embeddings,
                             batch.doc_assign)                  # (B, D, h)
    cs_logits = torch.einsum("bh,bdh->bd", batch.query_emb.float(), c_emb)

    # --- term-selector student (Eq. 12) -----------------------------------
    # queries and documents are processed the same way (paper note)
    q_hidden = encoder_apply(params.encoder, batch.query_tokens)
    q_pos = ts_mod.mlp_token_scores(params.term_mlp, q_hidden,
                                    batch.query_tokens)
    s_q = ts_mod.score_vectors(batch.query_tokens, q_pos, vocab_size)

    flat_docs = batch.doc_tokens.reshape(b * d, ld)
    d_hidden = encoder_apply(params.encoder, flat_docs)
    d_pos = ts_mod.mlp_token_scores(params.term_mlp, d_hidden, flat_docs)
    s_d = ts_mod.score_vectors(flat_docs, d_pos, vocab_size)
    s_d = s_d.reshape(b, d, vocab_size)
    ts_logits = torch.einsum("bv,bdv->bd", s_q, s_d)

    # --- losses ------------------------------------------------------------
    l_cs = kl(teacher, cs_logits).mean()
    l_ts = kl(teacher, ts_logits).mean()

    # commitment (Eq. 13): keep e_D close to its frozen cluster
    commit_logits = torch.einsum("bdh,lh->bdl", batch.doc_emb.float(),
                                 params.cluster_embeddings)     # (B, D, L)
    logp = torch.log_softmax(commit_logits, dim=-1)
    l_commit = -torch.gather(logp, -1,
                             batch.doc_assign.long()[..., None]).mean()

    # refine-stage distillation (DESIGN.md §15)
    l_refine = kl(teacher, cs_logits + ts_logits).mean()

    total = l_cs + l_ts + l_commit + refine_weight * l_refine
    aux = {"loss": total, "kl_cluster": l_cs, "kl_term": l_ts,
           "commit": l_commit, "kl_refine": l_refine}
    return total, aux


# --------------------------------------------------------------------------
# negative mining
# --------------------------------------------------------------------------

def sample_candidates(generator: torch.Generator, positives: torch.Tensor,
                      n_docs: int, n_negatives: int) -> torch.Tensor:
    """positive + uniform negatives → (B, 1+n_negatives) doc ids (the
    unit-test fallback; the draws are ``generator``'s, not
    ``jax.random``'s)."""
    b = positives.shape[0]
    negs = torch.randint(0, n_docs, (b, n_negatives), generator=generator,
                         device=generator.device).to(positives.dtype)
    return torch.cat([positives[:, None].to(negs.device), negs], dim=-1)


def mine_hard_negatives(index, query_emb, query_tokens, positives,
                        n_neg: int, *, kc: int = 6, k2: int = 8,
                        seed: int = 0) -> np.ndarray:
    """Top-scoring non-relevant docs per query, mined from a built index
    (the HI²_unsup baseline in practice) through
    :func:`repro_torch.core.hybrid_index.search` on the index's device
    → (n_queries, n_neg) i32.  Rows whose frontier is too shallow are
    topped up with uniform draws (numpy, the reference's) so the shape
    stays fixed."""
    from repro_torch.core import hybrid_index as hi

    positives = np.asarray(positives).reshape(-1)
    res = hi.search(index, query_emb, query_tokens, kc=kc, k2=k2,
                    top_r=n_neg + 8, device=index.device)
    ids = res.doc_ids.cpu().numpy()
    rng = np.random.default_rng(seed)
    out = np.empty((ids.shape[0], n_neg), np.int32)
    for i in range(ids.shape[0]):
        row = ids[i]
        row = row[(row >= 0) & (row != positives[i])][:n_neg]
        if row.shape[0] < n_neg:
            fill = rng.integers(0, index.n_docs, n_neg - row.shape[0])
            row = np.concatenate([row, fill])
        out[i] = row
    return out


def add_in_batch_negatives(rng: np.random.Generator, candidates: np.ndarray,
                           positives: np.ndarray,
                           n_inbatch: int) -> np.ndarray:
    """Append ``n_inbatch`` in-batch negatives (positives of other rows of
    the batch) to each row's candidates: (B, D) with column 0 the row's
    own positive → (B, D + n_inbatch)."""
    b = candidates.shape[0]
    if n_inbatch <= 0:
        return candidates
    if b < 2:
        raise ValueError("in-batch negatives need a batch of >= 2 queries")
    positives = np.asarray(positives).reshape(-1)
    # sample other-row indices: draw from [0, b-1) and skip self by shift
    draw = rng.integers(0, b - 1, size=(b, n_inbatch))
    rows = np.arange(b)[:, None]
    other = np.where(draw >= rows, draw + 1, draw)
    return np.concatenate([candidates, positives[other]], axis=1)

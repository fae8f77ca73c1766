"""Shared fixtures of the paper benchmarks (port of
``benchmarks/common.py``): one corpus and one trained HI²_sup per
process and device (built once, reused across tables), plus timing.

The port builds from an int seed (0, or 3 for Table 1's Distill-VQ)
where the reference draws from ``jax.random.key(0)``: the same corpus,
but the port's own KMeans and codebook draws, so an index built here is
not the reference's leaf for leaf.  Each script therefore splits
building its indexes from computing its rows over given indexes, and
the parity tests feed the rows functions indexes the JAX package built.

The sizes are module constants read at call time, and every cache is
keyed by them and by the device, so a caller may shrink them.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import device as dev_mod
from repro_torch.benchmarks import timing
from repro_torch.core import hybrid_index as hi, metrics
from repro_torch.data import synthetic
from repro_torch.launch import train as tr

# benchmark-scale corpus (≈ laptop-scale stand-in for MS MARCO; DESIGN.md §2)
N_DOCS = 20_000
N_QUERIES = 800
HIDDEN = 64
VOCAB = 8_192
N_CLUSTERS = 256
SUP_STEPS = 200                      # HI²_sup training steps

COMMON_INDEX = dict(k1_terms=12, codec="opq", pq_m=8, pq_k=256,
                    cluster_capacity=256, term_capacity=128)
KC, K2, TOP_R = 6, 8, 100


def _sizes() -> tuple:
    return (N_DOCS, N_QUERIES, HIDDEN, VOCAB, N_CLUSTERS, SUP_STEPS,
            tuple(sorted(COMMON_INDEX.items())))


def corpus(seed: int = 0) -> synthetic.Corpus:
    return _corpus(seed, N_DOCS, N_QUERIES, HIDDEN, VOCAB)


@functools.lru_cache(maxsize=2)
def _corpus(seed, n_docs, n_queries, hidden, vocab) -> synthetic.Corpus:
    return synthetic.generate(seed=seed, n_docs=n_docs, n_queries=n_queries,
                              hidden=hidden, vocab_size=vocab, n_topics=128)


def unsup_index(device: dev_mod.DeviceLike = "cuda") -> hi.HybridIndex:
    return _unsup_index(dev_mod.resolve(device), _sizes())


@functools.lru_cache(maxsize=2)
def _unsup_index(dev: torch.device, sizes: tuple) -> hi.HybridIndex:
    c = corpus()
    return hi.build(0, c.doc_emb, c.doc_tokens, c.vocab_size,
                    n_clusters=N_CLUSTERS, kmeans_iters=10, device=dev,
                    **COMMON_INDEX)


def sup_artifacts(device: dev_mod.DeviceLike = "cuda"):
    """(DistillParams, encoder config, φ(D)) of HI²_sup trained on
    ``device``."""
    return _sup_artifacts(dev_mod.resolve(device), _sizes())


@functools.lru_cache(maxsize=2)
def _sup_artifacts(dev: torch.device, sizes: tuple):
    cfg = tr.SupTrainConfig(n_clusters=N_CLUSTERS, n_steps=SUP_STEPS,
                            batch_queries=32, lr=2e-3)
    params, enc_cfg, assign, _ = tr.train_hi2_sup(corpus(), cfg, log_every=0,
                                                  device=dev)
    return params, enc_cfg, assign


def sup_index(device: dev_mod.DeviceLike = "cuda") -> hi.HybridIndex:
    return _sup_index(dev_mod.resolve(device), _sizes())


@functools.lru_cache(maxsize=2)
def _sup_index(dev: torch.device, sizes: tuple) -> hi.HybridIndex:
    params, enc_cfg, assign = sup_artifacts(dev)
    return tr.build_sup_index(corpus(), params, enc_cfg, assign, device=dev,
                              **COMMON_INDEX)


def queries():
    c = corpus()
    return c.query_emb, c.query_tokens


def evaluate(result, qrels=None) -> dict:
    c = corpus()
    qrels = c.qrels if qrels is None else qrels
    return {
        "R@10": metrics.recall_at_k(result.doc_ids, qrels, 10),
        "R@100": metrics.recall_at_k(result.doc_ids, qrels, 100),
        "MRR@10": metrics.mrr_at_k(result.doc_ids, qrels, 10),
        "candidates": float(result.n_candidates.cpu().float().mean()),
    }


def index_size_bytes(index: hi.HybridIndex) -> int:
    return sum(leaf.nbytes for _, leaf in hi.index_leaves(index))


def time_call(fn, *args, device: dev_mod.DeviceLike = "cuda",
              warmup: int = 1, iters: int = 3) -> float:
    """Mean wall time per call in microseconds (after ``warmup`` calls),
    each call synchronized on ``device``."""
    return timing.mean_us(fn, *args, device=dev_mod.resolve(device),
                          warmup=warmup, iters=iters)

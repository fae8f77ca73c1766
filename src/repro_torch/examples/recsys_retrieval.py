"""Assigned-architecture integration: accelerate SASRec item retrieval
with HI² (the ``retrieval_cand`` scenario, DESIGN.md §4; port of
``examples/recsys_retrieval.py``).

The item-embedding table is the corpus; item "tokens" are synthetic
attribute ids (category/brand-style salient terms); user embeddings are
the queries.  HI² retrieves top items without scoring all candidates.

    python -m repro_torch.examples.recsys_retrieval [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import device as dev_mod
from repro_torch.core import hybrid_index as hi, metrics
from repro_torch.core.codecs import flat
from repro_torch.data import recsys as rdata
from repro_torch.models import recsys

N_ITEMS, EMBED_DIM, SEQ_LEN, N_USERS = 20_000, 32, 20, 64
VOCAB, N_CLUSTERS, K1_TERMS = 2048, 128, 3
CLUSTER_CAP, TERM_CAP, KMEANS_ITERS = 512, 128, 8
KC, K2, TOP_R = 6, 3, 10


def item_tokens(n_items: int, vocab: int, seed: int = 0):
    """(category, brand, random) attribute terms of every item → the
    (n_items, 3) tokens and the category and brand of each item."""
    rng = np.random.default_rng(seed)
    cats = (np.arange(n_items) // 37) % (vocab // 2)       # category term
    brand = vocab // 2 + (np.arange(n_items) // 411) % (vocab // 2)
    tokens = np.stack([cats, brand, rng.integers(0, vocab, n_items)],
                      1).astype(np.int32)
    return tokens, cats, brand


def query_tokens(items: np.ndarray, cats: np.ndarray, brand: np.ndarray):
    """Query "tokens": categories of the two items before the last and
    the brand of the last one a user consumed."""
    recent = items[:, -3:]
    return np.stack([cats[recent[:, 0]], cats[recent[:, 1]],
                     brand[recent[:, 2]]], 1).astype(np.int32)


def run(params: dict, cfg: recsys.SASRecConfig, dev, *, n_clusters: int,
        n_users: int, cluster_capacity: int = CLUSTER_CAP,
        term_capacity: int = TERM_CAP, kmeans_iters: int = KMEANS_ITERS,
        index=None, seed: int = 0) -> dict:
    """The example's recipe over ``params``' item table on ``dev``: HI²
    over the table (unless ``index`` is given), ``n_users`` SASRec users
    as queries; returns the index, users, HI²'s result and the exact
    top-10 of brute force."""
    table = params["item_embed"]["table"]
    tokens, cats, brand = item_tokens(cfg.n_items, VOCAB, seed)
    if index is None:
        index = hi.build(1, table, tokens, VOCAB, n_clusters=n_clusters,
                         k1_terms=K1_TERMS, codec="flat",
                         cluster_capacity=cluster_capacity,
                         term_capacity=term_capacity,
                         kmeans_iters=kmeans_iters, device=dev)
    batch = rdata.sasrec_batch(seed, n_users, seq_len=cfg.seq_len,
                               n_items=cfg.n_items, device=dev)
    with torch.inference_mode():
        users = recsys.sasrec_user_embedding(params, cfg, batch.items)
        _, exact = flat.search(users, table, k=TOP_R)
    q_tokens = query_tokens(batch.items.cpu().numpy(), cats, brand)
    res = hi.search(index, users, q_tokens, kc=KC, k2=K2, top_r=TOP_R,
                    device=dev)
    return dict(index=index, users=users, q_tokens=q_tokens, res=res,
                exact=exact)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (their plain "
                         "versions)")
    dev = dev_mod.resolve(ap.parse_args(argv).device)

    cfg = recsys.SASRecConfig(n_items=N_ITEMS, embed_dim=EMBED_DIM,
                              seq_len=SEQ_LEN)
    params = recsys.sasrec_init(
        torch.Generator(device=dev).manual_seed(0), cfg)
    out = run(params, cfg, dev, n_clusters=N_CLUSTERS, n_users=N_USERS)
    res = out["res"]
    # ground truth = exact top-1 item by embedding score
    overlap = metrics.recall_at_k(res.doc_ids, out["exact"][:, 0], TOP_R)
    print(f"HI² top-10 contains the exact top-1 item for "
          f"{overlap*100:.1f}% of users, evaluating "
          f"{float(res.n_candidates.float().mean()):.0f}/{N_ITEMS} "
          f"candidates")


if __name__ == "__main__":
    main()

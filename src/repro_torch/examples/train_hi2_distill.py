"""End-to-end training driver: HI²_sup joint optimization (paper §4.3;
port of ``examples/train_hi2_distill.py``).

Trains the cluster embeddings + term-scorer encoder by KL distillation
from a teacher embedding model for a few hundred steps, builds the
supervised index, and evaluates against HI²_unsup.

    python -m repro_torch.examples.train_hi2_distill [--device cpu]
"""
import argparse

from repro_torch import device as dev_mod
from repro_torch.core import hybrid_index as hi, metrics
from repro_torch.data import synthetic
from repro_torch.launch import train as tr

N_DOCS, N_QUERIES, N_CLUSTERS, N_STEPS = 12_000, 500, 192, 300


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (their plain "
                         "versions)")
    dev = dev_mod.resolve(ap.parse_args(argv).device)

    corpus = synthetic.generate(seed=0, n_docs=N_DOCS, n_queries=N_QUERIES,
                                hidden=64, vocab_size=8192)
    qe, qt = corpus.query_emb, corpus.query_tokens
    common = dict(k1_terms=12, codec="opq", pq_m=8, pq_k=256,
                  cluster_capacity=256, term_capacity=128)

    print("training HI²_sup by knowledge distillation (Eq. 9-13)...")
    cfg = tr.SupTrainConfig(n_clusters=N_CLUSTERS, n_steps=N_STEPS,
                            batch_queries=32, lr=2e-3)
    params, enc_cfg, assign, losses = tr.train_hi2_sup(corpus, cfg,
                                                       log_every=50,
                                                       device=dev)
    print(f"distillation loss {losses[0]:.4f} -> {losses[-1]:.4f}")

    print("building both indexes...")
    sup = tr.build_sup_index(corpus, params, enc_cfg, assign,
                             prune_gamma=0.996, device=dev, **common)
    unsup = hi.build(0, corpus.doc_emb, corpus.doc_tokens, corpus.vocab_size,
                     n_clusters=N_CLUSTERS, kmeans_iters=10, device=dev,
                     **common)

    for name, idx in (("HI2_unsup", unsup), ("HI2_sup", sup)):
        r = hi.search(idx, qe, qt, kc=6, k2=8, top_r=100, device=dev)
        print(f"{name:<12} R@100="
              f"{metrics.recall_at_k(r.doc_ids, corpus.qrels, 100):.4f} "
              f"MRR@10={metrics.mrr_at_k(r.doc_ids, corpus.qrels, 10):.4f} "
              f"candidates={float(r.n_candidates.float().mean()):.0f}")


if __name__ == "__main__":
    main()

"""Quickstart: build a Hybrid Inverted Index over a synthetic corpus and
search it, comparing against IVF and brute force — then sweep every
registered codec over the same lists (the paper's Table 3 axis; port of
``examples/quickstart.py``).

    python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import torch

from repro_torch import device as dev_mod
from repro_torch.core import codecs, hybrid_index as hi, metrics
from repro_torch.core.codecs import flat
from repro_torch.data import synthetic

N_DOCS, N_QUERIES, N_CLUSTERS = 12_000, 500, 192


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (their plain "
                         "versions)")
    dev = dev_mod.resolve(ap.parse_args(argv).device)

    print(f"generating corpus ({N_DOCS // 1000}k docs)...")
    corpus = synthetic.generate(seed=0, n_docs=N_DOCS, n_queries=N_QUERIES,
                                hidden=64, vocab_size=8192)
    de, dt = corpus.doc_emb, corpus.doc_tokens
    qe, qt = corpus.query_emb, corpus.query_tokens

    print("building HI²_unsup (KMeans clusters + BM25 terms + OPQ codec)...")
    index = hi.build(0, de, dt, corpus.vocab_size,
                     n_clusters=N_CLUSTERS, k1_terms=12, codec="opq",
                     pq_m=8, pq_k=256, cluster_capacity=256,
                     term_capacity=128, kmeans_iters=10, device=dev)

    print("searching...")
    _, fids = flat.search(torch.from_numpy(qe).to(dev),
                          torch.from_numpy(de).to(dev), k=100)
    r_hi2 = hi.search(index, qe, qt, kc=6, k2=8, top_r=100, device=dev)
    r_ivf = hi.search_ivf(index, qe, qt, kc=10, top_r=100, device=dev)

    print(f"\n{'method':<22}{'R@100':>8}{'MRR@10':>9}{'candidates':>12}")
    print(f"{'Flat (brute force)':<22}"
          f"{metrics.recall_at_k(fids, corpus.qrels, 100):>8.3f}"
          f"{'':>9}{corpus.doc_emb.shape[0]:>12}")
    for name, r in (("IVF-OPQ", r_ivf), ("HI2_unsup", r_hi2)):
        print(f"{name:<22}"
              f"{metrics.recall_at_k(r.doc_ids, corpus.qrels, 100):>8.3f}"
              f"{metrics.mrr_at_k(r.doc_ids, corpus.qrels, 10):>9.3f}"
              f"{float(r.n_candidates.float().mean()):>12.0f}")
    print("\nHI² reaches higher recall than IVF while evaluating fewer "
          "candidates — the paper's headline claim.")

    # the same candidate geometry under every registered codec (the
    # trained cluster selector/assignment are reused, skipping KMeans —
    # the dominant build cost; BM25 term fitting reruns per build)
    print(f"\ncodec sweep ({', '.join(codecs.registered())}):")
    print(f"{'codec':<10}{'R@100':>8}{'bytes/doc':>11}{'cost':>7}")
    for spec in codecs.registered():
        cidx = hi.build(0, de, dt, corpus.vocab_size,
                        n_clusters=N_CLUSTERS, k1_terms=12, codec=spec,
                        pq_m=8, pq_k=256, cluster_capacity=256,
                        term_capacity=128,
                        cluster_sel=index.cluster_sel,
                        doc_assign=index.doc_assign, device=dev)
        r = hi.search(cidx, qe, qt, kc=6, k2=8, top_r=100, device=dev)
        print(f"{spec:<10}"
              f"{metrics.recall_at_k(r.doc_ids, corpus.qrels, 100):>8.3f}"
              f"{codecs.get(spec).bytes_per_doc(cidx.doc_planes):>11}"
              f"{hi.candidate_cost(cidx, 6, 8, 100):>7}")


if __name__ == "__main__":
    main()

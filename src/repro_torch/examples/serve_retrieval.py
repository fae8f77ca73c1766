"""End-to-end serving driver: batched retrieval requests against a
persisted HI² index — build once, checkpoint, restore (the crash-safe
path), then serve query batches through the search step (port of
``examples/serve_retrieval.py``).

    python -m repro_torch.examples.serve_retrieval [--device cpu]
"""
import argparse
import tempfile
import time

from repro_torch import device as dev_mod
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import hybrid_index as hi, metrics
from repro_torch.data import synthetic

N_DOCS, N_QUERIES, N_CLUSTERS, BATCH = 12_000, 512, 192, 64


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (their plain "
                         "versions)")
    dev = dev_mod.resolve(ap.parse_args(argv).device)

    corpus = synthetic.generate(seed=0, n_docs=N_DOCS, n_queries=N_QUERIES,
                                hidden=64, vocab_size=8192)
    index = hi.build(0, corpus.doc_emb, corpus.doc_tokens, corpus.vocab_size,
                     n_clusters=N_CLUSTERS, k1_terms=12, codec="opq", pq_m=8,
                     pq_k=256, cluster_capacity=256, term_capacity=128,
                     kmeans_iters=10, device=dev)

    # persist + restore the index (the serving fleet's startup path);
    # save_index records the codec spec so a restore against an index
    # built with a different setting fails loudly
    with tempfile.TemporaryDirectory() as d:
        path = ckpt.save_index(d, 0, index)
        index = ckpt.restore_index(path, index)
        print(f"index persisted+restored from {path}")

    # serve batched requests
    qe, qt = corpus.query_emb, corpus.query_tokens
    hits, n = 0.0, 0
    t0 = time.perf_counter()
    for i in range(0, qe.shape[0], BATCH):
        res = hi.search(index, qe[i:i + BATCH], qt[i:i + BATCH],
                        kc=6, k2=8, top_r=100, device=dev)
        hits += metrics.recall_at_k(res.doc_ids,
                                    corpus.qrels[i:i + BATCH], 100) * BATCH
        n += BATCH
    dt = time.perf_counter() - t0
    print(f"served {n} queries in {dt:.2f}s "
          f"({n/dt:.0f} q/s on {dev}; R@100={hits/n:.3f})")


if __name__ == "__main__":
    main()

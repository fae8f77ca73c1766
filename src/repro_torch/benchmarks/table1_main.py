"""Paper Table 1 — overall evaluation: quality + efficiency of every
index family on the synthetic benchmark corpus (port of
``benchmarks/table1_main.py``).

    python -m repro_torch.benchmarks.table1_main [--device cpu]

Rows: Flat (brute force), IVF-OPQ, Distill-VQ (learned clusters, no
terms), term-only, HI²_unsup, HI²_sup.  Columns: MRR@10, R@10, R@100,
candidate budget (the latency proxy — §5.1: same candidates ⇒ same
latency), index size.  :func:`build` makes the three indexes (HI²_sup is
trained on ``--device``); :func:`rows` evaluates given indexes.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import device as dev_mod
from repro_torch.benchmarks import common
from repro_torch.core import cluster_selector as cs_mod, hybrid_index as hi
from repro_torch.core.codecs import flat


def build(device: dev_mod.DeviceLike = "cuda") -> dict:
    """The table's indexes on ``device``: ``unsup`` (HI²_unsup),
    ``distill_vq`` (the learned cluster embeddings and φ, no term lists)
    and ``sup`` (HI²_sup)."""
    dev = dev_mod.resolve(device)
    c = common.corpus()
    params, enc_cfg, assign = common.sup_artifacts(dev)
    dv = hi.build(3, c.doc_emb, c.doc_tokens, c.vocab_size,
                  n_clusters=common.N_CLUSTERS,
                  cluster_sel=cs_mod.ClusterSelector(
                      embeddings=params.cluster_embeddings),
                  doc_assign=assign, use_terms=False, device=dev,
                  **common.COMMON_INDEX)
    return {"unsup": common.unsup_index(dev), "distill_vq": dv,
            "sup": common.sup_index(dev)}


def rows(indexes: dict, device: dev_mod.DeviceLike = "cuda") -> list[dict]:
    """The six rows over :func:`build`'s ``indexes`` (on ``device``)."""
    dev = dev_mod.resolve(device)
    c = common.corpus()
    qe, qt = common.queries()
    out = []

    # Flat upper bound
    _, fids = flat.search(torch.from_numpy(qe).to(dev),
                          torch.from_numpy(c.doc_emb).to(dev),
                          k=common.TOP_R)
    r = hi.SearchResult(doc_ids=fids, scores=torch.zeros(fids.shape),
                        n_candidates=torch.full((qe.shape[0],),
                                                c.doc_emb.shape[0],
                                                dtype=torch.int32))
    out.append(dict(method="Flat(brute force)", **common.evaluate(r),
                    index_bytes=c.doc_emb.nbytes))

    idx = indexes["unsup"]
    # IVF-OPQ — cluster-only at a LARGER budget than HI² (paper setting)
    r = hi.search_ivf(idx, qe, qt, kc=10, top_r=common.TOP_R, device=dev)
    out.append(dict(method="IVF-OPQ", **common.evaluate(r),
                    index_bytes=common.index_size_bytes(idx)))

    # Distill-VQ: learned cluster embeddings, no term lists
    dv = indexes["distill_vq"]
    r = hi.search_ivf(dv, qe, qt, kc=10, top_r=common.TOP_R, device=dev)
    out.append(dict(method="Distill-VQ", **common.evaluate(r),
                    index_bytes=common.index_size_bytes(dv)))

    # term-only (w.o. Clus)
    r = hi.search_term_only(idx, qe, qt, k2=common.K2, top_r=common.TOP_R,
                            device=dev)
    out.append(dict(method="TermOnly(w.o.Clus)", **common.evaluate(r),
                    index_bytes=common.index_size_bytes(idx)))

    # HI² unsup / sup
    r = hi.search(idx, qe, qt, kc=common.KC, k2=common.K2,
                  top_r=common.TOP_R, device=dev)
    out.append(dict(method="HI2_unsup", **common.evaluate(r),
                    index_bytes=common.index_size_bytes(idx)))
    sup = indexes["sup"]
    r = hi.search(sup, qe, qt, kc=common.KC, k2=common.K2,
                  top_r=common.TOP_R, device=dev)
    out.append(dict(method="HI2_sup", **common.evaluate(r),
                    index_bytes=common.index_size_bytes(sup)))
    return out


def run(device: dev_mod.DeviceLike = "cuda") -> list[dict]:
    dev = dev_mod.resolve(device)
    return rows(build(dev), dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)
    for row in run(args.device):
        print(row)


if __name__ == "__main__":
    main()

"""Paper Table 2 — robustness across embedding models (RQ3; port of
``benchmarks/table2_robustness.py``).

    python -m repro_torch.benchmarks.table2_robustness [--device cpu]

The same corpus under two encoders: model A (the generator's encoder)
and model B (rotated + noisier — a weaker but consistent encoder).
HI² must track brute-force quality under both; IVF must not.
:func:`build` makes one HI²_unsup index per encoder, :func:`rows`
evaluates given indexes.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import device as dev_mod
from repro_torch.benchmarks import common
from repro_torch.core import hybrid_index as hi, metrics
from repro_torch.core.codecs import flat

ENCODERS = ("encA", "encB(weaker)")


def _embeddings(tag: str) -> tuple:
    """(doc, query) embeddings of the encoder ``tag``."""
    c = common.corpus()
    if tag == ENCODERS[0]:
        return c.doc_emb, c.query_emb
    return c.doc_emb_b, c.query_emb_b


def build(device: dev_mod.DeviceLike = "cuda") -> dict:
    """Encoder tag → its HI²_unsup index on ``device``."""
    dev = dev_mod.resolve(device)
    c = common.corpus()
    return {tag: hi.build(0, _embeddings(tag)[0], c.doc_tokens, c.vocab_size,
                          n_clusters=common.N_CLUSTERS, kmeans_iters=10,
                          device=dev, **common.COMMON_INDEX)
            for tag in ENCODERS}


def _eval_model(doc_emb, query_emb, tag: str, idx,
                dev: torch.device) -> list[dict]:
    c = common.corpus()
    qt = c.query_tokens
    rows = []

    _, fids = flat.search(torch.from_numpy(query_emb).to(dev),
                          torch.from_numpy(doc_emb).to(dev), k=common.TOP_R)
    rows.append(dict(model=tag, method="Flat",
                     R100=metrics.recall_at_k(fids, c.qrels, 100)))

    r = hi.search_ivf(idx, query_emb, qt, kc=10, top_r=common.TOP_R,
                      device=dev)
    rows.append(dict(model=tag, method="IVF-OPQ",
                     R100=metrics.recall_at_k(r.doc_ids, c.qrels, 100)))
    r = hi.search(idx, query_emb, qt, kc=common.KC, k2=common.K2,
                  top_r=common.TOP_R, device=dev)
    rows.append(dict(model=tag, method="HI2_unsup",
                     R100=metrics.recall_at_k(r.doc_ids, c.qrels, 100)))
    return rows


def rows(indexes: dict, device: dev_mod.DeviceLike = "cuda") -> list[dict]:
    """The rows over :func:`build`'s ``indexes`` (on ``device``)."""
    dev = dev_mod.resolve(device)
    return [row for tag in ENCODERS
            for row in _eval_model(*_embeddings(tag), tag, indexes[tag], dev)]


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

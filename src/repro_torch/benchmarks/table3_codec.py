"""Paper Table 3 (appendix C), generalized — the same HI² lists
evaluated under every codec in the registry (DESIGN.md §7): the
quality / bytes-per-doc / candidate-cost trade across index settings
(port of ``benchmarks/table3_codec.py``).

    python -m repro_torch.benchmarks.table3_codec                 # card
    python -m repro_torch.benchmarks.table3_codec --smoke --check \\
        --device cpu --out /tmp/BENCH_codec.json                  # CPU

Emits the ``BENCH_codec.json`` report (to stdout, and with ``--out`` to
that file only) and, with ``--check``, exits nonzero if the refine codec
fails its contract: recall@R within 0.001 of the flat codec at ≤ 1.25×
the pq candidate-cost proxy ("lossless at PQ cost").  :func:`build`
makes one index per codec over one KMeans, :func:`rows` evaluates given
indexes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch import device as dev_mod
from repro_torch.benchmarks import common
from repro_torch.core import codecs, hybrid_index as hi, metrics
from repro_torch.data import synthetic

#: tolerance/cost bounds of the refine contract (also enforced in CI)
RECALL_SLACK = 0.001
COST_RATIO = 1.25


def build(corpus, *, n_clusters, kmeans_iters, index_kwargs, specs,
          device: dev_mod.DeviceLike = "cuda") -> dict:
    """Codec spec → its index on ``device``, every one over the lists of
    the first build."""
    dev = dev_mod.resolve(device)
    indexes = {}
    sel = {}     # cluster selector/assignment reused after the first build
    for spec in specs:
        kwargs = dict(index_kwargs)
        kwargs["codec"] = spec
        idx = hi.build(0, corpus.doc_emb, corpus.doc_tokens,
                       corpus.vocab_size, n_clusters=n_clusters,
                       kmeans_iters=kmeans_iters, device=dev, **kwargs,
                       **sel)
        # identical seed+data ⇒ identical lists; skip KMeans (the
        # dominant build cost) on the remaining codecs
        sel = {"cluster_sel": idx.cluster_sel, "doc_assign": idx.doc_assign}
        indexes[spec] = idx
    return indexes


def rows(corpus, indexes: dict, *, kc, k2, top_r,
         device: dev_mod.DeviceLike = "cuda") -> list[dict]:
    """One row per codec of ``indexes`` (on ``device``), in their order."""
    dev = dev_mod.resolve(device)
    out = []
    for spec, idx in indexes.items():
        r = hi.search(idx, corpus.query_emb, corpus.query_tokens, kc=kc,
                      k2=k2, top_r=top_r, device=dev)
        out.append(dict(
            codec=spec,
            resolved=codecs.get(spec).name,
            **{"R@10": metrics.recall_at_k(r.doc_ids, corpus.qrels, 10),
               "R@100": metrics.recall_at_k(r.doc_ids, corpus.qrels, 100),
               "MRR@10": metrics.mrr_at_k(r.doc_ids, corpus.qrels, 10),
               "candidates": float(r.n_candidates.cpu().float().mean())},
            bytes_per_doc=codecs.get(spec).bytes_per_doc(idx.doc_planes),
            index_bytes=common.index_size_bytes(idx),
            candidate_budget=hi.candidate_budget(idx, kc, k2),
            candidate_cost=hi.candidate_cost(idx, kc, k2, top_r)))
    return out


def setting(smoke: bool = False) -> tuple:
    """(corpus, :func:`build`'s keyword arguments but ``specs``): the
    smoke corpus for CI, else the shared benchmark corpus."""
    if smoke:
        corpus = synthetic.generate(seed=0, n_docs=4000, n_queries=128,
                                    hidden=32, vocab_size=2048, n_topics=32)
        return corpus, dict(n_clusters=64, kmeans_iters=5,
                            index_kwargs=dict(k1_terms=8, pq_m=4, pq_k=64,
                                              cluster_capacity=192,
                                              term_capacity=96))
    kwargs = dict(common.COMMON_INDEX)
    kwargs.pop("codec")
    return common.corpus(), dict(n_clusters=common.N_CLUSTERS,
                                 kmeans_iters=10, index_kwargs=kwargs)


def run(smoke: bool = False, specs=None,
        device: dev_mod.DeviceLike = "cuda") -> list[dict]:
    """Sweep the registered codecs; ``smoke`` shrinks the corpus for CI."""
    dev = dev_mod.resolve(device)
    specs = list(specs) if specs else codecs.registered()
    corpus, kwargs = setting(smoke)
    return rows(corpus, build(corpus, specs=specs, device=dev, **kwargs),
                kc=common.KC, k2=common.K2, top_r=common.TOP_R, device=dev)


def check(rows: list[dict]) -> tuple[str, list[str]]:
    """The refine-over-pq contract: recall within ``RECALL_SLACK`` of
    flat at ≤ ``COST_RATIO``× the pq cost proxy.

    Rows are matched by *resolved* codec name, so parameterized sweeps
    (``--codecs flat pq refine:pq:8``) still check.  Returns
    ``(status, failures)``: status is ``"skipped"`` when the sweep
    lacks a flat/pq/refine-over-pq triple (a partial ``--codecs`` run,
    not a contract violation), else ``"checked"``.
    """
    def find(pred):
        return next((r for r in rows if pred(r["resolved"])), None)

    flat = find(lambda n: n == "flat")
    pq = find(lambda n: n == "pq")
    refine = find(lambda n: n.startswith("refine:pq"))
    if not (flat and pq and refine):
        return "skipped", []
    failures = []
    if refine["R@100"] < flat["R@100"] - RECALL_SLACK:
        failures.append(
            f"refine R@100 {refine['R@100']:.4f} < flat "
            f"{flat['R@100']:.4f} - {RECALL_SLACK}")
    if refine["candidate_cost"] > COST_RATIO * pq["candidate_cost"]:
        failures.append(
            f"refine cost {refine['candidate_cost']} > {COST_RATIO}x pq "
            f"cost {pq['candidate_cost']}")
    return "checked", failures


def report(rows: list[dict], smoke: bool) -> dict:
    """The ``BENCH_codec.json`` report of ``rows``."""
    status, failures = check(rows)
    return {"bench": "codec", "smoke": smoke, "rows": rows,
            "refine_contract": {"recall_slack": RECALL_SLACK,
                                "cost_ratio": COST_RATIO,
                                "status": status,
                                "failures": failures}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small corpus (CI scale)")
    ap.add_argument("--out", default=None,
                    help="write BENCH_codec.json here")
    ap.add_argument("--codecs", nargs="*", default=None,
                    help="codec specs to sweep (default: the registry)")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero if the refine contract fails")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)

    rep = report(run(smoke=args.smoke, specs=args.codecs,
                     device=args.device), args.smoke)
    text = json.dumps(rep, indent=2)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    if args.check:
        status = rep["refine_contract"]["status"]
        failures = rep["refine_contract"]["failures"]
        if status == "skipped":
            sys.exit("--check needs flat, pq and a refine:pq codec "
                     "in the sweep")
        if failures:
            sys.exit("; ".join(failures))


if __name__ == "__main__":
    main()

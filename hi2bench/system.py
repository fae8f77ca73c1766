"""The system under test: the port's ``HybridIndex`` assembled from the
harness's planes (the fields ``checkpoint.index_from_numpy`` fills, with
no round trip through the host), a ``Server`` over it at the
configuration's widths and ``serve`` settings, and the serving runtime
in front at the mix's ``runtime`` settings, warmed at the cell's
buckets.  Besides the codecs' ``index_params``, this is the only module
of the benchmark that imports the program."""
from __future__ import annotations

import torch

from hi2bench import spec
from repro_torch.core import hybrid_index as hi
from repro_torch.core.cluster_selector import ClusterSelector
from repro_torch.core.inverted_lists import PaddedLists
from repro_torch.core.term_selector import TermSelector
from repro_torch.launch import runtime as rt_mod
from repro_torch.launch import serve


def index(planes, extra: dict) -> hi.HybridIndex:
    docs = {"codes": planes.codes}
    if planes.refine_emb is not None:
        docs["refine_emb"] = planes.refine_emb
    return hi.HybridIndex(
        cluster_sel=ClusterSelector(planes.cluster_emb),
        term_sel=TermSelector(planes.avg_scores),
        cluster_lists=PaddedLists(planes.cluster_entries,
                                  extra["cluster_lengths"]),
        term_lists=PaddedLists(planes.term_entries, extra["term_lengths"]),
        codec_params=spec.codec(planes.base).index_params(planes.params),
        doc_planes=docs, doc_assign=extra["doc_assign"],
        sparse_weights=extra["sparse_weights"], codec=planes.codec)


def server(planes, extra: dict, cfg: dict, dev: torch.device,
           max_batch: int) -> serve.Server:
    return serve.Server(
        index(planes, extra),
        serve.ServeConfig(kc=cfg["kc"], k2=cfg["k2"], top_r=cfg["top_r"],
                          max_batch=max_batch, **cfg.get("serve", {})),
        device=dev)


def runtime(planes, extra: dict, cfg: dict, mix: dict,
            dev: torch.device) -> rt_mod.ServingRuntime:
    """A warmed runtime over a server of the planes: the cell's buckets
    captured (one CUDA graph each on the card), the scheduler started."""
    rt = rt_mod.ServingRuntime(
        server(planes, extra, cfg, dev, cfg["query_batch"]),
        rt_mod.RuntimeConfig(**mix["runtime"]))
    rt.warmup(cfg["hidden"], cfg["query_len"])
    return rt


def overloaded() -> type:
    """The runtime's admission-control rejection."""
    return rt_mod.RuntimeOverloaded

"""The benchmark's index planes and query pool, drawn on the device from
``--seed`` in a few large calls (the recipe of the port's
``benchmarks/synth_msmarco.py``, moved onto the card):

  · cluster embeddings N(0, 1), term scores s̄ ~ U[0.1, 1.1), uniform
    document → cluster assignment;
  · K₁ᵀ terms a document drawn from a Zipf(s) law over the vocabulary,
    with impacts ~ U[0.05, 1.05);
  · padded inverted lists bucketed by a device sort: a cluster list in
    document order, a term list by descending impact, each cut at its
    capacity (the port's ``inverted_lists._bucket``, the same planes);
  · the stage-1 codec's codes and parameter planes, by the codec's own
    file ``codecs/<codec>.py``;
  · fp16 rows ~ N(0, 1/h) where the codec is encoded from rows or the
    configuration refines (``refine:<codec>:<mult>`` keeps them), with
    each pool query's planted positive (a member of its best cluster)
    given the query as its row and codes;
  · the query pool: unit-norm embeddings and Zipf tokens.

Everything here is torch alone: the planes are the inputs that the
harness hands both the program and the reference.
"""
from __future__ import annotations

import hashlib
import math

import torch

from hi2bench import spec
from hi2bench.reference.hi2 import PAD, Planes

#: rows a block when fp16 rows are drawn
ROW_BLOCK = 1 << 18


def generator(seed: int, stream: int, dev: torch.device) -> torch.Generator:
    """An independent generator for each stream of one seed."""
    digest = hashlib.sha256(f"hi2bench:{seed}:{stream}".encode()).digest()
    return torch.Generator(device=dev).manual_seed(
        int.from_bytes(digest[:8], "little") >> 1)


def zipf(g: torch.Generator, n_items: int, s: float, shape, dev
         ) -> torch.Tensor:
    """Ids in [0, n_items) with P(i) ∝ 1/(i+1)^s, by inverse CDF."""
    w = torch.arange(1, n_items + 1, dtype=torch.float64, device=dev) ** -s
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(shape, generator=g, dtype=torch.float64, device=dev)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=n_items - 1)


def bucket(doc_ids: torch.Tensor, list_ids: torch.Tensor, scores,
           n_lists: int, cap: int):
    """Padded lists of (doc, list[, score]) postings: each list by
    descending score (input order when ``scores`` is None, and on ties),
    cut at ``cap``.  Returns (entries (n_lists, cap) i32, lengths i32,
    weights (n_lists, cap) f32)."""
    dev = doc_ids.device
    order = torch.arange(doc_ids.numel(), device=dev)
    if scores is not None:
        order = torch.sort(scores, descending=True, stable=True)[1]
    order = order[torch.sort(list_ids[order], stable=True)[1]]
    lid, did = list_ids[order], doc_ids[order]
    counts = torch.bincount(lid, minlength=n_lists)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(lid.numel(), device=dev) - starts[lid]
    keep = rank < cap
    entries = torch.full((n_lists, cap), PAD, dtype=torch.int32, device=dev)
    entries[lid[keep], rank[keep]] = did[keep].to(torch.int32)
    weights = torch.zeros((n_lists, cap), dtype=torch.float32, device=dev)
    if scores is not None:
        weights[lid[keep], rank[keep]] = scores[order][keep]
    return entries, counts.clamp(max=cap).to(torch.int32), weights


def queries(cfg: dict, seed: int, n: int, dev: torch.device):
    """The query pool: (n, h) unit-norm f32 embeddings and (n, len) i64
    Zipf tokens."""
    g = generator(seed, 1, dev)
    qe = torch.randn((n, cfg["hidden"]), generator=g, device=dev)
    qe /= qe.norm(dim=1, keepdim=True)
    qt = zipf(g, cfg["vocab"], cfg["zipf_s"], (n, cfg["query_len"]), dev)
    return qe, qt


def _planted(cluster_emb, cluster_entries, qe) -> torch.Tensor:
    """One member of each query's best cluster, a different one for
    queries that share it."""
    best = (qe @ cluster_emb.T).argmax(1)
    order = torch.sort(best, stable=True)[1]
    b = best[order]
    first = torch.ones_like(b, dtype=torch.bool)
    first[1:] = b[1:] != b[:-1]
    start = torch.cummax(torch.where(first, torch.arange(b.numel(),
                                                         device=b.device), 0),
                         0)[0]
    occ = torch.empty_like(order)
    occ[order] = torch.arange(b.numel(), device=b.device) - start
    if int(occ.max()) >= cluster_entries.shape[1]:
        raise RuntimeError("a best cluster has too few members to plant "
                           "every query's positive")
    docs = cluster_entries[best, occ].long()
    if bool((docs < 0).any()):
        raise RuntimeError("a best cluster has too few members to plant "
                           "every query's positive")
    return docs


def draw(cfg: dict, seed: int, dev: torch.device, pool: int):
    """(Planes, (qe, qt) query pool of ``pool`` rows, the other planes of
    an index: ``doc_assign``, ``cluster_lengths``, ``term_lengths`` and
    the impact plane ``sparse_weights`` aligned with the term lists)."""
    n, h, nl, v = (cfg[k] for k in ("n_docs", "hidden", "n_clusters",
                                    "vocab"))
    g = generator(seed, 0, dev)
    cluster_emb = torch.randn((nl, h), generator=g, device=dev)
    avg_scores = torch.rand((v,), generator=g, device=dev) + 0.1
    assign = torch.randint(0, nl, (n,), generator=g, device=dev)
    docs = torch.arange(n, device=dev)
    cl_entries, cl_lengths, _ = bucket(docs, assign, None, nl,
                                       cfg["cluster_capacity"])
    k1 = cfg["k1_terms"]
    terms = zipf(g, v, cfg["zipf_s"], (n * k1,), dev)
    impacts = torch.rand((n * k1,), generator=g, device=dev) + 0.05
    tm_entries, tm_lengths, weights = bucket(
        docs.repeat_interleave(k1), terms, impacts, v, cfg["term_capacity"])
    del terms, impacts, docs
    qe, qt = queries(cfg, seed, pool, dev)
    parts = cfg["codec"].split(":")
    refine = parts[0] == "refine"
    codec = spec.codec(parts[1] if refine else parts[0])
    rows = None
    if refine or codec.ROWS:
        g2 = generator(seed, 2, dev)
        rows = torch.empty((n, h), dtype=torch.float16, device=dev)
        for blk in rows.split(ROW_BLOCK):
            blk.copy_(torch.randn(blk.shape, generator=g2, device=dev)
                      / math.sqrt(h))
    codes, params = codec.draw(cfg, g, dev, n, rows)
    if rows is not None:
        at = _planted(cluster_emb, cl_entries, qe)
        rows[at] = qe.half()
        if codec.ROWS:
            codes[at] = codec.encode(params, qe.half())
    planes = Planes(codec=cfg["codec"], cluster_emb=cluster_emb,
                    avg_scores=avg_scores, cluster_entries=cl_entries,
                    term_entries=tm_entries, codes=codes, params=params,
                    refine_emb=rows if refine else None)
    extra = dict(doc_assign=assign.to(torch.int32), cluster_lengths=cl_lengths,
                 term_lengths=tm_lengths, sparse_weights=weights)
    return planes, (qe, qt), extra

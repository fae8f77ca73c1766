"""Single-device serving (port of ``repro/launch/serve.py``:
``ServeConfig``, ``resolve_widths``, ``Server``, ``make_server`` and the
``main`` demo loop).

:class:`Server` holds one index on one device and pads every request
batch to ``max_batch``, so each search runs at one shape.  The sharded,
2-D mesh, mutable and micro-batching layouts of the reference are not
yet ported: asking for them raises.

    python -m repro_torch.launch.serve --device cpu --codec refine:sq8

builds an index over the synthetic corpus and serves its queries, as
``python -m repro.launch.serve`` does; ``--device`` defaults to
``cuda``, and the device chooses the kernels (no ``--use-kernel``).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import device as dev_mod
from repro_torch.core import codecs
from repro_torch.core import hybrid_index as hi
from repro_torch.core.exec import filters as ns_filters

#: the hand-picked width defaults when no explicit width is set
DEFAULT_KC, DEFAULT_K2 = 6, 8


@dataclasses.dataclass
class ServeConfig:
    kc: Optional[int] = None     # None → DEFAULT_KC
    k2: Optional[int] = None     # None → DEFAULT_K2
    top_r: int = 100
    max_batch: int = 64
    n_namespaces: int = 0        # >0 → filtered search over N namespaces
    n_shards: int = 1            # >1: sharded layout, not yet ported
    data_parallel: int = 1       # >1: 2-D serving mesh, not yet ported
    mutable: bool = False        # mutable index, not yet ported


def resolve_widths(cfg: ServeConfig, index) -> tuple:
    """``(kc, k2, source)``: an explicit ``ServeConfig`` value wins,
    else the defaults.  (Tuned widths are not yet ported, and
    :func:`repro_torch.checkpoint.checkpoint.load_index` refuses an
    index that carries them.)"""
    if cfg.kc is not None or cfg.k2 is not None:
        return (int(cfg.kc if cfg.kc is not None else DEFAULT_KC),
                int(cfg.k2 if cfg.k2 is not None else DEFAULT_K2),
                "explicit")
    return DEFAULT_KC, DEFAULT_K2, "default"


class Server:
    """Pads request batches to ``max_batch`` and searches them on
    ``device``, where the index is moved once at construction."""

    def __init__(self, index: hi.HybridIndex,
                 cfg: Optional[ServeConfig] = None, *,
                 device: dev_mod.DeviceLike = "cuda"):
        cfg = ServeConfig() if cfg is None else cfg
        for field, default, what in (("n_shards", 1, "sharded serving"),
                                     ("data_parallel", 1, "mesh serving"),
                                     ("mutable", False, "mutable serving")):
            if getattr(cfg, field) != default:
                raise NotImplementedError(f"{what} ({field}=) is not yet "
                                          "ported to repro_torch")
        self.device = dev_mod.resolve(device)
        self.index = index.to(self.device)
        self.cfg = cfg
        self.kc, self.k2, self.width_source = resolve_widths(cfg, index)
        self.n_served = 0

    def _search(self, qe, qt, filter=None) -> hi.SearchResult:
        return hi.search(self.index, qe, qt, kc=self.kc, k2=self.k2,
                         top_r=self.cfg.top_r, filter=filter,
                         device=self.device)

    def warmup(self, hidden: int, query_len: int) -> None:
        """One full-batch search of PAD queries (builds the kernels)."""
        qe = torch.zeros((self.cfg.max_batch, hidden), device=self.device)
        qt = torch.full((self.cfg.max_batch, query_len), -1,
                        dtype=torch.int64, device=self.device)
        self._search(qe, qt)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _pad(self, query_emb, query_tokens):
        qe = dev_mod.as_tensor(query_emb, self.device, torch.float32)
        qt = dev_mod.as_tensor(query_tokens, self.device, torch.int64)
        n = qe.shape[0]
        pad = self.cfg.max_batch - n
        if pad < 0:
            raise ValueError(f"batch {n} exceeds max_batch "
                             f"{self.cfg.max_batch}")
        qe = torch.nn.functional.pad(qe, (0, 0, 0, pad))
        qt = torch.nn.functional.pad(qt, (0, 0, 0, pad), value=-1)
        return n, qe, qt

    def _filter(self, namespaces, n: int):
        """Per-query ``namespaces`` (one id or iterable per query) → the
        padded (max_batch, W) bitmap; padded rows match nothing."""
        if namespaces is None:
            return None
        if not self.cfg.n_namespaces:
            raise ValueError("this server was built without namespaces; "
                             "construct with ServeConfig(n_namespaces=N)")
        if len(namespaces) != n:
            raise ValueError(f"{len(namespaces)} filter rows for {n} "
                             "queries")
        bitmap = ns_filters.make_filter(namespaces, self.cfg.n_namespaces,
                                        device=self.device)
        return ns_filters.pad_filter(bitmap, self.cfg.max_batch)

    def query(self, query_emb, query_tokens,
              namespaces=None) -> hi.SearchResult:
        """Search ``n ≤ max_batch`` queries; results stay on the device."""
        n, qe, qt = self._pad(query_emb, query_tokens)
        res = self._search(qe, qt, filter=self._filter(namespaces, n))
        self.n_served += n
        return hi.SearchResult(doc_ids=res.doc_ids[:n],
                               scores=res.scores[:n],
                               n_candidates=res.n_candidates[:n],
                               partial=False)


def make_server(index: hi.HybridIndex, cfg: ServeConfig, *,
                device: dev_mod.DeviceLike = "cuda") -> Server:
    """The server for ``cfg``: the single-device :class:`Server` (other
    layouts raise "not yet ported")."""
    return Server(index, cfg, device=device)


#: reference flags whose layouts are not yet ported (flag → its default)
_UNPORTED_FLAGS = {"shards": 1, "data_parallel": 1, "mutable": False,
                   "runtime": False, "fusion_weight": None}


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description="HI² serving demo loop")
    ap.add_argument("--docs", type=int, default=8000)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--codec", default=codecs.DEFAULT,
                    metavar="|".join(codecs.registered()),
                    help="any registered codec spec, e.g. sq8 or refine:pq:4")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--kc", type=int, default=None,
                    help=f"clusters probed per query (default {DEFAULT_KC})")
    ap.add_argument("--k2", type=int, default=None,
                    help=f"term lists probed per query (default "
                         f"{DEFAULT_K2})")
    ap.add_argument("--namespaces", type=int, default=0,
                    help="partition the corpus into N namespaces and demo "
                         "per-query filtered search (DESIGN.md §9)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the hand-written kernels) or cpu "
                         "(their plain PyTorch versions)")
    for flag in ("--shards", "--data-parallel"):
        ap.add_argument(flag, type=int, default=1, help="not yet ported")
    for flag in ("--mutable", "--runtime"):
        ap.add_argument(flag, action="store_true", help="not yet ported")
    ap.add_argument("--fusion-weight", type=float, default=None,
                    help="not yet ported")
    args = ap.parse_args(argv)
    for field, default in _UNPORTED_FLAGS.items():
        if getattr(args, field) != default:
            raise NotImplementedError(
                f"--{field.replace('_', '-')} is not yet ported to "
                "repro_torch")
    codecs.get(args.codec)   # fail fast (with the registered names) on typos
    dev = dev_mod.resolve(args.device)

    from repro_torch.data import synthetic
    corpus = synthetic.generate(seed=0, n_docs=args.docs,
                                n_queries=args.queries,
                                hidden=64, vocab_size=4096)
    # round-robin tenant assignment for the demo corpus
    doc_ns = (np.arange(args.docs) % args.namespaces
              if args.namespaces else None)
    index = hi.build(0, corpus.doc_emb, corpus.doc_tokens,
                     corpus.vocab_size, n_clusters=128, k1_terms=10,
                     codec=args.codec, pq_m=8, pq_k=256,
                     cluster_capacity=192, term_capacity=96,
                     kmeans_iters=8, doc_namespaces=doc_ns, device=dev)
    server = make_server(index, ServeConfig(
        kc=args.kc, k2=args.k2, max_batch=args.batch,
        n_namespaces=args.namespaces), device=dev)
    server.warmup(64, corpus.query_tokens.shape[1])
    t0 = time.perf_counter()
    for i in range(0, args.queries, args.batch):
        server.query(corpus.query_emb[i:i + args.batch],
                     corpus.query_tokens[i:i + args.batch])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"served {server.n_served} queries in {dt:.3f}s "
          f"({server.n_served / dt:.0f} q/s, 1 device)")
    if args.namespaces:
        # each query restricted to one tenant; results must honor it
        b = min(args.batch, args.queries)
        want = [i % args.namespaces for i in range(b)]
        res = server.query(corpus.query_emb[:b], corpus.query_tokens[:b],
                           namespaces=want)
        ids = res.doc_ids.cpu().numpy()
        ok = all((ids[i][ids[i] >= 0] % args.namespaces == want[i]).all()
                 for i in range(b))
        print(f"filtered: {b} queries x 1/{args.namespaces} namespaces, "
              f"mean candidates "
              f"{float(res.n_candidates.float().mean()):.0f}, "
              f"tenant isolation {'OK' if ok else 'VIOLATED'}")
        if not ok:
            sys.exit("namespace filter violated tenant isolation")


if __name__ == "__main__":
    main()

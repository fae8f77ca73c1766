"""Single-device serving (port of ``repro/launch/serve.py``:
``ServeConfig``, ``resolve_widths``, ``Server``, ``make_server``).

:class:`Server` holds one index on one device and pads every request
batch to ``max_batch``, so each search runs at one shape.  The sharded,
2-D mesh, mutable and micro-batching layouts of the reference are not
yet ported: asking for them raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import device as dev_mod
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

"""The codec protocol (port of ``repro/core/codecs/base.py``: ``Codec``,
``RefineCtx``, ``gather_rows``, ``single_device_ctx``,
``plane_bytes_per_doc``).

A codec owns the document-representation-specific part of an index:
``params`` (codebooks, rotations, quantizer ranges; may be None) and
``doc_planes`` (a dict of per-document tensors).  The build trains and
encodes; search asks for a scorer over candidate rows, the stage-1
width R′ and the refine step:

    params = codec.train(generator, embeddings, pq_m=..., pq_k=...)
    planes = codec.encode(params, embeddings)
    scorer = codec.make_scorer(params, doc_planes, queries)
    scores = scorer(candidate_rows, live)    # -inf where not live
    top    = topk_by_score(..., codec.refine_width(top_r))
    top    = codec.refine(..., top_r, ctx)   # identity unless re-ranking

The sharding hooks split the doc planes over document shards
(``partition``) and place the params (``replicate``) for
:mod:`repro_torch.core.sharded_index`.  ``abstract`` gives the params
and planes of an index of a given size as uninitialized tensors, which
under the caller's ``FakeTensorMode`` allocate nothing: the dry run's
HI² cells (:mod:`repro_torch.launch.cells`).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch


def plane_bytes_per_doc(doc_planes: dict) -> int:
    """Per-document bytes of the doc planes (the device-memory ledger)."""
    return sum(math.prod(leaf.shape[1:]) * leaf.element_size()
               for leaf in doc_planes.values())


def gather_rows(plane: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row-gather a doc plane at candidate ids, tolerating PAD (-1):
    ids are clipped to row 0 and the caller masks those rows."""
    return plane[ids.clamp(min=0).long()]


def tree_map(fn: Callable, planes):
    """``fn`` over every tensor of a (possibly nested) plane dict, in a
    dict of the same structure (``None`` stays ``None``)."""
    if isinstance(planes, dict):
        return {k: tree_map(fn, v) for k, v in planes.items()}
    return None if planes is None else fn(planes)


class RefineCtx(NamedTuple):
    """Environment hooks for the refine stage: row gathers, which frontier
    ids this device owns, and the sum across shards (the identity on one
    device)."""
    gather: Callable[[Any, torch.Tensor], torch.Tensor]
    owned: Callable[[torch.Tensor], torch.Tensor]
    psum: Callable[[torch.Tensor], torch.Tensor]


def single_device_ctx() -> RefineCtx:
    return RefineCtx(gather=gather_rows, owned=lambda ids: ids >= 0,
                     psum=lambda x: x)


class Codec:
    """Base codec: train/encode/decode, the search-time hooks, identity
    refine by default."""

    name: str = "?"

    # --- build-time ------------------------------------------------------
    def train(self, generator: torch.Generator, embeddings: torch.Tensor,
              *, pq_m: int = 8, pq_k: int = 256) -> Any:
        """Fit codec parameters on the corpus (``None`` when the codec
        is parameter-free).  ``generator`` lives on the embeddings'
        device."""
        return None

    def encode(self, params: Any, embeddings: torch.Tensor) -> dict:
        """(n_docs, h) → the per-document ``doc_planes`` dict."""
        raise NotImplementedError

    def decode(self, params: Any, doc_planes: dict) -> torch.Tensor:
        """Reconstruct (n_docs, h) f32 embeddings — the numerics oracle
        of the round-trip tests; not on the search path."""
        raise NotImplementedError

    def abstract(self, n_docs: int, hidden: int, *, pq_m: int = 8,
                 pq_k: int = 256, device=None) -> tuple[Any, dict]:
        """(params, doc_planes) of ``n_docs`` documents at width
        ``hidden`` as ``torch.empty`` tensors on ``device`` (the default
        device when None), in the reference's shapes and dtypes."""
        raise NotImplementedError

    # --- search-time -----------------------------------------------------
    def make_scorer(self, params: Any, doc_planes: dict,
                    queries: torch.Tensor) -> Callable[..., torch.Tensor]:
        """Returns ``score(ids, live=None) -> (B, C) f32`` over candidate
        rows (PAD allowed), ``-inf`` on lanes that are not live;
        ``live=None`` means all lanes are live."""
        raise NotImplementedError

    def refine_width(self, top_r: int) -> int:
        """Stage-1 selection width R′ ≥ top_r; R′ = R without refine."""
        return top_r

    def refine(self, params: Any, doc_planes: dict, queries: torch.Tensor,
               scores: torch.Tensor, ids: torch.Tensor, top_r: int,
               ctx: RefineCtx) -> tuple[torch.Tensor, torch.Tensor]:
        """Re-rank the (B, R′) frontier down to (B, top_r); the identity,
        valid because ``refine_width`` is ``top_r`` here."""
        return scores, ids

    # --- sharding hooks --------------------------------------------------
    def partition(self, doc_planes: dict,
                  split: Callable[[Any], Any]) -> dict:
        """Apply the document split ((n_docs, ...) → (S, P, ...)) to every
        doc plane, nested dicts included; override to exclude or
        re-derive planes."""
        return tree_map(split, doc_planes)

    def replicate(self, params: Any) -> Any:
        """Params placement under sharding: replicated by default."""
        return params

    # --- accounting ------------------------------------------------------
    def bytes_per_doc(self, doc_planes: dict) -> int:
        return plane_bytes_per_doc(doc_planes)

    def candidate_cost(self, budget: int, top_r: int) -> int:
        """Per-query latency proxy: the candidate budget plus any refine
        work."""
        return budget

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r})"

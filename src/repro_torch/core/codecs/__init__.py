"""Codec registry (port of ``repro/core/codecs/__init__.py``).

``HybridIndex.codec`` stays a spec string resolved here:

    >>> codecs.get("opq")           # a registered base codec
    >>> codecs.get("refine:sq8:4")  # parameterized spec (factory args
    ...                             #   after the first ':')
    >>> codecs.registered()         # ['flat', 'opq', 'pq', 'refine', 'sq8']

An unknown name raises with the registered names listed.
"""
from __future__ import annotations

import functools
from typing import Callable

from repro_torch.core.codecs import base as base
from repro_torch.core.codecs import flat as _flat
from repro_torch.core.codecs import pq as _pq
from repro_torch.core.codecs import refine as _refine
from repro_torch.core.codecs import sq8 as _sq8
from repro_torch.core.codecs.base import (Codec, RefineCtx, gather_rows,
                                          plane_bytes_per_doc,
                                          single_device_ctx)

__all__ = ["Codec", "DEFAULT", "RefineCtx", "gather_rows", "get",
           "plane_bytes_per_doc", "register", "registered",
           "single_device_ctx"]

#: the default index setting (the paper's evaluation codec, §5.1)
DEFAULT = "opq"

_FACTORIES: dict[str, Callable[..., Codec]] = {}


def register(name: str, factory: Callable[..., Codec]) -> None:
    """Register a codec factory under ``name``; it receives the
    ``:``-separated options of the spec."""
    if name in _FACTORIES:
        raise ValueError(f"codec {name!r} already registered")
    _FACTORIES[name] = factory


def registered() -> list[str]:
    """Sorted registered codec names."""
    return sorted(_FACTORIES)


@functools.lru_cache(maxsize=None)
def get(spec: str) -> Codec:
    """Resolve a codec spec string (``name[:opt...]``)."""
    name, *opts = str(spec).split(":")
    if name not in _FACTORIES:
        raise ValueError(f"unknown codec {spec!r}; registered codecs: "
                         f"{', '.join(registered())}")
    return _FACTORIES[name](*opts)


def _make_refine(base_name: str = _refine.DEFAULT_BASE,
                 mult: str = str(_refine.DEFAULT_MULT)) -> Codec:
    try:
        mult = int(mult)
    except ValueError:
        raise ValueError(
            f"bad refine option {mult!r}: the spec grammar is "
            f"refine[:base[:mult]] with integer mult >= 1") from None
    return _refine.RefineCodec(get(base_name), mult)


register("flat", _flat.FlatCodec)
register("pq", _pq.PQCodec)
register("opq", _pq.OPQCodec)
register("sq8", _sq8.SQ8Codec)
register("refine", _make_refine)

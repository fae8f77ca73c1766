"""Codec registry (port of ``repro/core/codecs/__init__.py``).

``HybridIndex.codec`` stays a spec string resolved here.  Registered:
``flat``, ``pq`` and ``opq``; ``sq8`` and ``refine`` are known names
that raise "not yet ported" until their slices land.
"""
from __future__ import annotations

import functools
from typing import Callable

from repro_torch.core.codecs import base as base
from repro_torch.core.codecs import flat as _flat
from repro_torch.core.codecs import pq as _pq
from repro_torch.core.codecs.base import (Codec, RefineCtx, gather_rows,
                                          single_device_ctx)

__all__ = ["Codec", "DEFAULT", "RefineCtx", "gather_rows", "get",
           "register", "registered", "single_device_ctx"]

#: the default index setting (the paper's evaluation codec, §5.1)
DEFAULT = "opq"

#: reference codecs this port does not serve yet
NOT_YET_PORTED = ("refine", "sq8")

_FACTORIES: dict[str, Callable[..., Codec]] = {}


def register(name: str, factory: Callable[..., Codec]) -> None:
    """Register a codec factory under ``name``."""
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
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"codec {spec!r} is not yet ported to repro_torch; ported "
            f"codecs: {', '.join(registered())}")
    if name not in _FACTORIES:
        raise ValueError(f"unknown codec {spec!r}; registered codecs: "
                         f"{', '.join(registered())}")
    return _FACTORIES[name](*opts)


register("flat", _flat.FlatCodec)
register("pq", _pq.PQCodec)
register("opq", _pq.OPQCodec)

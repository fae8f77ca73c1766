"""Index checkpoints, read side (port of
``repro/checkpoint/checkpoint.py``: what ``restore_index`` reads).

A reference ``save_index`` directory holds ``manifest.json`` (leaf
paths, shapes, dtypes, ``extra.codec``) and ``arrays.npz`` (leaf i under
``leaf_i``).  The port maps leaves by their manifest path, so it needs
no JAX tree structure:

    .cluster_sel.embeddings            .term_sel.avg_scores
    .cluster_lists.entries / .lengths  .term_lists.entries / .lengths
    .codec_params...                   (by codec, see _codec_params)
    .doc_planes['<key>']               .doc_assign
    .doc_ns, .sparse_weights           (optional)

A ``refine:<base>:<mult>`` index carries its base codec's params and,
beside the base planes, ``.doc_planes['refine_emb']`` (fp16).
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from repro_torch import device as dev_mod
from repro_torch.core import codecs
from repro_torch.core.cluster_selector import ClusterSelector
from repro_torch.core.codecs.flat import FlatCodec
from repro_torch.core.codecs.pq import (OPQCodebook, OPQCodec, PQCodebook,
                                        PQCodec)
from repro_torch.core.codecs.sq8 import SQ8Codec
from repro_torch.core.hybrid_index import HybridIndex
from repro_torch.core.inverted_lists import PaddedLists
from repro_torch.core.term_selector import TermSelector

_PLANE = re.compile(r"^\.doc_planes\['([^']+)'\]$")


def _codec_params(codec_impl: codecs.Codec, leaf):
    """The params leaves of the codec that owns them: a refine codec's
    are its base codec's."""
    while hasattr(codec_impl, "base"):
        codec_impl = codec_impl.base
    if isinstance(codec_impl, FlatCodec):
        return None
    if isinstance(codec_impl, OPQCodec):
        return OPQCodebook(rotation=leaf(".codec_params.rotation"),
                           codebook=PQCodebook(
                               leaf(".codec_params.codebook.codewords")))
    if isinstance(codec_impl, PQCodec):
        return PQCodebook(leaf(".codec_params.codewords"))
    if isinstance(codec_impl, SQ8Codec):
        return {"lo": leaf(".codec_params['lo']"),
                "scale": leaf(".codec_params['scale']")}
    raise ValueError(f"no checkpoint layout for codec {codec_impl!r}")


def index_from_numpy(leaves: dict, codec: str,
                     device: dev_mod.DeviceLike = "cuda") -> HybridIndex:
    """Build a :class:`HybridIndex` on ``device`` from manifest leaf
    paths → numpy arrays (the layout of a reference ``save_index``)."""
    dev = dev_mod.resolve(device)
    codec_impl = codecs.get(codec)        # raises on unknown specs

    def leaf(path: str) -> torch.Tensor:
        if path not in leaves:
            raise KeyError(f"index leaf {path!r} missing (codec {codec!r})")
        return torch.from_numpy(np.ascontiguousarray(leaves[path])).to(dev)

    def optional(path: str):
        return leaf(path) if path in leaves else None

    planes = {m.group(1): leaf(p) for p in leaves
              if (m := _PLANE.match(p))}
    if not planes:
        raise KeyError("index has no .doc_planes leaves")
    return HybridIndex(
        cluster_sel=ClusterSelector(leaf(".cluster_sel.embeddings")),
        term_sel=TermSelector(leaf(".term_sel.avg_scores")),
        cluster_lists=PaddedLists(leaf(".cluster_lists.entries"),
                                  leaf(".cluster_lists.lengths")),
        term_lists=PaddedLists(leaf(".term_lists.entries"),
                               leaf(".term_lists.lengths")),
        codec_params=_codec_params(codec_impl, leaf),
        doc_planes=planes,
        doc_assign=leaf(".doc_assign"),
        doc_ns=optional(".doc_ns"),
        sparse_weights=optional(".sparse_weights"),
        codec=codec)


def load_index(path: str,
               device: dev_mod.DeviceLike = "cuda") -> HybridIndex:
    """Read a reference ``save_index`` checkpoint directory onto
    ``device``, checking the recorded codec spec."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    extra = manifest.get("extra", {})
    codec = extra.get("codec")
    if codec is None:
        raise ValueError(f"checkpoint at {path} records no codec: it was "
                         "not written by save_index")
    if extra.get("tuned") is not None:
        raise NotImplementedError(
            f"checkpoint at {path} carries tuned widths, which are not yet "
            "ported; serving it would use other widths than the reference")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        leaves = {leaf["path"]: z[f"leaf_{leaf['index']}"]
                  for leaf in manifest["leaves"]}
    return index_from_numpy(leaves, codec, device=device)

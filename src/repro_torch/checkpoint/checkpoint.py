"""Index checkpoints, read side (port of
``repro/checkpoint/checkpoint.py``: what ``restore_index`` and
``restore_mutable`` read).

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

A ``save_mutable`` directory (:func:`load_mutable`) holds the same index
leaves under a ``['base']`` prefix, the delta state under
``['delta']['cluster_entries']``, ``['delta']['planes']['codes']`` and so
on, ``['tombstones']``, the retained corpus under ``['corpus']`` and the
build key under ``['key']``; ``extra.mutable`` holds the counters.

HI²_sup parameters (``repro/core/distill.py::DistillParams``) map the
same way: ``.cluster_embeddings``, ``.term_mlp.{w1,b1,w2,b2}`` and the
encoder's pytree under ``.encoder['embed']['table']``,
``.encoder['layers']['attn']['wq']['w']`` (stacked, leading L axis) and
so on.  A checkpoint of the reference's training loop (``fit`` saves
``{"params": ..., "opt": ...}``) holds them under a ``['params']``
prefix; :func:`load_distill` reads one.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
from typing import Optional

import numpy as np
import torch

from repro_torch import device as dev_mod
from repro_torch.core import codecs
from repro_torch.core.cluster_selector import ClusterSelector
from repro_torch.core.codecs.flat import FlatCodec
from repro_torch.core.codecs.pq import (OPQCodebook, OPQCodec, PQCodebook,
                                        PQCodec)
from repro_torch.core.codecs.sq8 import SQ8Codec
from repro_torch.core.distill import DistillParams
from repro_torch.core.hybrid_index import HybridIndex
from repro_torch.core.inverted_lists import PaddedLists
from repro_torch.core.term_selector import TermMLP, TermSelector
from repro_torch.models.transformer import TransformerConfig

_PLANE = re.compile(r"^\.doc_planes\['([^']+)'\]$")
_KEY = re.compile(r"\.(\w+)|\['([^']*)'\]")
_PARAMS_PREFIX = "['params']"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


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
    return index_from_numpy(_read_leaves(path, manifest), codec,
                            device=device)


def _read_leaves(path: str, manifest: dict) -> dict:
    """Manifest leaf path → numpy array of one checkpoint directory."""
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {leaf["path"]: z[f"leaf_{leaf['index']}"]
                for leaf in manifest["leaves"]}


def _nest(leaves: dict) -> dict:
    """``['a']['b']`` leaf paths → nested dicts of numpy arrays."""
    out: dict = {}
    for path, arr in leaves.items():
        keys = [m.group(2) for m in _KEY.finditer(path)]
        if None in keys or "".join(f"['{k}']" for k in keys) != path:
            raise ValueError(f"unreadable leaf path {path!r}")
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return out


def load_mutable(path: str, *, seed: int, codec: Optional[str] = None,
                 selectors=None, device: dev_mod.DeviceLike = "cuda"):
    """Read a reference ``save_mutable`` checkpoint directory into a
    :class:`repro_torch.core.segments.MutableHybridIndex` on ``device``:
    base, delta planes, eviction scores, tombstones, the retained corpus
    and the counters, so it searches and mutates as the saved index.

    The reference's ``['key']`` leaf is JAX key data, which the port
    cannot replay: ``compact()`` on the loaded index rebuilds with
    ``seed`` (the port's builds are not the reference's draws anyway).
    Refuses a checkpoint without a ``mutable`` entry, one whose codec is
    not ``codec`` (when given: the reference's check against its restore
    target), and one written from a supervised index unless
    ``selectors=`` (a :class:`repro_torch.launch.train.SupSelectors`) is
    given."""
    from repro_torch.core import segments

    dev = dev_mod.resolve(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    extra = manifest.get("extra", {})
    if "mutable" not in extra:
        raise ValueError(
            f"checkpoint at {path} is not a mutable-index checkpoint (no "
            "'mutable' manifest entry); use load_index")
    saved = extra.get("codec")
    if saved is None:
        raise ValueError(f"checkpoint at {path} records no codec: it was "
                         "not written by save_mutable")
    if codec is not None and saved != codec:
        raise ValueError(
            f"checkpoint at {path} was built with codec {saved!r} but "
            f"{codec!r} was asked for")
    leaves = _read_leaves(path, manifest)
    prefix = "['base']"
    tree = _nest({p: a for p, a in leaves.items()
                  if not p.startswith(prefix) and p != "['key']"})
    tree["base"] = index_from_numpy(
        {p[len(prefix):]: a for p, a in leaves.items()
         if p.startswith(prefix)}, saved, device=dev)
    return segments.MutableHybridIndex.from_state(
        tree, extra, seed=seed, selectors=selectors)


# --------------------------------------------------------------------------
# HI²_sup parameters
# --------------------------------------------------------------------------

def enc_cfg_from_fields(fields: dict) -> TransformerConfig:
    """A :class:`TransformerConfig` from the reference config's fields
    (``dataclasses.asdict`` of it, or a JSON copy): dtypes may be given
    as names or as dtype objects whose ``__name__`` is the name."""
    out = dict(fields)
    for key in ("param_dtype", "compute_dtype"):
        if key in out:
            name = getattr(out[key], "__name__", None) or str(out[key])
            if name not in _DTYPES:
                raise ValueError(f"{key}={out[key]!r}: no torch dtype for "
                                 f"{name!r}")
            out[key] = _DTYPES[name]
    known = {f.name for f in dataclasses.fields(TransformerConfig)}
    unknown = sorted(set(out) - known)
    if unknown:
        raise ValueError(f"not TransformerConfig fields: {unknown}")
    return TransformerConfig(**out)


def _to_tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, order="C")).to(dev)   # own copy


def distill_params_from_numpy(leaves: dict, enc_cfg: TransformerConfig,
                              device: dev_mod.DeviceLike = "cuda"
                              ) -> DistillParams:
    """:class:`DistillParams` on ``device`` from the reference's leaf
    paths → numpy arrays of a ``DistillParams`` (``.cluster_embeddings``,
    ``.term_mlp.w1``, ``.encoder['layers']['mlp']['w_up']['w']``, ...),
    checked against ``enc_cfg``."""
    if enc_cfg.is_moe:
        raise NotImplementedError("MoE encoders (n_experts > 0) are not "
                                  "yet ported to repro_torch")
    dev = dev_mod.resolve(device)
    encoder: dict = {}
    top: dict = {}
    for path, arr in leaves.items():
        found = list(_KEY.finditer(path))
        if not found or "".join(m.group(0) for m in found) != path:
            raise ValueError(f"unreadable leaf path {path!r}")
        keys = [m.group(1) or m.group(2) for m in found]
        if keys[0] == "encoder":
            node = encoder
            for k in keys[1:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = _to_tensor(arr, dev)
        else:
            top[".".join(keys)] = _to_tensor(arr, dev)
    need = ["cluster_embeddings"] + [f"term_mlp.{k}" for k in TermMLP._fields]
    missing = [k for k in need if k not in top]
    if missing or not encoder:
        raise KeyError(f"DistillParams leaves missing: "
                       f"{missing + ([] if encoder else ['encoder'])}")
    for keys, want in (
            (("embed", "table"), (enc_cfg.vocab_size, enc_cfg.d_model)),
            (("layers", "attn", "wq", "w"),
             (enc_cfg.n_layers, enc_cfg.d_model,
              enc_cfg.n_heads * enc_cfg.head_dim))):
        node = encoder
        for k in keys:
            node = node.get(k, {}) if isinstance(node, dict) else {}
        got = None if isinstance(node, dict) else tuple(node.shape)
        if got != want:
            raise ValueError(f"encoder leaf {'/'.join(keys)} has shape "
                             f"{got}, enc_cfg needs {want}")
    return DistillParams(
        cluster_embeddings=top["cluster_embeddings"],
        term_mlp=TermMLP(*(top[f"term_mlp.{k}"] for k in TermMLP._fields)),
        encoder=encoder)


def load_distill(path: str, enc_cfg: TransformerConfig,
                 device: dev_mod.DeviceLike = "cuda") -> DistillParams:
    """Read :class:`DistillParams` from a directory the reference's
    ``checkpoint.save`` wrote: the parameters of a ``fit`` checkpoint
    (``{"params", "opt"}``, read from under ``['params']``) or a bare
    ``DistillParams`` tree.  ``path`` may also be the directory of a
    ``CheckpointManager`` (``fit(ckpt_dir=...)``): its newest
    ``step_*`` is read."""
    if not os.path.exists(os.path.join(path, "manifest.json")):
        steps = sorted(glob.glob(os.path.join(path, "step_*", "manifest.json")))
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {path}")
        path = os.path.dirname(steps[-1])
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        leaves = {leaf["path"]: z[f"leaf_{leaf['index']}"]
                  for leaf in manifest["leaves"]}
    if any(p.startswith(_PARAMS_PREFIX) for p in leaves):
        leaves = {p[len(_PARAMS_PREFIX):]: a for p, a in leaves.items()
                  if p.startswith(_PARAMS_PREFIX)}
    return distill_params_from_numpy(leaves, enc_cfg, device=device)

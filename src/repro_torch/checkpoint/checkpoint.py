"""Index checkpoints (port of ``repro/checkpoint/checkpoint.py``:
``save``, ``load_manifest``, ``restore``, ``save_index``,
``restore_index``, ``save_mutable``, ``restore_mutable`` (and its read
side by path alone, :func:`load_mutable`) and ``restore_resharded``, the
elastic restore onto a mesh's devices).

A ``save_index`` directory holds ``manifest.json`` (leaf paths, shapes,
dtypes, ``extra.codec``, ``extra.filtered`` and, on a tuned index,
``extra.tuned``) and ``arrays.npz`` (leaf i under ``leaf_i``).  Writes
are atomic: everything goes into ``<dir>/.tmp_step_X``, which
``os.replace`` moves into place.  The port writes the reference's leaf
paths in the order ``jax.tree_util.tree_flatten_with_path`` gives for
the reference's structures (dataclass and NamedTuple fields in their
declared order, dict keys sorted, ``None`` dropped;
:func:`repro_torch.core.hybrid_index.index_leaves`),
because the reference's ``restore`` matches leaves by index.  Reading,
the port maps leaves by their manifest path, so it needs no JAX tree
structure:

    .cluster_sel.embeddings            .term_sel.avg_scores
    .cluster_lists.entries / .lengths  .term_lists.entries / .lengths
    .codec_params...                   (by codec, see _codec_params)
    .doc_planes['<key>']               .doc_assign
    .doc_ns, .sparse_weights           (optional)

A ``refine:<base>:<mult>`` index carries its base codec's params and,
beside the base planes, ``.doc_planes['refine_emb']`` (fp16).

A :class:`repro_torch.core.sharded_index.ShardedHybridIndex` is written
as the reference writes its own (its ``data_fields`` order):
``.cluster_sel.embeddings``, ``.term_sel.avg_scores``,
``.cluster_entries``, ``.cluster_lengths``, ``.term_entries``,
``.term_lengths``, ``.codec_params...``, ``.doc_planes['<key>']``,
``.doc_assign`` and the optional ``.doc_ns``, ``.sparse_weights``, each
plane with its leading shard axis; :func:`restore_index` reads one into
a template (``sharded_index.to_meta``) on the host.

A ``save_mutable`` directory (:func:`load_mutable`) holds the same index
leaves under a ``['base']`` prefix, the delta state under
``['delta']['cluster_entries']``, ``['delta']['planes']['codes']`` and so
on, ``['tombstones']``, the retained corpus under ``['corpus']`` and the
build key under ``['key']``; ``extra.mutable`` holds the counters.  The
port writes its seed s there as ``[0, s]`` (uint32), the key data of the
reference's ``jax.random.key(s)``.

HI²_sup parameters (``repro/core/distill.py::DistillParams``) map the
same way: ``.cluster_embeddings``, ``.term_mlp.{w1,b1,w2,b2}`` and the
encoder's pytree under ``.encoder['embed']['table']``,
``.encoder['layers']['attn']['wq']['w']`` (stacked, leading L axis) and
so on.  A checkpoint of the reference's training loop (``fit`` saves
``{"params": ..., "opt": ...}``) holds them under a ``['params']``
prefix; :func:`load_distill` reads one.

Recsys parameters (``repro/models/recsys.py``) map by the reference's
``jax.tree_util.keystr`` paths, ``['tables']``, ``['bot'][0]['w']``,
``['blocks']['attn']['wq']['w']`` (stacked, leading ``n_blocks`` axis),
``['item_embed']['table']`` and so on: :func:`recsys_params_from_numpy`
nests them back into the port's dicts and lists.  GatedGCN's
(``repro/models/gnn.py``) the same way, ``['embed_h']['w']``,
``['embed_e']['const']``, ``['layers']['E1']['w']`` (stacked, leading
``n_layers`` axis), ``['head']['w']``: :func:`gnn_params_from_numpy`
takes exactly those leaves.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import shutil
from typing import Optional

import numpy as np
import torch

from repro_torch import device as dev_mod
from repro_torch import tree as tree_mod
from repro_torch.core import codecs
from repro_torch.core.cluster_selector import ClusterSelector
from repro_torch.core.codecs.flat import FlatCodec
from repro_torch.core.codecs.pq import (OPQCodebook, OPQCodec, PQCodebook,
                                        PQCodec)
from repro_torch.core.codecs.sq8 import SQ8Codec
from repro_torch.core.distill import DistillParams
from repro_torch.core import hybrid_index as hi
from repro_torch.core.exec import frontier
from repro_torch.core.hybrid_index import HybridIndex
from repro_torch.core.inverted_lists import PaddedLists
from repro_torch.core.term_selector import TermMLP, TermSelector
from repro_torch.distributed import collectives
from repro_torch.models.transformer import TransformerConfig

_PATH = re.compile(r"\['([^']*)'\]|\[(\d+)\]")
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


def _attach_tuned(index, extra: dict):
    """The index with the manifest's tuned-width record, when it has one
    and the index has the field (a malformed record raises)."""
    tuned = extra.get("tuned")
    if tuned is None or not hasattr(index, "tuned"):
        return index
    return dataclasses.replace(index, tuned=frontier.from_json(tuned))


def load_index(path: str,
               device: dev_mod.DeviceLike = "cuda") -> HybridIndex:
    """Read a ``save_index`` checkpoint directory (the reference's or
    the port's) onto ``device``, checking the recorded codec spec and
    attaching the tuned widths it records."""
    manifest = load_manifest(path)
    extra = manifest.get("extra", {})
    codec = extra.get("codec")
    if codec is None:
        raise ValueError(f"checkpoint at {path} records no codec: it was "
                         "not written by save_index")
    index = index_from_numpy(_read_leaves(path, manifest), codec,
                             device=device)
    return _attach_tuned(index, extra)


# --------------------------------------------------------------------------
# the write half: save, save_index, save_mutable; restore by leaf index
# --------------------------------------------------------------------------

def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(directory: str, step: int, tree, extra: Optional[dict] = None
         ) -> str:
    """Atomically write one checkpoint of ``tree`` (leaves copied to the
    host) under ``directory/step_XXXXXXXX``; returns its final path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = os.path.join(directory, f".tmp_step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    leaves = [(p, _host(leaf)) for p, leaf in hi.index_leaves(tree)]
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": a for i, (_, a) in enumerate(leaves)})
    manifest = {
        "step": step,
        # the reference records str(treedef), a JAX structure the port
        # does not have; no reader parses it
        "treedef": f"{type(tree).__name__} with {len(leaves)} leaves",
        "leaves": [{"path": p, "index": i, "shape": list(a.shape),
                    "dtype": str(a.dtype)}
                   for i, (p, a) in enumerate(leaves)],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def load_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _read_by_index(path: str, like) -> list:
    """The checkpoint's arrays in leaf-index order, checked against the
    leaves of ``like`` (count and shapes), as the reference's
    ``restore`` checks them."""
    manifest = load_manifest(path)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = [z[f"leaf_{i}"] for i in range(len(manifest["leaves"]))]
    flat = hi.index_leaves(like)
    if len(flat) != len(arrays):
        raise ValueError(f"leaf count mismatch: checkpoint has "
                         f"{len(arrays)}, target has {len(flat)}")
    for a, (_, leaf) in zip(arrays, flat):
        if tuple(a.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch {a.shape} vs "
                             f"{tuple(leaf.shape)}")
    return arrays


def _rebuild(like, arrays: list):
    """``like`` with its leaves replaced, in ``index_leaves`` order, by
    ``arrays`` (consumed from the front): a tensor leaf becomes a tensor
    on its device (a shape-only ``meta`` leaf: on the host), a numpy leaf
    a numpy array."""
    if isinstance(like, torch.Tensor):
        return _to_tensor(arrays.pop(0), torch.device("cpu") if like.is_meta
                          else like.device)
    if isinstance(like, np.ndarray):
        return np.array(arrays.pop(0))
    if dataclasses.is_dataclass(like):
        new = {f.name: _rebuild(getattr(like, f.name), arrays)
               for f in dataclasses.fields(like)}
        if "max_postings" in new:
            new["max_postings"] = None     # counted again from the lists
        if "placement" in new:
            new["placement"] = None        # the restored planes are new
        return dataclasses.replace(like, **new)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, k), arrays)
                            for k in like._fields))
    if isinstance(like, dict):
        return {k: _rebuild(like[k], arrays) for k in sorted(like)}
    if isinstance(like, list):
        return [_rebuild(x, arrays) for x in like]
    return like


def restore(path: str, like):
    """Restore into the structure of ``like`` by leaf index (shapes
    validated), as the reference's ``restore``: tensors land on the
    device of the leaf they replace."""
    return _rebuild(like, _read_by_index(path, like))


def _place(node, where):
    """``node`` (a tree of tensors) under the placement tree ``where``:
    ``None`` leaves a subtree where it is, a device moves its tensors
    there, a :class:`~repro_torch.distributed.collectives.Split` turns
    each tensor into {coord: block on that position's device}; a dict,
    list or NamedTuple places each field under its own placement."""
    if where is None:
        return node
    if isinstance(where, collectives.Split):
        return tree_mod.map(where.place, node)
    if isinstance(where, torch.device):
        return tree_mod.map(lambda t: t.to(where), node)
    if isinstance(where, tuple) and hasattr(where, "_fields"):
        return type(node)(*(_place(getattr(node, k), getattr(where, k))
                            for k in node._fields))
    if isinstance(where, dict):
        return {k: _place(node[k], where[k]) for k in node}
    if isinstance(where, list):
        return [_place(x, w) for x, w in zip(node, where, strict=True)]
    raise TypeError(f"not a placement: {where!r}")


def restore_resharded(path: str, like, placements):
    """Restore and place each leaf under ``placements`` (a tree shaped
    like ``like``, or a prefix of it): ``None``, a device, or a
    :class:`~repro_torch.distributed.collectives.Split` of dim 0 over
    mesh axes, which gives {coord: block} with every block on its
    position's device.  The elastic path: a checkpoint saved under one
    device count restores under another.  Stands in for the reference's
    ``device_put`` under ``NamedSharding``s."""
    return _place(restore(path, like), placements)


def save_index(directory: str, step: int, index,
               extra: Optional[dict] = None) -> str:
    """Checkpoint a built index (a :class:`HybridIndex` or a
    ``ShardedHybridIndex``, whose placed blocks are stacked on the host
    first), recording its codec spec, whether it is filtered, and its
    tuned widths (DESIGN.md §7, §9, §14) in the manifest as the
    reference does."""
    from repro_torch.core import sharded_index as shi
    if isinstance(index, shi.ShardedHybridIndex):
        index = shi.to_host(index)
    extra = dict(extra or {})
    extra["codec"] = index.codec
    extra["filtered"] = index.doc_ns is not None
    tuned = getattr(index, "tuned", None)
    if tuned is not None:
        extra["tuned"] = frontier.to_json(tuned)
    return save(directory, step, index, extra=extra)


def restore_index(path: str, like):
    """Restore an index checkpoint into the structure of ``like`` (leaves
    by index, on ``like``'s device; a sharded template's ``meta`` leaves
    on the host), checking the recorded codec spec when one was saved
    and attaching the tuned widths it records to a target that has the
    field."""
    extra = load_manifest(path).get("extra", {})
    saved = extra.get("codec")
    if saved is not None and saved != like.codec:
        raise ValueError(
            f"checkpoint at {path} was built with codec {saved!r} but "
            f"the restore target uses {like.codec!r}; rebuild the "
            f"target index with codec={saved!r}")
    return _attach_tuned(restore(path, like), extra)


def key_data(seed: int) -> np.ndarray:
    """The reference's ``jax.random.key_data(jax.random.key(seed))``
    (threefry): ``[0, seed]`` as uint32."""
    return np.array([0, seed], np.uint32)


def save_mutable(directory: str, step: int, mut,
                 extra: Optional[dict] = None) -> str:
    """Checkpoint a :class:`repro_torch.core.segments.MutableHybridIndex`
    in the reference's layout (base index, delta segment, tombstones,
    the retained corpus and the build key, with the codec spec and the
    counters in the manifest), so the reference's ``restore_mutable``
    and :func:`load_mutable` both read it."""
    extra = dict(extra or {})
    extra["codec"] = mut.base.codec
    extra["mutable"] = mut.state_extra()
    tree = dict(mut.state_tree(), key=key_data(mut.seed))
    return save(directory, step, tree, extra=extra)


def restore_mutable(path: str, like):
    """Restore a mutable-index checkpoint (the reference's or the
    port's) into a fresh instance shaped like ``like`` (same corpus,
    delta and list shapes, leaf for leaf), on ``like``'s device with its
    selectors, refusing a codec other than ``like``'s and a checkpoint
    with no ``mutable`` entry with the reference's messages.  The
    restored index searches and mutates as the saved one; ``compact()``
    replays the seed the port recorded, else ``like``'s."""
    manifest = load_manifest(path)
    extra = manifest.get("extra", {})
    saved = extra.get("codec")
    if saved is not None and saved != like.base.codec:
        raise ValueError(
            f"checkpoint at {path} was built with codec {saved!r} but "
            f"the restore target uses {like.base.codec!r}")
    if "mutable" not in extra:
        raise ValueError(
            f"checkpoint at {path} is not a mutable-index checkpoint "
            "(no 'mutable' manifest entry); use restore_index")
    want = hi.index_leaves(dict(like.state_tree(), key=key_data(like.seed)))
    got = manifest["leaves"]
    if len(got) != len(want):
        raise ValueError(f"leaf count mismatch: checkpoint has {len(got)}, "
                         f"target has {len(want)}")
    for g, (p, leaf) in zip(got, want):
        if tuple(g["shape"]) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch at {p}: {tuple(g['shape'])} "
                             f"vs {tuple(leaf.shape)}")
    return load_mutable(path, seed=int(extra["mutable"].get("seed",
                                                            like.seed)),
                        codec=like.base.codec, selectors=like.selectors,
                        device=like.device)


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
    manifest = load_manifest(path)
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


def _lm_shapes(cfg: TransformerConfig) -> dict:
    """Every leaf path of the reference's ``transformer.init`` → its
    shape, the layers stacked on a leading L axis: the SwiGLU's ``mlp``
    leaves of a dense config, or an MoE config's ``moe`` leaves (the
    router (d, E), ``w_gate`` / ``w_up`` (E, d, f), ``w_down``
    (E, f, d))."""
    n, d, f, e = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    dq, dkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    want = {"['embed']['table']": (cfg.vocab_size, d),
            "['final_norm']['scale']": (d,),
            "['unembed']['w']": (d, cfg.vocab_size)}
    ffn = ((("['moe']['router']['w']", (d, e)),
            ("['moe']['w_gate']", (e, d, f)),
            ("['moe']['w_up']", (e, d, f)),
            ("['moe']['w_down']", (e, f, d))) if cfg.is_moe else
           (("['mlp']['w_gate']['w']", (d, f)),
            ("['mlp']['w_up']['w']", (d, f)),
            ("['mlp']['w_down']['w']", (f, d))))
    for key, shape in (("['attn_norm']['scale']", (d,)),
                       ("['mlp_norm']['scale']", (d,)),
                       ("['attn']['wq']['w']", (d, dq)),
                       ("['attn']['wk']['w']", (d, dkv)),
                       ("['attn']['wv']['w']", (d, dkv)),
                       ("['attn']['wo']['w']", (dq, d))) + ffn:
        want["['layers']" + key] = (n,) + shape
    return want


def _tree_from_leaves(leaves: dict, want: dict, what: str,
                      dev: torch.device) -> dict:
    """A dict tree on ``dev`` from ``keystr`` leaf paths → numpy arrays
    that are exactly ``want``'s paths, each of the shape ``want`` gives
    it."""
    if sorted(leaves) != sorted(want):
        raise KeyError(f"{what} parameters have leaves {sorted(leaves)}, "
                       f"need {sorted(want)}")
    root: dict = {}
    for path, arr in leaves.items():
        if tuple(np.shape(arr)) != want[path]:
            raise ValueError(f"{what} leaf {path} has shape "
                             f"{tuple(np.shape(arr))}, cfg needs "
                             f"{want[path]}")
        keys = [m.group(1) for m in _PATH.finditer(path)]
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _to_tensor(arr, dev)
    return root


def lm_params_from_numpy(leaves: dict, cfg: TransformerConfig,
                         device: dev_mod.DeviceLike = "cuda") -> dict:
    """The port's transformer parameter tree on ``device`` from the
    reference's ``transformer.init`` leaf paths (``keystr``) → numpy
    arrays, checked against ``cfg``: exactly the reference's leaves of
    that config (dense or MoE), the layers stacked on a leading L axis,
    each of the shape ``cfg`` gives it."""
    dev = dev_mod.resolve(device)
    return _tree_from_leaves(leaves, _lm_shapes(cfg), "transformer", dev)


def distill_params_from_numpy(leaves: dict, enc_cfg: TransformerConfig,
                              device: dev_mod.DeviceLike = "cuda"
                              ) -> DistillParams:
    """:class:`DistillParams` on ``device`` from the reference's leaf
    paths → numpy arrays of a ``DistillParams`` (``.cluster_embeddings``,
    ``.term_mlp.w1``, ``.encoder['layers']['mlp']['w_up']['w']``, ...),
    the encoder checked against ``enc_cfg`` as
    :func:`lm_params_from_numpy` checks a transformer."""
    dev = dev_mod.resolve(device)
    encoder: dict = {}
    top: dict = {}
    for path, arr in leaves.items():
        found = list(_KEY.finditer(path))
        if not found or "".join(m.group(0) for m in found) != path:
            raise ValueError(f"unreadable leaf path {path!r}")
        if found[0].group(1) == "encoder":
            encoder[path[len(found[0].group(0)):]] = arr
        else:
            top[".".join(m.group(1) or m.group(2) for m in found)] = arr
    need = ["cluster_embeddings"] + [f"term_mlp.{k}" for k in TermMLP._fields]
    missing = [k for k in need if k not in top]
    if missing or not encoder:
        raise KeyError(f"DistillParams leaves missing: "
                       f"{missing + ([] if encoder else ['encoder'])}")
    return DistillParams(
        cluster_embeddings=_to_tensor(top["cluster_embeddings"], dev),
        term_mlp=TermMLP(*(_to_tensor(top[f"term_mlp.{k}"], dev)
                           for k in TermMLP._fields)),
        encoder=_tree_from_leaves(encoder, _lm_shapes(enc_cfg), "encoder",
                                  dev))


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
    leaves = _read_leaves(path, load_manifest(path))
    if any(p.startswith(_PARAMS_PREFIX) for p in leaves):
        leaves = {p[len(_PARAMS_PREFIX):]: a for p, a in leaves.items()
                  if p.startswith(_PARAMS_PREFIX)}
    return distill_params_from_numpy(leaves, enc_cfg, device=device)


# --------------------------------------------------------------------------
# recsys parameters
# --------------------------------------------------------------------------

def _lists(node):
    """Dicts keyed 0 .. n-1 (a path's list indices) back into lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        if sorted(out) != list(range(len(out))):
            raise ValueError(f"list indices {sorted(out)} are not 0..n-1")
        return [out[i] for i in range(len(out))]
    return out


def _recsys_shapes(arch_id: str, cfg) -> dict:
    """Top-level keys → the shapes of the leaves that size them."""
    if arch_id == "dlrm-rm2":
        f = cfg.n_sparse + 1
        return {"tables": (cfg.n_sparse, cfg.n_rows, cfg.embed_dim),
                "bot": [(a, b) for a, b in zip(cfg.bot_mlp, cfg.bot_mlp[1:])],
                "top": [(a, b) for a, b in zip(
                    (f * (f - 1) // 2 + cfg.bot_mlp[-1],)
                    + tuple(cfg.top_mlp_hidden), cfg.top_mlp_hidden)]}
    if arch_id == "sasrec":
        d = cfg.embed_dim
        return {"item_embed": (cfg.n_items, d), "pos_embed": (cfg.seq_len, d),
                "blocks": (cfg.n_blocks, d, d), "final_norm": (d,)}
    if arch_id == "dien":
        d_in, h = 2 * cfg.embed_dim, cfg.gru_dim
        dims = (h + d_in,) + tuple(cfg.mlp_hidden) + (1,)
        return {"item_embed": (cfg.n_items, cfg.embed_dim),
                "cat_embed": (max(cfg.n_items // 100, 16), cfg.embed_dim),
                "gru1": (d_in + h, h), "augru": (2 * h, h),
                "top": list(zip(dims, dims[1:]))}
    if arch_id == "mind":
        return {"item_embed": (cfg.n_items, cfg.embed_dim),
                "bilinear": (cfg.embed_dim, cfg.embed_dim)}
    raise ValueError(f"{arch_id!r} is not a ported recsys arch (dlrm-rm2, "
                     "sasrec, dien, mind)")


def _sizing_leaf(key: str, node):
    """The leaf whose shape :func:`_recsys_shapes` gives for ``key``."""
    if isinstance(node, list):
        return [p["w"] for p in node]
    return {"item_embed": lambda n: n["table"],
            "pos_embed": lambda n: n["table"],
            "cat_embed": lambda n: n["table"],
            "blocks": lambda n: n["attn"]["wq"]["w"],
            "final_norm": lambda n: n["scale"],
            "gru1": lambda n: n["wz"], "augru": lambda n: n["wz"],
            "bilinear": lambda n: n["w"],
            "tables": lambda n: n}[key](node)


def recsys_params_from_numpy(arch_id: str, leaves: dict, cfg,
                             device: dev_mod.DeviceLike = "cuda") -> dict:
    """The port's parameter tree of recsys arch ``arch_id`` (``dlrm-rm2``,
    ``sasrec``, ``dien``, ``mind``) on ``device`` from the reference's
    ``keystr`` leaf paths → numpy arrays, checked against ``cfg``: the
    top-level keys, the MLP depths and the leaves that size each part."""
    dev = dev_mod.resolve(device)
    want = _recsys_shapes(arch_id, cfg)
    root: dict = {}
    for path, arr in leaves.items():
        found = list(_PATH.finditer(path))
        if not found or "".join(m.group(0) for m in found) != path:
            raise ValueError(f"unreadable leaf path {path!r}")
        keys = [m.group(1) if m.group(1) is not None else int(m.group(2))
                for m in found]
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _to_tensor(arr, dev)
    params = _lists(root)
    if sorted(params) != sorted(want):
        raise KeyError(f"{arch_id} parameters have keys {sorted(params)}, "
                       f"need {sorted(want)}")
    for key, shape in want.items():
        try:
            got = _sizing_leaf(key, params[key])
            got = ([tuple(t.shape) for t in got] if isinstance(got, list)
                   else tuple(got.shape))
        except (KeyError, TypeError) as err:
            raise KeyError(f"{arch_id} leaf {key!r} malformed: {err}") from err
        if got != shape:
            raise ValueError(f"{arch_id} leaf {key!r} has shape {got}, "
                             f"cfg needs {shape}")
    return params


# --------------------------------------------------------------------------
# GNN parameters
# --------------------------------------------------------------------------

def _gnn_shapes(cfg) -> dict:
    """Every leaf path of the reference's ``gnn.init`` → its shape."""
    d, n = cfg.d_hidden, cfg.n_layers
    want = {"['embed_h']['w']": (cfg.d_feat, d),
            "['head']['w']": (d, cfg.n_classes)}
    if cfg.d_edge_feat > 0:
        want["['embed_e']['w']"] = (cfg.d_edge_feat, d)
    else:
        want["['embed_e']['const']"] = (d,)
    for k in ("E1", "E2", "E3", "B1", "B2"):
        want[f"['layers']['{k}']['w']"] = (n, d, d)
    for k in ("norm_h", "norm_e"):
        for leaf in ("scale", "bias"):
            want[f"['layers']['{k}']['{leaf}']"] = (n, d)
    return want


def gnn_params_from_numpy(leaves: dict, cfg,
                          device: dev_mod.DeviceLike = "cuda") -> dict:
    """The port's GatedGCN parameter tree on ``device`` from the
    reference's ``keystr`` leaf paths → numpy arrays, checked against
    ``cfg`` (a ``GatedGCNConfig``): exactly the reference's leaves, the
    layers stacked on a leading ``n_layers`` axis, each of the shape
    ``cfg`` gives it."""
    dev = dev_mod.resolve(device)
    return _tree_from_leaves(leaves, _gnn_shapes(cfg), "GatedGCN", dev)

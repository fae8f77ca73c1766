"""Trees of tensors (no reference counterpart: the JAX package walks its
pytrees with ``jax.tree``).

The one place that knows the reference's leaf order:
:func:`leaves_with_paths` gives the order and the paths
``jax.tree_util.tree_flatten_with_path`` gives for the reference's
structures (dataclass and NamedTuple fields as declared, dict values by
sorted key, list items in order), so a sum over the leaves adds them in
the reference's order and a checkpoint holds them at the reference's
leaf indices.  :func:`leaves`, :func:`unflatten`, :func:`map` and
:func:`to` work on trees of tensors in dataclasses, NamedTuples, dicts
and lists, and rebuild each node as its own type; a field that holds no
array (a graph batch's ``n_graphs``) stays as it is.  :func:`stack`
and :func:`index` lay layers out as the reference's ``vmap`` of an init
and read one back as its ``lax.scan`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(obj, path: str = "") -> list:
    """(path, leaf) of every tensor or numpy array in a tree of
    dataclasses, NamedTuples, dicts and lists: the leaves two builds are
    compared by, and the leaves a checkpoint holds.  Fields in declared
    order (``.name``), dict values by sorted key (``['key']``), list
    items in order (``[i]``: an MLP's layers); ``None``
    and metadata that is not an array (a codec spec, a tuned record)
    hold no leaf."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return [(path, obj)]
    if dataclasses.is_dataclass(obj):
        return [leaf for f in dataclasses.fields(obj) for leaf in
                leaves_with_paths(getattr(obj, f.name), f"{path}.{f.name}")]
    if _is_namedtuple(obj):
        return [leaf for k in obj._fields
                for leaf in leaves_with_paths(getattr(obj, k), f"{path}.{k}")]
    if isinstance(obj, dict):
        return [leaf for k in sorted(obj)
                for leaf in leaves_with_paths(obj[k], f"{path}[{k!r}]")]
    if isinstance(obj, list):
        return [leaf for i, x in enumerate(obj)
                for leaf in leaves_with_paths(x, f"{path}[{i}]")]
    return []


def leaves(tree) -> list:
    """The tensors of a parameter tree in the reference's leaf order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, new: list):
    """``like`` with its leaves replaced, in :func:`leaves` order, by the
    items of ``new``; what holds no leaf stays as it is."""
    it = iter(new)

    def rebuild(node):
        if isinstance(node, (torch.Tensor, np.ndarray)):
            return next(it)
        if dataclasses.is_dataclass(node):
            return _replace(node, rebuild)
        if _is_namedtuple(node):
            return type(node)(*(rebuild(getattr(node, k))
                                for k in node._fields))
        if isinstance(node, dict):
            return {k: rebuild(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [rebuild(x) for x in node]
        return node

    out = rebuild(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _replace(obj, fn: Callable):
    """A dataclass instance of ``obj``'s type with ``fn`` of each field
    (fields in declared order)."""
    return dataclasses.replace(obj, **{
        f.name: fn(getattr(obj, f.name))
        for f in dataclasses.fields(obj) if f.init})


def map(fn: Callable, tree, *rest):   # jax.tree.map's name
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in a tree of that
    structure."""
    cols = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def stack(trees: list):
    """Dict trees of one structure → one tree whose leaves stack theirs
    on a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def index(stacked, i: int):
    """Entry i of every leaf of a stacked tree (:func:`stack`)."""
    if isinstance(stacked, dict):
        return {k: index(v, i) for k, v in stacked.items()}
    return stacked[i]


def to(tree, device) -> Any:
    """Every tensor of a tree of tensors, numpy arrays, dataclasses,
    tuples, dicts and scalars on ``device``: a numpy array becomes a
    tensor there, scalars and ``None`` stay as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree)).to(device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return _replace(tree, lambda x: to(x, device))
    if _is_namedtuple(tree):
        return type(tree)(*(to(x, device) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to(x, device) for x in tree)
    if isinstance(tree, dict):
        return {k: to(v, device) for k, v in tree.items()}
    return tree

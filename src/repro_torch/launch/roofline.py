"""Roofline terms and the dry run's counters (port of
``repro/launch/roofline.py``: the hardware constants, ``roofline_terms``
and ``model_flops``; :func:`counting` takes the place of
``cost_summary``, ``weighted_cost`` and ``collective_summary``, which
read XLA's compiled module).

    compute term    = FLOPs            / (chips × peak FLOP/s)
    memory term     = bytes            / (chips × HBM bytes/s)
    collective term = collective bytes / (chips × link bytes/s)

The three are derived from counts, not timed.  :func:`counting` counts
one step as it runs, on real or fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``, which allocates
nothing):

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the PyTorch
  ops, plus each hand-written kernel's formula
  (:mod:`repro_torch.work`: its wrapper adds it where it launches, and
  on its fake path);
* bytes: Σ (inputs + outputs) of every dispatched op that materializes
  a tensor — views, reshapes, factories and ops with no tensor output
  skipped, as the reference's ``_SKIP_BYTES_OPS`` skips them — plus the
  kernels' formulas;
* collective bytes: what each mesh position receives from the others at
  the port's collectives (:mod:`repro_torch.distributed.collectives`),
  0 for a step that meets no mesh;
* live bytes: each storage's bytes from its first appearance (or from
  :meth:`Count.hold`, for a step's arguments) until it is freed, and
  their peak.

A mesh position's thread runs under its caller's modes
(:meth:`repro_torch.distributed.collectives.Mesh.run`), so no op escapes
the counters there.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import weakref

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils import flop_counter
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import work

# --- NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU datasheet) ------------
PEAK_FLOPS = 989e12          # bf16 / fp16 dense tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
LINK_BW = 450e9              # NVLink 4 bytes/s each way (900 GB/s total)

_aten = torch.ops.aten
#: ops that move no bytes of their own: aliases, reshapes and the
#: factories of uninitialized memory
_SKIP_BYTES = {_aten.detach, _aten.alias, _aten._unsafe_view, _aten.view,
               _aten.lift_fresh, _aten.empty, _aten.empty_like,
               _aten.empty_strided, _aten.new_empty,
               _aten.new_empty_strided, _aten.record_stream,
               _aten.set_}


def _tensors(tree) -> list:
    return [t for t in _pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def tensors(tree) -> list:
    """Every tensor of a tree of tuples, lists, dicts and dataclasses (a
    step's arguments or outputs)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in tensors(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Ops(TorchDispatchMode):
    """Counts each op's bytes and calls, and keeps the live storages."""

    def __init__(self, count: "Count"):
        super().__init__()
        self.count = count

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        packet = func.overloadpacket
        nbytes = 0
        if ins and outs and not func.is_view and packet not in _SKIP_BYTES:
            nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.count._op(str(packet), nbytes)
        work.add_op_bytes(nbytes)
        for t in outs:
            self.count._track(t)
        return out


class Count:
    """What :func:`counting` counted; read it after the block ends."""

    def __init__(self):
        self._lock = threading.RLock()
        self._live: dict = {}            # id(storage) → bytes
        self.live_bytes = 0
        self.peak_bytes = 0
        self.op_bytes = 0
        self.by_op = collections.defaultdict(
            lambda: {"calls": 0, "flops": 0, "bytes": 0})
        self.flop_flops = 0
        self.kernels: dict = {}
        self.collectives: dict = {}

    # --- live storages ----------------------------------------------------
    def _free(self, key: int, nbytes: int) -> None:
        with self._lock:
            if self._live.pop(key, None) is not None:
                self.live_bytes -= nbytes

    def _track(self, t: torch.Tensor) -> int:
        """Start counting ``t``'s storage (once); returns its bytes if it
        is new, else 0."""
        if t.device.type == "meta":           # shape-only: no bytes
            return 0
        st = t.untyped_storage()
        key = id(st)
        with self._lock:
            if key in self._live:
                return 0
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key, n)
        return n

    def hold(self, tree) -> int:
        """Count the storages of ``tree``'s tensors as live from now (a
        step's arguments); returns their bytes, each storage once."""
        return sum(self._track(t) for t in tensors(tree))

    def storages(self, tree) -> set:
        """The storage keys of ``tree``'s tensors."""
        return {id(t.untyped_storage()) for t in tensors(tree)}

    def _op(self, name: str, nbytes: int) -> None:
        with self._lock:
            rec = self.by_op[name]
            rec["calls"] += 1
            rec["bytes"] += nbytes
            self.op_bytes += nbytes

    # --- totals -----------------------------------------------------------
    @property
    def kernel_flops(self) -> int:
        return sum(k["flops"] for k in self.kernels.values())

    @property
    def kernel_bytes(self) -> int:
        return sum(k["bytes"] for k in self.kernels.values())

    @property
    def flops(self) -> int:
        """FlopCounterMode's FLOPs plus the kernels' formulas."""
        return self.flop_flops + self.kernel_flops

    @property
    def bytes(self) -> int:
        return self.op_bytes + self.kernel_bytes

    @property
    def collective_bytes(self) -> int:
        return sum(c["bytes"] for c in self.collectives.values())

    def summary(self) -> dict:
        """The record's ``cost`` and ``collectives`` blocks and the
        per-op totals (ops and kernels by name, FLOPs descending)."""
        ops = {name: dict(rec) for name, rec in self.by_op.items()}
        for name, rec in self.kernels.items():
            ops[f"kernel:{name}"] = dict(rec)
        return {
            "cost": {"flops": self.flops, "bytes": self.bytes},
            "collectives": {
                "total_bytes": self.collective_bytes,
                "n_ops": sum(c["calls"] for c in self.collectives.values()),
                "by_op": {op: c["bytes"]
                          for op, c in self.collectives.items()
                          if c["bytes"]}},
            "by_op": dict(sorted(ops.items(), key=lambda kv: (
                -kv[1]["flops"], -kv[1]["bytes"]))),
        }


def _product_flops(formula):
    """A ``flop_counter`` formula of a product taking only the two
    operands' shapes: the ``out_dtype`` overloads (``aten.mm.dtype``,
    ``aten.bmm.dtype``, which ``layers.matmul_f32`` calls) pass the dtype
    as a third positional argument, which some releases' formulas read
    as the output's shape."""
    def flops(a_shape, b_shape, *_, out_shape=None, **__):
        return formula(a_shape, b_shape)
    return flops


#: FlopCounterMode's own formulas for the products, on every overload
_PRODUCTS = {_aten.mm: _product_flops(flop_counter.mm_flop),
             _aten.bmm: _product_flops(flop_counter.bmm_flop)}


@contextlib.contextmanager
def counting():
    """Count what the block runs (see the module docstring) into the
    :class:`Count` it yields.  Enter it inside a ``FakeTensorMode`` to
    count a step on fake tensors."""
    count = Count()
    flops = FlopCounterMode(display=False, custom_mapping=_PRODUCTS)
    with work.counting() as tally, flops, _Ops(count):
        yield count
    for packet, n in flops.get_flop_counts().get("Global", {}).items():
        count.by_op[str(packet)]["flops"] += int(n)
    count.flop_flops = int(flops.get_total_flops())
    count.kernels = {k: dict(v) for k, v in tally.kernels.items()}
    count.collectives = {k: dict(v) for k, v in tally.collectives.items()}


def roofline_terms(flops: float, bytes_accessed: float,
                   collective_bytes: float, n_chips: int) -> dict:
    """The three terms in seconds (global work / aggregate capability)."""
    compute_s = flops / (n_chips * PEAK_FLOPS)
    memory_s = bytes_accessed / (n_chips * HBM_BW)
    collective_s = collective_bytes / (n_chips * LINK_BW)
    dominant = max((compute_s, "compute"), (memory_s, "memory"),
                   (collective_s, "collective"))[1]
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s, "dominant": dominant}


def model_flops(n_params_active: int, n_tokens: int,
                training: bool = True) -> float:
    """6·N·D for a train step (2 fwd + 4 bwd per param·token);
    2·N·D for inference."""
    per = 6.0 if training else 2.0
    return per * n_params_active * n_tokens

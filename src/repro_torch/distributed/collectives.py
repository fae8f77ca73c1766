"""The in-process device mesh and its collectives (port of
``repro/distributed/collectives.py``: ``flat_allreduce``,
``hierarchical_allreduce``, ``pmean_metrics`` and ``gather_topk``; the
mesh stands in for the reference's ``jax.sharding.Mesh`` and
``shard_map``).

The reference is single-controller: one process calls a search, and
``shard_map`` runs the same body on every device of the mesh, where it
meets ``all_gather`` and ``psum`` in the middle.  Here a :class:`Mesh`
is a grid of :class:`torch.device`\\ s with axis names, and each mesh
position runs the body in a worker thread of its own (on a card, on a
CUDA stream of its own).  The threads are started once per mesh and
kept.  Several positions may share one device (``["cuda:0"] * 4``
places four on one card, as the reference emulates devices on a CPU);
a position never moves to another device.

A :class:`Group` joins the positions that differ only along a set of
axes (one axis, or several, as the reference's ``psum(x, ("data",
"pod"))``) and gives them ``all_gather``, ``psum`` and ``psum_scatter``.
A group's ranks run row-major over its axes in the mesh's axis order,
whatever order a caller names them in.  Each collective meets at a
barrier, where each position posts its tensors and reads the others'.  When the
whole group is on one card the streams are ordered by CUDA events (a
reader's stream waits for the event each poster recorded) and the host
never waits for the card; a reader ties what it read to its own stream
(``record_stream``), so the allocator keeps those blocks until its
stream is done with them.  Otherwise each position synchronizes its
stream before it posts and after it reads, and copies what it reads
onto its own device: that is the CPU's path, and on a card the path of
a group that spans several cards (``test_torch_cuda.py``'s
``across_cards`` tests, on four H100s).  Every position meets the others once
more before anyone may post again.  ``psum`` adds in rank order, so
every position holds the same bits; ``psum_scatter`` gives rank r block
r of that sum (the same adds, on block r alone).

:meth:`Mesh.run` forks the positions' streams from the caller's with
an event.  On a mesh whose positions all share one card it also joins
them back: each position records an event after its work and the
caller's stream waits on it, so neither the host nor a position waits
for the card, and a CUDA graph captured around the call holds every
position's work (the serving runtime's one graph per bucket,
:mod:`repro_torch.launch.runtime`); the barriers run while capturing
and never in a replay.  On any other mesh each position waits for its
stream before it posts its result.

A call fails; it never hangs.  A position that raises breaks every
barrier of the mesh and :meth:`Mesh.run` raises its error in the
caller.  Every barrier wait has a timeout (:data:`TIMEOUT_S`, read when
the mesh is built), so a position that never arrives at a collective
fails the call.  The caller waits for the positions' results no longer
than twice that at a time, so a position that stalls anywhere else
fails the call too, and closes the mesh.

Inside a :meth:`Mesh.run` body, :meth:`Mesh.position` gives a
:class:`Position`: the reference's named-axis collectives (``psum``,
``pmean``, tiled ``psum_scatter`` and ``all_gather``) at that position,
over one axis or a tuple of them.  The training mesh's gradient
all-reduce (:func:`flat_allreduce`, :func:`hierarchical_allreduce`,
:func:`pmean_metrics`) and the sharded KMeans
(:func:`repro_torch.core.kmeans.kmeans_fit_sharded`) take one.
:class:`Split` places a leading axis over mesh positions (the
reference's ``NamedSharding`` of dim 0), for the data loader and the
elastic restore.

A position's thread runs under the dispatch modes its caller's thread
had when it called :meth:`Mesh.run` (a fake-tensor mode and the dry
run's counters, :mod:`repro_torch.launch.roofline`).  Those modes keep
state that is not thread-safe (a fake tensor reports the meta device
while its mode runs a kernel on any thread), so then the positions take
turns: one runs at a time, and a position waiting at a collective lets
the next one run.  With no mode pushed the positions run together as
before.  Every collective adds the bytes each position receives from
the others to the dry run's tally
(:func:`repro_torch.work.add_collective`).

Training across positions (:func:`repro_torch.models.gnn.
forward_partitioned`) runs each position's block in :meth:`Mesh.run`
with ``grad=True`` and joins the blocks with :func:`replicate` and
:func:`all_gather_tiled`, which the controlling thread calls: their
backward adds in rank order and meets no barrier, because autograd runs
a card's backward nodes on one thread, where a node waiting for the
other positions would wait for itself.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import queue
import threading
import weakref
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch.utils import _python_dispatch

from repro_torch import device as dev_mod
from repro_torch import tree as tree_mod
from repro_torch import work

#: seconds a position waits at a collective for the others (a mesh
#: reads it when it is built)
TIMEOUT_S = 600.0


def _settle(device: torch.device) -> None:
    """Wait for the work this thread queued on ``device``."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class Group:
    """Collectives among ``size`` positions (ranks 0..size-1) of one
    mesh: each rank calls the same collective with its own tensors."""

    def __init__(self, size: int, one_card: bool = False):
        self.size = int(size)
        self.one_card = one_card         # every rank on the same card
        self._slots: list = [None] * self.size
        self._barrier = threading.Barrier(self.size, timeout=TIMEOUT_S)

    def _exchange(self, rank: int, xs: tuple, combine: Callable,
                  op: str, share: int = 1):
        """Post ``xs``, meet the group, ``combine`` every rank's; this
        rank receives ``1 / share`` of each other rank's bytes."""
        work.add_collective(op, (self.size - 1) * sum(
            _nbytes(t) for t in xs) // share)
        dev = xs[0].device
        if self.one_card and dev.type == "cuda" and not work.is_fake(xs[0]):
            stream = torch.cuda.current_stream(dev)
            posted = torch.cuda.Event()
            posted.record(stream)
            self._slots[rank] = (xs, posted)
            _wait(self._barrier)
            for ys, ready in self._slots:
                stream.wait_event(ready)
                for t in ys:
                    t.record_stream(stream)
            out = combine([list(ys) for ys, _ in self._slots])
        else:
            _settle(dev)                 # what we post is complete
            self._slots[rank] = (xs, None)
            _wait(self._barrier)
            out = combine([[t.to(dev) for t in ys]
                           for ys, _ in self._slots])
            _settle(dev)                 # what we read is consumed
        _wait(self._barrier)
        return out

    def all_gather(self, rank: int, xs: Sequence[torch.Tensor],
                   tiled: bool = False) -> tuple:
        """Each of ``xs`` over the ranks on this rank's device, rank
        order: stacked into (size, ...) tensors, or with ``tiled``
        concatenated along dim 0 (``jax.lax.all_gather(..., tiled=True)``)."""
        join = torch.cat if tiled else torch.stack
        return self._exchange(rank, tuple(xs), lambda parts: tuple(
            join(col) for col in zip(*parts)), "all-gather")

    def psum(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``, added in rank order
        (((x₀ + x₁) + x₂) + …), the same bits on every rank."""
        return self._exchange(rank, (x,), lambda parts: _add(
            [p[0] for p in parts]), "all-reduce")

    def psum_scatter(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        """Block ``rank`` of the rank-order sum of every rank's ``x``,
        split along dim 0 into ``size`` equal blocks
        (``jax.lax.psum_scatter(..., scatter_dimension=0, tiled=True)``):
        the same bits as that block of :meth:`psum`."""
        if x.dim() == 0 or x.shape[0] % self.size:
            raise ValueError(f"psum_scatter over {self.size} ranks needs "
                             f"dim 0 a multiple of {self.size}, got shape "
                             f"{tuple(x.shape)}")
        block = x.shape[0] // self.size
        lo = rank * block
        return self._exchange(rank, (x,), lambda parts: _add(
            [p[0][lo:lo + block] for p in parts]), "reduce-scatter",
            share=self.size)

    def abort(self) -> None:
        self._barrier.abort()

    def reset(self) -> None:
        self._slots = [None] * self.size
        self._barrier.reset()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _add(xs: list) -> torch.Tensor:
    """((x₀ + x₁) + x₂) + …, a new tensor."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc.clone() if len(xs) == 1 else acc


def gather_topk(scores: torch.Tensor, ids: torch.Tensor, shard
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard top-R planes for the sharded search (DESIGN.md
    §6): all-gather each shard's (B, R) scores and ids over the shard
    axis of ``shard`` (a :class:`repro_torch.core.exec.ShardEnv`) and lay
    them out as one (B, S·R) candidate plane per query, shard-major as
    the reference's ``moveaxis(0, 1).reshape``.  Every shard returns the
    same plane."""
    s, i = shard.all_gather(scores, ids)            # (S, B, R) each
    n_shards, b, r = s.shape
    return (s.movedim(0, 1).reshape(b, n_shards * r),
            i.movedim(0, 1).reshape(b, n_shards * r))


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, devices):
        ctx.home = x.device
        work.add_collective("broadcast", (len(devices) - 1) * _nbytes(x))
        return tuple(x.to(d, copy=True) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        live = [g.to(ctx.home) for g in grads if g is not None]
        work.add_collective("reduce", sum(map(_nbytes, live[1:])))
        return (_add(live) if live else None), None


class _AllGatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, *blocks):
        ctx.sizes = [b.shape[0] for b in blocks]
        ctx.devices = [b.device for b in blocks]
        total = sum(map(_nbytes, blocks))
        work.add_collective("all-gather", (len(devices) - 1) * total)
        return tuple(torch.cat([b.to(d) for b in blocks]) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        out = [None]
        lo = 0
        for n, dev in zip(ctx.sizes, ctx.devices):
            live = [g[lo:lo + n].to(dev) for g in grads if g is not None]
            work.add_collective("reduce-scatter",
                                sum(map(_nbytes, live[1:])))
            out.append(_add(live) if live else None)
            lo += n
        return tuple(out)


def replicate(x: torch.Tensor, devices: Sequence) -> tuple:
    """A copy of ``x`` on each of ``devices`` (rank order), for bodies
    that run on mesh positions under autograd (a replicated input of the
    reference's ``shard_map``).  Its backward adds the copies' gradients
    in rank order on ``x``'s device (the transpose, a psum).  Called by
    the controlling thread, outside :meth:`Mesh.run`: it meets no
    barrier, forward or backward."""
    return _Replicate.apply(x, list(devices))


def all_gather_tiled(blocks: Sequence[torch.Tensor],
                     devices: Sequence) -> tuple:
    """Every rank's block (``blocks[r]``, on rank r's device) concatenated
    in rank order along dim 0, one copy on each of ``devices``
    (``jax.lax.all_gather(..., tiled=True)``), differentiable: backward
    gives block r the rank-order sum of every copy's gradient rows of
    block r (the transpose, a tiled ``psum_scatter``).  Called by the
    controlling thread between :meth:`Mesh.run` calls, so no backward
    node waits for another position; :meth:`Group.all_gather` is the
    inference collective that positions call inside one."""
    return _AllGatherTiled.apply(list(devices), *blocks)


# --------------------------------------------------------------------------
# the mesh and its worker threads
# --------------------------------------------------------------------------

def mesh_devices(need: int, devices, what: str) -> list:
    """``need`` resolved devices for a mesh: ``devices`` when given (its
    length must be ``need``), else the first ``need`` cards, raising
    when there are fewer."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < need:
            raise RuntimeError(
                f"need {need} cards for {what}, have {have}; place several "
                f"mesh positions on one device with devices= (e.g. "
                f"devices=['cuda:0'] * {need}, or ['cpu'] * {need})")
        return [torch.device("cuda", i) for i in range(need)]
    out = [dev_mod.resolve(d) for d in devices]
    if len(out) != need:
        raise ValueError(f"{what} needs {need} devices, devices= gives "
                         f"{len(out)}")
    return out


class _Call:
    """One :meth:`Mesh.run`: every position's result or error, and on a
    one-card mesh the event each position recorded after its work."""

    def __init__(self, n: int):
        self.left = n
        self.results: dict = {}
        self.errors: dict = {}
        self.finished: dict = {}
        self.lock = threading.Lock()
        self.done = threading.Event()

    def post(self, coord, result, error, finished=None) -> None:
        with self.lock:
            if error is None:
                self.results[coord] = result
                if finished is not None:
                    self.finished[coord] = finished
            else:
                self.errors[coord] = error
            self.left -= 1
            if self.left == 0:
                self.done.set()


#: held by the one position that runs while its caller's modes are
#: pushed; a position waiting at a collective lets it go
_TURN = threading.Lock()
_turn = threading.local()


def _wait(barrier: threading.Barrier) -> None:
    """``barrier.wait()``, giving up this position's turn meanwhile."""
    if not getattr(_turn, "held", False):
        barrier.wait()
        return
    _TURN.release()
    try:
        barrier.wait()
    finally:
        _TURN.acquire()


@contextlib.contextmanager
def _modes(modes: list):
    """The caller's dispatch modes (bottom first) pushed on this thread
    for one job, which then runs in turn (:data:`_TURN`); nothing when
    there are none.  A fake-tensor mode on a host without a card also
    makes ``torch.tensor`` lift its data through the CPU, by a
    thread-local flag its own ``__enter__`` sets on the caller's thread:
    set here too."""
    if not modes:
        yield
        return
    lift = any(getattr(m, "avoid_device_init", False) for m in modes)
    prev_lift = torch._C._only_lift_cpu_tensors()
    _TURN.acquire()
    _turn.held = True
    if lift:
        torch._C._set_only_lift_cpu_tensors(True)
    for mode in modes:
        _python_dispatch._push_mode(mode)
    try:
        yield
    finally:
        for mode in reversed(modes):
            _python_dispatch._pop_mode(getattr(mode, "_mode_key", None))
        torch._C._set_only_lift_cpu_tensors(prev_lift)
        _turn.held = False
        _TURN.release()


def _worker(coord, device: torch.device, jobs: "queue.SimpleQueue",
            groups: list) -> None:
    """A position's thread: runs each job on its own stream (a card) in
    inference mode, or with autograd recording (a ``grad`` job); an
    error breaks every group of the mesh.  On a
    one-card mesh (``join``) the job ends with an event recorded on the
    stream, which the caller's stream waits on; otherwise the thread
    waits for its stream before it posts."""
    stream = None
    if device.type == "cuda":
        torch.cuda.set_device(device)
        stream = torch.cuda.Stream(device)
    while True:
        job = jobs.get()
        if job is None:
            return
        fn, ready, call, join, grad, modes = job
        out = finished = None
        try:
            with torch.enable_grad() if grad else torch.inference_mode(), \
                    _modes(modes):
                if stream is None:
                    out = fn(coord)
                else:
                    with torch.cuda.stream(stream):
                        if ready is not None:
                            stream.wait_event(ready)
                        out = fn(coord)
                    if join:
                        finished = torch.cuda.Event()
                        finished.record(stream)
                    else:
                        stream.synchronize()
        except BaseException as e:          # noqa: BLE001 — re-raised
            for g in groups:
                g.abort()
            call.post(coord, None, e)
        else:
            call.post(coord, out, None, finished)
        # hold nothing of the job while idle: its closure may keep the
        # mesh alive, and the mesh stops its threads when it is freed
        del job, fn, ready, call, out, finished, modes


def _record_on_caller(out) -> None:
    """Tie the card tensors of a position's result to the caller's
    stream, so the allocator does not hand their blocks back to the
    position's stream while the caller still reads them."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda and not work.is_fake(out):
            out.record_stream(torch.cuda.current_stream(out.device))
    elif isinstance(out, (tuple, list)):
        for x in out:
            _record_on_caller(x)


def _stop(queues: list, threads: list) -> None:
    """End the worker threads and wait for them (a thread that ended
    while the interpreter shuts down could race its teardown)."""
    for q in queues:
        q.put(None)
    for t in threads:
        if t is not threading.current_thread():
            t.join()


class Mesh:
    """A grid of devices with axis names (``shape[axis]`` sizes, as the
    reference's ``Mesh.shape``), a worker thread per position and a
    :class:`Group` per line of positions along each axis."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.empty(np.shape(np.asarray(devices, dtype=object)),
                        dtype=object)
        for coord in np.ndindex(grid.shape):
            grid[coord] = dev_mod.resolve(
                np.asarray(devices, dtype=object)[coord])
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-D device grid for axes "
                             f"{tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))
        self.timeout = TIMEOUT_S
        # a group per set of axes and per coordinate along the others
        self._groups: dict = {}
        for r in range(1, grid.ndim + 1):
            for axes in itertools.combinations(range(grid.ndim), r):
                for coord in np.ndindex(grid.shape):
                    key = self._group_key(axes, coord)
                    if key not in self._groups:
                        line = {grid[m] for m in self._members(axes, coord)}
                        self._groups[key] = Group(
                            int(np.prod([grid.shape[a] for a in axes])),
                            one_card=len(line) == 1)
        self._lock = threading.Lock()
        self._queues: dict = {}
        groups = list(self._groups.values())
        threads = []
        for coord in self.positions():
            q = queue.SimpleQueue()
            threads.append(threading.Thread(
                target=_worker, daemon=True, name=f"mesh-position-{coord}",
                args=(coord, grid[coord], q, groups)))
            threads[-1].start()
            self._queues[coord] = q
        self._closer = weakref.finalize(
            self, _stop, list(self._queues.values()), threads)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def one_card(self) -> bool:
        """Whether every position is on the same card.  Then :meth:`run`
        joins the positions' streams to the caller's by events, with no
        host wait, so a CUDA graph captured around it holds every
        position's work."""
        first = self.devices.flat[0]
        return first.type == "cuda" and all(d == first
                                             for d in self.devices.flat)

    def positions(self) -> list:
        """Every position's coordinate tuple, row-major."""
        return list(np.ndindex(self.devices.shape))

    def axis_index(self, axis_name: str) -> int:
        if axis_name not in self.shape:
            raise ValueError(f"mesh has no axis {axis_name!r} "
                             f"(axes: {self.axis_names})")
        return self.axis_names.index(axis_name)

    def _axes(self, axes) -> tuple:
        """Axis numbers of an axis name or a tuple of them, in mesh
        order."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        if not names or len(set(names)) != len(names):
            raise ValueError(f"axes {axes!r}: name each axis once")
        return tuple(sorted(self.axis_index(n) for n in names))

    def _group_key(self, axes: tuple, coord: tuple) -> tuple:
        return (axes,) + tuple(c for a, c in enumerate(coord)
                               if a not in axes)

    def _members(self, axes: tuple, coord: tuple) -> list:
        """The positions of ``coord``'s group over ``axes``, rank order
        (row-major over ``axes``)."""
        out = []
        for idx in np.ndindex(*(self.devices.shape[a] for a in axes)):
            m = list(coord)
            for a, i in zip(axes, idx):
                m[a] = i
            out.append(tuple(m))
        return out

    def group(self, axes, coord: tuple) -> Group:
        """The group of ``coord`` over ``axes`` (an axis name or a tuple
        of them): the positions that share every other coordinate with
        it."""
        return self._groups[self._group_key(self._axes(axes), coord)]

    def rank(self, axes, coord: tuple) -> int:
        """``coord``'s rank in its group over ``axes``: row-major over
        those axes in mesh order (one axis: its index there)."""
        r = 0
        for a in self._axes(axes):
            r = r * self.devices.shape[a] + coord[a]
        return r

    def axis_size(self, axes) -> int:
        """Positions in a group over ``axes``."""
        return int(np.prod([self.devices.shape[a]
                            for a in self._axes(axes)]))

    def position(self, coord: tuple) -> "Position":
        """The collectives of position ``coord``, for a :meth:`run`
        body."""
        return Position(self, tuple(coord))

    def run(self, fn: Callable[[tuple], Any], grad: bool = False) -> dict:
        """``fn(coord)`` on every position at once, each in its worker
        thread (on a card on the worker's stream, after the work the
        caller queued so far on the first position's device); returns
        {coord: result}.  The positions run in inference mode, or with
        ``grad`` under autograd, so their results join the caller's
        graph (:func:`repro_torch.models.gnn.forward_partitioned`; the
        backward then runs on autograd's own threads, on each position's
        stream, and must meet no collective).  On a :attr:`one_card`
        mesh the caller's stream then waits for every position's stream
        (the join of the fork event), so the call returns once the work
        is queued and is legal inside a CUDA graph capture; on other
        meshes each position waits for its stream before it posts.  A
        position that raises breaks the others' collectives and its
        error is raised here; when every error is a
        broken barrier, a position missed a collective for ``timeout``
        seconds and a RuntimeError says so.  When ``2 * timeout`` seconds
        pass with no position finishing, a RuntimeError names the
        positions still out, and the mesh is closed: a stalled thread
        may yet reach a collective, and must meet no later call."""
        if not self._closer.alive:
            raise RuntimeError("this mesh is closed")
        first = self.devices.flat[0]
        join = self.one_card
        with self._lock:
            ready = None
            if first.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(first))
            call = _Call(self.size)
            modes = _python_dispatch._get_current_dispatch_mode_stack()
            for q in self._queues.values():
                q.put((fn, ready, call, join, grad, modes))
            while not call.done.is_set():
                with call.lock:
                    left = call.left
                if not call.done.wait(2 * self.timeout):
                    with call.lock:
                        if call.left == left:
                            self._abandon(call)
            if call.errors:
                for g in self._groups.values():
                    g.reset()
                real = [e for e in call.errors.values()
                        if not isinstance(e, threading.BrokenBarrierError)]
                if real:
                    raise real[0]
                raise RuntimeError(
                    f"a collective of the mesh broke: a position did not "
                    f"arrive within {self.timeout} s")
        if join:
            caller = torch.cuda.current_stream(first)
            for finished in call.finished.values():
                caller.wait_event(finished)
        for out in call.results.values():
            _record_on_caller(out)
        return call.results

    def _abandon(self, call: _Call) -> None:
        """Close the mesh around positions that stopped finishing: break
        its collectives, let each thread end when it comes free (without
        waiting for it), and raise."""
        late = [c for c in self.positions()
                if c not in call.results and c not in call.errors]
        for g in self._groups.values():
            g.abort()
        self._closer.detach()
        for q in self._queues.values():
            q.put(None)
        raise RuntimeError(
            f"mesh positions {late} did not finish: no position finished "
            f"for {2 * self.timeout} s; the mesh is closed")

    def close(self) -> None:
        """Stop the worker threads (also done when the mesh is freed)."""
        self._closer()

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


# --------------------------------------------------------------------------
# a position's named-axis collectives, and the gradient all-reduce
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Position:
    """One position of a :class:`Mesh` inside a :meth:`Mesh.run` body:
    the reference's named-axis collectives there.  ``axes`` is an axis
    name or a tuple of them; a tuple is one group whose ranks run
    row-major over its axes in mesh order, so a psum over two axes adds
    every position's tensor in that one rank order."""
    mesh: Mesh
    coord: tuple

    def axis_size(self, axes) -> int:
        return self.mesh.axis_size(axes)

    def axis_index(self, axes) -> int:
        return self.mesh.rank(axes, self.coord)

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self.mesh.group(axes, self.coord).psum(
            self.axis_index(axes), x)

    def pmean(self, x: torch.Tensor, axes) -> torch.Tensor:
        """:meth:`psum` divided by the group's size, as ``jax.lax.pmean``
        (by a tensor: CUDA multiplies by the reciprocal of a Python
        scalar divisor, which would round otherwise than the CPU)."""
        total = self.psum(x, axes)
        return total / torch.full(
            (), self.axis_size(axes), device=total.device,
            dtype=total.dtype if total.is_floating_point() else None)

    def psum_scatter(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Tiled along dim 0: this position's block of the sum."""
        return self.mesh.group(axes, self.coord).psum_scatter(
            self.axis_index(axes), x)

    def all_gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Tiled along dim 0: every rank's ``x`` concatenated."""
        return self.mesh.group(axes, self.coord).all_gather(
            self.axis_index(axes), (x,), tiled=True)[0]


def flat_allreduce(grads, axis_names, *, pos: Position):
    """Every leaf of ``grads`` (a tree of tensors) summed over
    ``axis_names`` in one group, in its rank order."""
    return tree_mod.map(lambda g: pos.psum(g, axis_names), grads)


def hierarchical_allreduce(grads, data_axis: str = "data",
                           pod_axis: str = "pod", *, pos: Position):
    """reduce_scatter(data) → psum(pod) → all_gather(data), leafwise:
    the bandwidth-optimal schedule at pod scale, which moves 1/|data| of
    the bytes across pods.  Position (p, d) adds block d over ``data``
    (rank order), then adds the pods' blocks (pod order), and every
    position gathers the same blocks, so every position holds the same
    bits; they differ from :func:`flat_allreduce`'s in the order of the
    adds only.  A leaf with ``ndim == 0`` or a dim 0 that ``|data|``
    does not divide takes the flat psum over both axes."""
    data_size = pos.axis_size(data_axis)

    def one(g):
        if g.dim() == 0 or g.shape[0] % data_size != 0:
            return pos.psum(g, (data_axis, pod_axis))
        part = pos.psum(pos.psum_scatter(g, data_axis), pod_axis)
        return pos.all_gather(part, data_axis)

    return tree_mod.map(one, grads)


def pmean_metrics(metrics, axis_names, *, pos: Position):
    """Every leaf of ``metrics`` (tensors, 0-d for scalars) averaged over
    ``axis_names``: the same bits on every position."""
    return tree_mod.map(lambda m: pos.pmean(m, axis_names), metrics)


@dataclasses.dataclass(frozen=True)
class Split:
    """Dim 0 of a tensor split in equal blocks over ``axes`` of ``mesh``
    (an axis name or a tuple of them, blocks in the group's rank
    order): the reference's ``NamedSharding`` with ``P(axes)`` on the
    leading axis.  Positions that differ only along other axes hold the
    same block."""
    mesh: Mesh
    axes: Any = "data"

    def place(self, x) -> dict:
        """{coord: this position's block on its device} for every
        position; a block of a tensor already on that device is a view.
        Raises unless the group's size divides dim 0."""
        n = self.mesh.axis_size(self.axes)
        rows = x.shape[0] if x.ndim else 0
        if x.ndim == 0 or rows % n:
            raise ValueError(f"cannot split shape {tuple(x.shape)} over "
                             f"{n} positions of {self.axes!r}")
        per = rows // n
        out = {}
        for coord in self.mesh.positions():
            r = self.mesh.rank(self.axes, coord)
            block = x[r * per:(r + 1) * per]
            if isinstance(block, np.ndarray):
                block = torch.from_numpy(np.ascontiguousarray(block))
            out[coord] = block.to(self.mesh.devices[coord])
        return out

    def join(self, pieces: dict) -> torch.Tensor:
        """The tensor :meth:`place` split, on the host: one block of each
        rank, rank order."""
        first = {}
        for coord, t in pieces.items():
            first.setdefault(self.mesh.rank(self.axes, coord), t)
        return torch.cat([first[r].cpu() for r in sorted(first)])

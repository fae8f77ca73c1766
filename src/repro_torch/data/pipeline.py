"""Sharded host→device data pipeline (port of ``repro/data/pipeline.py``:
``shard_batch`` and ``Dataloader``).

Batches are trees of numpy arrays or tensors.  :func:`shard_batch` splits
one over the data axes of a :class:`repro_torch.distributed.collectives.Mesh`
(the producer side of the data-parallel axes): where the reference
``device_put``s under a ``NamedSharding`` from its active mesh
(``distributed/sharding.py::named_sharding``, not ported), the port
returns each position's slice of the leading axis on that position's
device, for a :meth:`Mesh.run` body to pick up by its coordinate.
:class:`Dataloader` adds deterministic seeding, epoch iteration and
host-subset resharding (the fault-tolerance hook: after a host ejection
the loader recomputes its bounds from the surviving host list,
:func:`repro_torch.distributed.fault.reshard_bounds`).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Optional

from repro_torch import tree as tree_mod
from repro_torch.distributed import collectives
from repro_torch.distributed import fault

PyTree = Any


def shard_batch(batch: PyTree, mesh: collectives.Mesh,
                axis="data") -> dict:
    """{coord: ``batch`` with every leaf's leading axis cut to that
    position's block, on its device} over ``axis`` (an axis name or a
    tuple of them, blocks in rank order; positions along other axes get
    the same block).  Raises unless the axis divides every leading
    dimension, as the reference's sharded ``device_put`` does."""
    split = collectives.Split(mesh, axis)
    pieces = [split.place(x) for x in tree_mod.leaves(batch)]
    return {coord: tree_mod.unflatten(batch, [p[coord] for p in pieces])
            for coord in mesh.positions()}


class Dataloader:
    """Deterministic, reshardable loader over a synthetic batch factory.

    ``factory(seed, batch_size) -> pytree``; every global step consumes
    one seed so runs are reproducible across restarts (the crash/restart
    drill relies on this).
    """

    def __init__(self, factory: Callable[[int, int], PyTree],
                 global_batch: int, seed: int = 0,
                 host_id: int = 0, healthy_hosts: Optional[list[int]] = None):
        self.factory = factory
        self.global_batch = global_batch
        self.seed = seed
        self.host_id = host_id
        self.healthy_hosts = healthy_hosts or [0]

    def local_batch_size(self) -> int:
        bounds = fault.reshard_bounds(self.global_batch, self.healthy_hosts)
        lo, hi = bounds[self.host_id]
        return hi - lo

    def reshard(self, healthy_hosts: list[int]) -> None:
        """Fault-tolerance hook: drop ejected hosts, recompute bounds."""
        self.healthy_hosts = healthy_hosts

    def batch_at(self, step: int) -> PyTree:
        return self.factory(self.seed * 1_000_003 + step,
                            self.local_batch_size())

    def __iter__(self) -> Iterator[PyTree]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

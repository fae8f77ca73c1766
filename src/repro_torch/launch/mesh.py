"""Mesh construction (port of ``repro/launch/mesh.py``:
``make_production_mesh``, ``make_host_mesh`` and ``make_serving_mesh``).

Functions, not module constants, so importing touches no device.  Each
returns a :class:`repro_torch.distributed.collectives.Mesh` with the
reference's shape and axis names.  Without ``devices`` the positions
take the first cards and raise when there are fewer; ``devices=`` places
them anywhere, several on one device (``["cuda:0"] * 256``), as the
reference emulates its TPU pods on one host.  The dry run
(:mod:`repro_torch.launch.dryrun`) and the hillclimb harness
(:mod:`repro_torch.launch.hillclimb`) build the production meshes so.
The training mesh's (pod, data) axes need no constructor of their own:
a mesh over any grid of devices with those axis names runs the gradient
all-reduce (``collectives.hierarchical_allreduce``) and the sharded
KMeans.
"""
from __future__ import annotations

from repro_torch.distributed import collectives


def _grid(shape: tuple, axes: tuple, devices, what: str
          ) -> collectives.Mesh:
    """A row-major mesh of ``shape`` over ``devices`` (or the first
    cards)."""
    n = 1
    for s in shape:
        n *= s
    flat = collectives.mesh_devices(n, devices, what)

    def nest(items: list, dims: tuple):
        if len(dims) == 1:
            return items
        step = len(items) // dims[0]
        return [nest(items[i * step:(i + 1) * step], dims[1:])
                for i in range(dims[0])]

    return collectives.Mesh(nest(flat, shape), axes)


def make_production_mesh(*, multi_pod: bool = False,
                         devices=None) -> collectives.Mesh:
    """The reference's TPU v5e pod mesh: (16, 16) ``("data", "model")``,
    or with ``multi_pod`` (2, 16, 16) ``("pod", "data", "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _grid(shape, axes, devices,
                 f"the {'x'.join(map(str, shape))} production mesh")


def make_host_mesh(data: int = 2, model: int = 4,
                   devices=None) -> collectives.Mesh:
    """A small (data, model) ``("data", "model")`` mesh for tests."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got ({data}, {model})")
    return _grid((data, model), ("data", "model"), devices,
                 f"a ({data}, {model}) host mesh")


def make_serving_mesh(data: int, model: int, data_axis: str = "data",
                      model_axis: str = "shards",
                      devices=None) -> collectives.Mesh:
    """The 2-D serving mesh (DESIGN.md §12): queries split over ``data``
    replica slices, document shards over ``model`` positions per slice,
    ``data · model`` positions in all, row-major (slice d's shard s at
    ``devices[d · model + s]``).  The model axis keeps the sharded
    index's axis name ("shards"), so the same search runs on 1-D and 2-D
    meshes.  Without ``devices`` the positions take the first
    ``data · model`` cards and raise when there are fewer;
    ``devices=["cuda:0"] * 4`` puts a (2, 2) mesh on one card."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got ({data}, {model})")
    return _grid((data, model), (data_axis, model_axis), devices,
                 f"a ({data}, {model}) serving mesh")

"""The serving mesh (port of ``repro/launch/mesh.py``:
``make_serving_mesh``).

A function, not a module constant, so importing touches no device.
The training mesh's (pod, data) axes need no constructor of their own:
a :class:`repro_torch.distributed.collectives.Mesh` over any grid of
devices with those axis names runs the gradient all-reduce
(``collectives.hierarchical_allreduce``) and the sharded KMeans.
``make_production_mesh`` and ``make_host_mesh`` (the TPU pod's (16, 16)
and (2, 16, 16) meshes, which only the dry-run uses) come with the
dry-run family (ROADMAP.md A6).
"""
from __future__ import annotations

from repro_torch.distributed import collectives


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
    flat = collectives.mesh_devices(
        data * model, devices, f"a ({data}, {model}) serving mesh")
    grid = [flat[d * model:(d + 1) * model] for d in range(data)]
    return collectives.Mesh(grid, (data_axis, model_axis))

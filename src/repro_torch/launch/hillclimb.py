"""Hillclimb harness: one cell under config overrides, its three
roofline terms and peak memory (port of ``repro/launch/hillclimb.py``:
``measure`` and its CLI).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb mixtral-8x22b \\
        train_4k --override moe_impl=shard_map

The cell runs as in the dry run (:mod:`repro_torch.launch.dryrun`): on
fake tensors on ``--device`` (default ``cuda``, the card's host), with
the overrides applied to the arch's config.  ``moe_impl=shard_map`` and
GatedGCN's ``impl=partitioned`` run on the production mesh, every
position on the one device, so the collectives between positions are
counted; the step is the whole mesh's work on one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch import device as dev_mod
from repro_torch.configs import registry
from repro_torch.launch import cells as cm
from repro_torch.launch import dryrun
from repro_torch.launch import roofline


def measure(arch_id: str, shape_name: str, overrides: dict,
            multi_pod: bool = False, *,
            device: dev_mod.DeviceLike = "cuda") -> dict:
    dev = dev_mod.resolve(device)
    mesh = dryrun.production_mesh(multi_pod, dev)
    arch = registry.get(arch_id)
    shape = arch.shapes[shape_name]
    cfg = arch.make_config(shape)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = cm.build_cell(arch_id, shape_name, mesh, device=dev, config=cfg)
    ex = cm.execute(cell)
    col = ex.count.summary()["collectives"]
    terms = roofline.roofline_terms(ex.count.flops, ex.count.bytes,
                                    col["total_bytes"], 1)
    return {
        "cell": f"{arch_id}/{shape_name}", "overrides": overrides,
        "hbm_gb": round(ex.memory["peak"] / dryrun.GB, 2),
        "compute_s": terms["compute_s"], "memory_s": terms["memory_s"],
        "collective_s": terms["collective_s"],
        "dominant": terms["dominant"],
        "collectives_by_op_gb": {k: round(v / dryrun.GB, 3)
                                 for k, v in col["by_op"].items()},
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--override", action="append", default=[])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        if v in ("True", "False"):
            v = v == "True"
        else:
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
        overrides[k] = v
    print(json.dumps(measure(args.arch, args.shape, overrides,
                             args.multi_pod, device=args.device), indent=1))


if __name__ == "__main__":
    main()

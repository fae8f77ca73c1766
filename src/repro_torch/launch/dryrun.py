"""Dry run: every (architecture × input shape) cell on fake tensors at
its full published shape, recording what one H100 would hold and do
(port of ``repro/launch/dryrun.py``: ``run_cell`` and ``main``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --extra --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu

The reference lowers and compiles each cell on an emulated TPU pod mesh
and reads XLA's memory and cost analyses.  Here each cell's own step
(:mod:`repro_torch.launch.cells`) runs once under
``FakeTensorMode`` and the counters of :mod:`repro_torch.launch.
roofline`, on ``--device`` (default ``cuda``: the hand-written kernels'
fake paths, which needs the card's host; ``cpu``: the plain versions'
work).  Nothing is allocated and nothing is launched.  One JSON record a
cell goes to ``--out`` (default ``build/dryrun``, which git ignores):

  cell, mesh, n_devices, kind, status   ``ok``, ``FAILED`` (with the
        error) or ``skipped`` (with the registry's reason); ``mesh`` names
        the production mesh (16x16, or 2x16x16 with ``--multi-pod``),
        which sizes the sharded HI² cell's position; ``n_devices`` is 1,
        the one card the record describes;
  memory   argument_gb, output_gb, temp_gb, alias_gb, per_device_gb
        (GB = 10⁹ bytes): per_device is the peak of live bytes, argument
        + output + temp − alias; the training cells step in place, so
        their params and Adam state are alias;
  cost     FLOPs (FlopCounterMode + the kernels' formulas) and bytes;
  collectives  total_bytes, n_ops, by_op;
  seconds  of the fake step; fits: per_device_gb within the card's
        ``total_memory``, null when no card is visible; card: the
        ``nvidia-smi`` name and power limit, null without one;
  top_ops  the per-op totals with the most FLOPs.

A failing cell is recorded and the sweep goes on; the exit code is 1 if
any cell failed.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import time
import traceback

import torch

from repro_torch import device as dev_mod
from repro_torch.configs import registry
from repro_torch.launch import cells as cells_mod
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import roofline

OUT_DIR = os.path.join("build", "dryrun")
GB = 1e9
TOP_OPS = 12

_MESHES: dict = {}


def production_mesh(multi_pod: bool, dev: torch.device):
    """The production mesh with every position on ``dev`` (one per
    process and device: its worker threads are kept)."""
    key = (multi_pod, str(dev))
    if key not in _MESHES:
        n = 512 if multi_pod else 256
        _MESHES[key] = mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                                     devices=[dev] * n)
    return _MESHES[key]


def card() -> str | None:
    """The card's ``nvidia-smi`` name and power limit, e.g. "NVIDIA H100
    80GB HBM3, 700.00 W"; None without a card."""
    if not torch.cuda.is_available():
        return None
    if shutil.which("nvidia-smi"):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(0)


def fits(per_device_gb: float) -> bool | None:
    """Whether the peak fits card 0's memory; None without a card."""
    if not torch.cuda.is_available():
        return None
    return per_device_gb * GB <= torch.cuda.get_device_properties(
        0).total_memory


def record_of(ex: cells_mod.Executed) -> dict:
    """The memory, cost, collectives and top-op blocks of one step."""
    summary = ex.count.summary()
    mem = ex.memory
    return {
        "memory": {"argument_gb": mem["argument"] / GB,
                   "output_gb": mem["output"] / GB,
                   "temp_gb": mem["temp"] / GB,
                   "alias_gb": mem["alias"] / GB,
                   "per_device_gb": mem["peak"] / GB},
        "cost": summary["cost"],
        "collectives": summary["collectives"],
        "top_ops": dict(list(summary["by_op"].items())[:TOP_OPS]),
    }


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             out_dir: str | None = None, *,
             device: dev_mod.DeviceLike = "cuda") -> dict:
    """One cell's record (see the module docstring).  ``out_dir``, when
    given, also receives the cell's full per-op totals
    (``<arch>_<shape>_<sp|mp>.ops.json``)."""
    arch = registry.get(arch_id)
    cell_name = f"{arch_id}/{shape_name}"
    if shape_name in arch.skip_shapes:
        return {"cell": cell_name, "status": "skipped",
                "reason": arch.skip_shapes[shape_name]}
    dev = dev_mod.resolve(device)
    # only the sharded HI² cell reads the mesh (its position's share);
    # the mesh's 256 or 512 positions are built once, when it first does
    sharded = arch.shapes[shape_name].kind == "hi2_serve_sharded"
    mesh = production_mesh(multi_pod, dev) if sharded else None
    record: dict = {"cell": cell_name,
                    "mesh": "2x16x16" if multi_pod else "16x16",
                    "n_devices": 1, "device": str(dev), "card": card()}
    t0 = time.perf_counter()
    try:
        cell = cells_mod.build_cell(arch_id, shape_name, mesh, device=dev)
        record["kind"] = cell.kind
        ex = cells_mod.execute(cell)
        record.update(record_of(ex))
        record["fits"] = fits(record["memory"]["per_device_gb"])
        record["status"] = "ok"
        if out_dir:
            tag = "mp" if multi_pod else "sp"
            with open(os.path.join(out_dir, f"{arch_id}_{shape_name}_{tag}"
                                   f".ops.json"), "w") as f:
                json.dump(ex.count.summary()["by_op"], f, indent=1)
        del cell, ex
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        record["status"] = "FAILED"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
    record["seconds"] = time.perf_counter() - t0
    gc.collect()
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--extra", action="store_true",
                    help="include beyond-assignment cells (hi2-synth)")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels' fake paths; needs the card's "
                         "host) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    grid = registry.cells(include_skipped=True,
                          include_extra=args.extra or bool(args.arch))
    if args.arch:
        grid = [(a, s) for a, s in grid if a == args.arch]
    if args.shape:
        grid = [(a, s) for a, s in grid if s == args.shape]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n_fail = 0
    for multi_pod in meshes:
        for arch_id, shape_name in grid:
            rec = run_cell(arch_id, shape_name, multi_pod, args.out,
                           device=args.device)
            tag = "mp" if multi_pod else "sp"
            path = os.path.join(args.out,
                                f"{arch_id}_{shape_name}_{tag}.json")
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            status = rec["status"]
            extra = ""
            if status == "ok":
                terms = roofline.roofline_terms(
                    rec["cost"]["flops"], rec["cost"]["bytes"],
                    rec["collectives"]["total_bytes"], rec["n_devices"])
                extra = (f"mem/dev={rec['memory']['per_device_gb']:.2f}GB "
                         f"fits={rec['fits']} "
                         f"flops={rec['cost']['flops']:.4g} "
                         f"dominant={terms['dominant']} "
                         f"seconds={rec['seconds']:.2f}")
            elif status == "FAILED":
                n_fail += 1
                extra = rec["error"][:200]
            print(f"[{tag}] {arch_id}/{shape_name}: {status} {extra}",
                  flush=True)
    print(f"done, {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()

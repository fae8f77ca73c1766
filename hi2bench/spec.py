"""``BENCHMARK.json`` and the files it names, found by name:

    configs/<config>.json    a configuration's sizes, codec, ServeConfig
                             settings (``serve``), reference module
                             (``reference``) and the limits of the
                             comparison that decides ``correct``
    traffic/<traffic>.json   a traffic mix's parameters, read by the one
                             generator in ``traffic.py``
    metrics/<metric>.py      a metric's reader, end-to-end or per-layer:
                             ``read(ctx)`` returns its value, or None
                             where the run has nothing to read.  A
                             metric split by the end-to-end metric it
                             moves (``<name>.<cells>``) may share the
                             reader of ``<name>``
    counts/<kernel>.py       a kernel's operations and bytes:
                             ``work(**shape)`` → (flops, bytes), at the
                             peak named by its ``PEAK``
    codecs/<codec>.py        a stage-1 codec's planes (``draw``) and the
                             program's parameters of them
                             (``index_params``); its plain score is
                             ``reference/codecs/<codec>.py``
    peaks.json               the card's published peaks

A new cell, configuration, mix, metric or codec is new files and new
entries: nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list     # the BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def config(name: str, here: pathlib.Path = HERE) -> dict:
    cfg = json.loads((here / "configs" / f"{name}.json").read_text())
    if cfg.get("name") != name:
        raise ValueError(f"configs/{name}.json names {cfg.get('name')!r}")
    return cfg


def traffic(name: str, here: pathlib.Path = HERE) -> dict:
    return json.loads((here / "traffic" / f"{name}.json").read_text())


def cell(name: str, bench: dict, here: pathlib.Path = HERE) -> Cell:
    found = [w for w in bench["workloads"] if w["name"] == name]
    if len(found) != 1:
        raise KeyError(f"workload {name!r} is not in BENCHMARK.json")
    w = found[0]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if _reports(m, name) and m["moves"] in moved]
    return Cell(name=name, config=config(w["config"], here),
                traffic=traffic(w["traffic"], here), chips=w["chips"],
                end_to_end=e2e, per_layer=per)


def _merged(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = (_merged(base[k], v) if isinstance(v, dict)
                  and isinstance(base.get(k), dict) else v)
    return out


def sized(d: dict, tiny: bool) -> dict:
    """A configuration or mix, with its ``tiny`` sizes merged in (key by
    key, into nested groups too) when asked."""
    return _merged(d, d.get("tiny", {})) if tiny else dict(d)


def _module(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(
        "hi2bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, here: pathlib.Path = HERE):
    """The ``read(ctx)`` of a metric: ``metrics/<metric>.py``, else the
    reader of the name with its last dotted parts taken off."""
    parts = metric.split(".")
    for n in range(len(parts), 0, -1):
        path = here / "metrics" / (".".join(parts[:n]) + ".py")
        if path.is_file():
            return _module(path).read
    raise KeyError(f"no reader for metric {metric!r} in metrics/")


def codec(name: str, here: pathlib.Path = HERE):
    """A stage-1 codec's file (``ROWS``, ``draw``, ``index_params``)."""
    return _module(here / "codecs" / f"{name}.py")


def counts(kernel: str, here: pathlib.Path = HERE):
    """A kernel's count module (``work``, ``PEAK``)."""
    return _module(here / "counts" / f"{kernel}.py")


def peaks(here: pathlib.Path = HERE) -> dict:
    return json.loads((here / "peaks.json").read_text())


def bound_s(kernel: str, here: pathlib.Path = HERE, **shape) -> float:
    """The least time the card could take for one call of ``kernel``:
    its operations at its peak or its bytes at the memory's, whichever
    is longer."""
    mod, pk = counts(kernel, here), peaks(here)
    flops, nbytes = mod.work(**shape)
    return max(flops / pk[mod.PEAK], nbytes / pk["hbm_bytes_per_s"])

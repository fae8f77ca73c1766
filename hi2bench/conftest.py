"""Shared helpers of the benchmark's CPU tests: tiny configurations and
a runner of the benchmark's scripts in a fresh process (a test process
may already hold modules that a run refuses to print a result beside)."""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
SRC = ROOT / "src"

#: sizes small enough for the brute force and the port's CPU path
MICRO = {"n_docs": 512, "hidden": 16, "n_clusters": 16, "vocab": 64,
         "cluster_capacity": 64, "term_capacity": 32, "pq_m": 4,
         "pq_k": 16, "kc": 3, "k2": 4, "top_r": 5, "query_len": 6}


def micro(config: str) -> dict:
    """A configuration of the benchmark at :data:`MICRO` sizes."""
    from hi2bench import spec
    cfg = spec.config(config)
    cfg.update(MICRO)
    return cfg


def run_script(args, *, cwd=ROOT, pythonpath=(SRC,), code=None,
               timeout=120):
    """(exit code, stdout, stderr) of ``python3 <args>`` (or of ``-c
    code`` with ``args`` as its argv), with PYTHONPATH set to
    ``pythonpath`` alone."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if pythonpath:
        env["PYTHONPATH"] = os.pathsep.join(str(p) for p in pythonpath)
    cmd = [sys.executable] + (["-c", code] if code is not None else []) \
        + [str(a) for a in args]
    p = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                       text=True, timeout=timeout)
    return p.returncode, p.stdout, p.stderr


def last_json(stdout: str) -> dict:
    """The result line: the last line of standard output."""
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.fixture
def cpu():
    import torch
    return torch.device("cpu")

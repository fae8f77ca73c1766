"""The port's serving-load benchmark (``python -m
repro_torch.benchmarks.serving_load``) on the CPU: ``--smoke --check
--device cpu`` exits 0 (runtime rows bit-identical to ``Server.query``,
one program per bucket and none after warmup, at least 2x the serial
rate, every cached query replayed), writes only its ``--out`` file, and
its report has the keys of the reference's ``benchmarks/serving_load.py``
report (read from that file's dict literals).  Also: the fused path's
per-document sums with a static run bound equal the data-driven count
bit for bit, which is what lets a CUDA graph hold them."""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.exec import fusion
from repro_torch.core.inverted_lists import PAD_DOC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(REPO, "benchmarks", "serving_load.py")


def _dict_keys(node: ast.Dict) -> set:
    return {k.value for k in node.keys if k is not None}


def _reference_keys() -> dict:
    """Section → its keys: the top-level ``report`` literal of ``main``,
    the dict ``run_layout`` returns, its ``poisson`` entry (with the
    ``_percentiles`` keys it unpacks) and ``cache_report``."""
    tree = ast.parse(open(REFERENCE).read())
    funcs = {n.name: n for n in ast.walk(tree)
             if isinstance(n, ast.FunctionDef)}
    returned = {name: [n.value for n in ast.walk(funcs[name])
                       if isinstance(n, ast.Return)
                       and isinstance(n.value, ast.Dict)][-1]
                for name in ("run_layout", "_percentiles")}
    assigned = {n.targets[0].id: n.value for n in ast.walk(tree)
                if isinstance(n, ast.Assign)
                and isinstance(n.targets[0], ast.Name)
                and isinstance(n.value, ast.Dict)}
    layout = returned["run_layout"]
    poisson = layout.values[[k.value for k in layout.keys].index("poisson")]
    return {"report": _dict_keys(assigned["report"]),
            "layout": _dict_keys(layout),
            "poisson": (_dict_keys(poisson)
                        | _dict_keys(returned["_percentiles"])),
            "cache": _dict_keys(assigned["cache_report"])}


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("serving")
    out = out_dir / "report.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.serving_load",
         "--smoke", "--check", "--device", "cpu", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=600, cwd=out_dir)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert sorted(os.listdir(out_dir)) == ["report.json"]
    printed = json.loads(r.stdout)
    assert json.loads(out.read_text()) == printed
    return printed


def test_serving_smoke_check_passes_on_cpu(report):
    assert report["bench"] == "serving" and report["smoke"] is True
    assert report["device"] == "cpu"
    assert sorted(report["layouts"]) == ["mutable", "plain", "sharded", "sharded_mutable"]
    for name, rep in report["layouts"].items():
        assert rep["bit_identical"] and rep["bit_identical_filtered"], name
        assert rep["buckets"] == [1, 2, 4, 8, 16, 32]
        assert set(rep["warm_compiles"].values()) == {1}
        assert rep["post_warmup_compiles"] == 0
        assert rep["qps_runtime"] >= 2 * rep["qps_serial"]
        assert rep["cache"] == {"queries": 32, "hits": 32,
                                "bit_identical": True}
        assert rep["mutable"] == (name in ("mutable", "sharded_mutable"))


def test_serving_report_has_the_reference_keys(report):
    want = _reference_keys()
    assert set(report) == want["report"] | {"device"}
    for rep in report["layouts"].values():
        assert set(rep) == want["layout"]
        assert set(rep["poisson"]) == want["poisson"]
        assert set(rep["cache"]) == want["cache"]


def test_sharded_layouts_serve_through_the_runtime_over_a_mesh(report):
    """The sharded and sharded mutable layouts (two CPU mesh positions)
    pass the same contracts as the single-device ones: rows bitwise
    equal to their server's, one program per bucket of the 1-D ladder."""
    from repro_torch.benchmarks import serving_load
    assert serving_load.LAYOUTS == ("plain", "sharded", "mutable",
                                    "sharded_mutable")
    assert not hasattr(serving_load, "UNPORTED_LAYOUTS")
    for name in ("sharded", "sharded_mutable"):
        rep = report["layouts"][name]
        assert rep["shards"] == 2 and rep["layout"] == name
        assert rep["bit_identical"] and rep["bit_identical_filtered"]
        assert rep["warm_compiles"] == {str(b): 1 for b in rep["buckets"]}
    assert report["layouts"]["plain"]["shards"] == 1


@pytest.mark.parametrize("extra", [0, 1, 5])
def test_sum_by_doc_with_a_bound_equals_the_data_driven_sums(extra):
    """Rows of repeated ids among PAD slots; a bound at the longest run
    or above adds masked zeros only, so every output is bitwise the
    data-driven one's."""
    rng = np.random.default_rng(extra)
    ids = rng.integers(0, 40, (6, 96))
    ids[rng.random(ids.shape) < 0.3] = PAD_DOC
    ids[0, :4] = 7                        # a run of at least 4
    vals = np.where(ids == PAD_DOC, 0.0, rng.random(ids.shape)
                    ).astype(np.float32)
    ids_t, vals_t = torch.from_numpy(ids), torch.from_numpy(vals)
    want = fusion.sum_by_doc(ids_t, vals_t)
    longest = max(np.bincount(r[r >= 0]).max() for r in ids)
    got = fusion.sum_by_doc(ids_t, vals_t, longest=int(longest) + extra)
    for w, g in zip(want, got):
        assert torch.equal(w, g)

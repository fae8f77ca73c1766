"""The port's autotune benchmark (``python -m
repro_torch.benchmarks.autotune``) on the CPU: ``--smoke --check
--device cpu`` exits 0 (contracts (a)-(e): the tune meets its target
below the default's cost, the adaptive ladder is no dearer at no lower
recall, explicit widths are bit-identical on the plain, sharded,
mutable and sharded mutable layouts, one program per (bucket, rung) and none after warmup, no
cross-rung cache replay), writes only its ``--out`` file, and its report
has the keys of the reference's ``benchmarks/autotune.py`` report (read
from that file's dict literals)."""
import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(REPO, "benchmarks", "autotune.py")


def _dict_keys(node: ast.Dict) -> set:
    return {k.value for k in node.keys if k is not None}


def _reference_keys() -> dict:
    """Section → its keys: ``main``'s report literal, ``run_tune``'s
    (with its ``default``, ``adaptive`` and frontier entries), the dict
    ``run_variants`` stores per layout and the one ``run_runtime``
    returns."""
    tree = ast.parse(open(REFERENCE).read())
    funcs = {n.name: n for n in ast.walk(tree)
             if isinstance(n, ast.FunctionDef)}

    def assigned(func, target_type):
        return [n.value for n in ast.walk(funcs[func])
                if isinstance(n, ast.Assign)
                and isinstance(n.targets[0], target_type)
                and isinstance(n.value, ast.Dict)][-1]

    tune = assigned("run_tune", ast.Name)
    fields = dict(zip([k.value for k in tune.keys], tune.values))
    return {
        "report": _dict_keys(assigned("main", ast.Name)) | _dict_keys(tune),
        "default": _dict_keys(fields["default"]),
        "adaptive": _dict_keys(fields["adaptive"]),
        "frontier": _dict_keys(fields["pareto_frontier"].elt),
        "variant": _dict_keys(assigned("run_variants", ast.Subscript)),
        "runtime": [_dict_keys(n.value) for n in
                    ast.walk(funcs["run_runtime"])
                    if isinstance(n, ast.Return)
                    and isinstance(n.value, ast.Dict)][-1],
    }


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("autotune")
    out = out_dir / "report.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.autotune",
         "--smoke", "--check", "--device", "cpu", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=600, cwd=out_dir)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert sorted(os.listdir(out_dir)) == ["report.json"]
    printed = json.loads(r.stdout)
    assert json.loads(out.read_text()) == printed
    return printed


def test_autotune_smoke_check_passes_on_cpu(report):
    assert report["bench"] == "autotune" and report["smoke"] is True
    assert report["device"] == "cpu"
    tuned, default = report["tuned"], report["default"]
    assert tuned["recall"] >= report["recall_target"]
    assert tuned["cost"] < default["cost"]
    assert report["adaptive"]["n_rungs"] == len(tuned["rungs"]) >= 2
    assert report["adaptive"]["mean_cost"] <= tuned["cost"]
    assert sorted(report["variants"]) == ["mutable", "plain", "sharded", "sharded_mutable"]
    for rep in report["variants"].values():
        assert rep["explicit_equals_direct"] and rep["default_equals_explicit"]
        assert rep["width_source_default_cfg"] == "default"
    rt = report["runtime"]
    assert rt["width_source"] == "tuned"
    assert rt["buckets"] == [1, 2, 4, 8, 16, 32]
    assert len(rt["warm_compiles"]) == len(rt["buckets"]) * len(rt["rungs"])
    assert set(rt["warm_compiles"].values()) == {1}
    assert rt["post_warmup_compiles"] == 0
    assert all(v > 0 for v in rt["rung_dispatch"].values())
    assert rt["per_rung_bit_identical"] and rt["replay_bit_identical"]
    assert rt["replay_hits"] == rt["replay_queries"]
    assert rt["cross_rung_key_distinct"]


def test_autotune_report_has_the_reference_keys(report):
    want = _reference_keys()
    assert set(report) == want["report"] | {"device"}
    assert set(report["default"]) == want["default"]
    assert set(report["adaptive"]) == want["adaptive"]
    assert all(set(p) == want["frontier"]
               for p in report["pareto_frontier"])
    for rep in report["variants"].values():
        assert set(rep) == want["variant"]
    assert set(report["runtime"]) == want["runtime"]


def test_sharded_layouts_serve_explicit_widths_bit_identically(report):
    """The sharded and sharded mutable variants (two CPU mesh positions)
    resolve the default widths from the unsharded index and serve the
    direct search's rows."""
    from repro_torch.benchmarks import autotune
    assert autotune.LAYOUTS == ("plain", "sharded", "mutable",
                                "sharded_mutable")
    assert not hasattr(autotune, "UNPORTED_LAYOUTS")
    plain = report["variants"]["plain"]
    for name in ("sharded", "sharded_mutable"):
        rep = report["variants"][name]
        assert rep["explicit_equals_direct"], name
        assert rep["default_equals_explicit"], name
        assert rep["resolved_widths"] == plain["resolved_widths"]

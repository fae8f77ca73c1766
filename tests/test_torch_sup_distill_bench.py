"""The port's supervised distillation benchmark (``python -m
repro_torch.benchmarks.sup_distill``) on the CPU: ``--smoke --check
--device cpu`` exits 0 (contracts (a)-(d): sup recall >= unsup at
matched cost somewhere, the windowed loss means fall, the index
checkpoint round trip is bit-identical, the plain, sharded, mutable
and sharded mutable layouts agree and the supervised add → delete → compact lifecycle holds),
writes only its ``--out`` file, and its report has the keys of the
reference's ``benchmarks/sup_distill.py`` report (read from that
file's dict literals)."""
import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(REPO, "benchmarks", "sup_distill.py")


def _dict_keys(node: ast.Dict) -> set:
    return {k.value for k in node.keys if k is not None}


def _reference_keys() -> dict:
    """Section → its keys, from the reference's dict literals: ``main``'s
    report with ``run_train_sweep``'s returned fields, each operating
    point, the trajectory, the round trip, the negative pool, and the
    per-layout and lifecycle entries of ``run_variants``."""
    tree = ast.parse(open(REFERENCE).read())
    funcs = {n.name: n for n in ast.walk(tree)
             if isinstance(n, ast.FunctionDef)}

    def dicts(func):
        return [n for n in ast.walk(funcs[func]) if isinstance(n, ast.Dict)]

    def assigned(func, name):
        return [n.value for n in ast.walk(funcs[func])
                if isinstance(n, ast.Assign)
                and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id == name][-1]

    sweep = [n.value for n in ast.walk(funcs["run_train_sweep"])
             if isinstance(n, ast.Return)][-1]
    fields = dict(zip([k.value for k in sweep.keys], sweep.values))
    point = [d for d in dicts("run_train_sweep")
             if "recall_sup" in _dict_keys(d)][0]
    subscripted = [n for n in ast.walk(funcs["run_variants"])
                   if isinstance(n, ast.Assign)
                   and isinstance(n.targets[0], ast.Subscript)]
    lifecycle = [n.value for n in subscripted
                 if getattr(n.targets[0].slice, "value", None)
                 == "mutable_lifecycle"][0]
    layout = [n.value for n in subscripted
              if getattr(n.targets[0].slice, "value", None) == "plain"][0]
    return {
        "report": _dict_keys(assigned("main", "report")) | set(fields),
        "point": _dict_keys(point),
        "trajectory": _dict_keys(assigned("run_train_sweep", "trajectory")),
        "roundtrip": _dict_keys(assigned("run_train_sweep", "roundtrip")),
        "negative_pool": _dict_keys(fields["negative_pool"]),
        "layout": _dict_keys(layout),
        "lifecycle": _dict_keys(lifecycle),
    }


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("sup_distill")
    out = out_dir / "report.json"
    # two threads, as the in-process tests use: the suite runs its files
    # side by side, and some of them time their own batching
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.sup_distill",
         "--smoke", "--check", "--device", "cpu", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=600, cwd=out_dir)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert sorted(os.listdir(out_dir)) == ["report.json"]
    printed = json.loads(r.stdout)
    assert json.loads(out.read_text()) == printed
    return printed


def test_sup_distill_smoke_check_passes_on_cpu(report):
    assert report["bench"] == "sup_distill" and report["smoke"] is True
    assert report["device"] == "cpu"
    points = report["operating_points"]
    assert len(points) == report["n_operating_points"] == 6
    assert all(p["cost_sup"] == p["cost_unsup"] for p in points)
    assert report["sup_wins"] == sum(p["recall_sup"] >= p["recall_unsup"]
                                     for p in points) >= 1
    traj = report["trajectory"]
    assert traj["n_steps"] == 160 and traj["loss_last"] < traj["loss_first"]
    assert traj["frac_improving_windows"] >= 0.7
    assert report["roundtrip"] == {"planes_bit_identical": True,
                                   "search_bit_identical": True}
    assert report["negative_pool"] == {"topic": 7, "mined": 7,
                                       "in_batch": 4}
    var = report["variants"]
    assert sorted(var) == ["mutable", "mutable_lifecycle", "plain",
                           "sharded", "sharded_mutable"]
    assert all(var[k]["ids_identical"] for k in ("plain", "sharded",
                                                 "mutable",
                                                 "sharded_mutable"))
    life = var["mutable_lifecycle"]
    assert life["n_live_after"] == life["expected_live"] == 2500 + 16 - 12
    assert life["compact_equals_scratch"]


def test_sup_distill_report_has_the_reference_keys(report):
    want = _reference_keys()
    assert set(report) == want["report"] | {"device"}
    assert all(set(p) == want["point"] for p in report["operating_points"])
    assert set(report["trajectory"]) == want["trajectory"]
    assert set(report["roundtrip"]) == want["roundtrip"]
    assert set(report["negative_pool"]) == want["negative_pool"]
    for layout in ("plain", "sharded", "mutable", "sharded_mutable"):
        assert set(report["variants"][layout]) == want["layout"]
    assert set(report["variants"]["mutable_lifecycle"]) == want["lifecycle"]


def test_sharded_layouts_agree_with_the_plain_supervised_search(report):
    """The trained selectors drive the sharded and sharded mutable
    layouts (two CPU mesh positions) to the plain supervised search's
    doc ids, as the reference's variants stage does."""
    from repro_torch.benchmarks import sup_distill
    assert sup_distill.LAYOUTS == ("plain", "sharded", "mutable",
                                   "sharded_mutable")
    assert not hasattr(sup_distill, "UNPORTED_LAYOUTS")
    for layout in ("sharded", "sharded_mutable"):
        assert report["variants"][layout] == {"ids_identical": True}

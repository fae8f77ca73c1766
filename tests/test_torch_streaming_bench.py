"""The port's streaming-updates benchmark (``python -m
repro_torch.benchmarks.streaming_updates``) on the CPU: ``--smoke --check
--device cpu`` exits 0 (no tombstoned doc surfaced, the compacted index
equals the rebuild), writes only its ``--out`` file, and its report has
the keys of the reference's ``benchmarks/streaming_updates.py`` report
(read from that file's ``report`` literal and ``point`` helper)."""
import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(REPO, "benchmarks", "streaming_updates.py")


def _reference_keys() -> dict:
    """Section → its keys, from the dict literals of the reference's
    ``run`` (``report = {...}``, ``report["deletes"] = {...}``, the dict
    ``point`` returns) plus the two scalar keys it sets one by one."""
    keys = {}
    for node in ast.walk(ast.parse(open(REFERENCE).read())):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            target = node.targets[0]
            name = ("report" if isinstance(target, ast.Name)
                    else target.slice.value)
            keys[name] = {k.value for k in node.value.keys}
        elif isinstance(node, ast.FunctionDef) and node.name == "point":
            ret = [n for n in ast.walk(node) if isinstance(n, ast.Return)]
            keys["points"] = {k.value for k in ret[0].value.keys}
    keys["report"] |= {"add_seconds_total", "dropped_postings", "deletes",
                       "compaction"}
    return keys


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("streaming")
    out = out_dir / "report.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.streaming_updates",
         "--smoke", "--check", "--device", "cpu", "--codec", "opq",
         "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=600, cwd=out_dir)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert sorted(os.listdir(out_dir)) == ["report.json"]
    printed = json.loads(r.stdout)
    assert json.loads(out.read_text()) == printed
    return printed


def test_streaming_smoke_check_passes_on_cpu(report):
    assert report["bench"] == "streaming" and report["smoke"] is True
    assert report["codec"] == "opq"
    assert report["deletes"]["tombstones_absent"] is True
    assert report["compaction"]["equal_to_rebuild"] is True
    fills = [p["fill_fraction"] for p in report["points"]]
    assert fills == [0.0, 0.25, 0.5, 1.0]
    assert [p["delta_docs"] for p in report["points"]] == [0, 128, 256, 512]
    assert report["compaction"]["n_live"] == 4000 - 512 // 4
    assert (report["candidate_budget_mutable"]
            > report["candidate_budget_base"])
    for p in report["points"]:
        assert p["search_us_per_batch"] > 0 and 0 < p["R@100"] <= 1


def test_streaming_report_has_the_reference_keys(report):
    want = _reference_keys()
    assert set(report) == want["report"]
    for section in ("deletes", "compaction"):
        assert set(report[section]) == want[section], section
    for p in report["points"]:
        assert set(p) == want["points"]

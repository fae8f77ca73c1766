"""The port's bench regression gate
(``src/repro_torch/benchmarks/check_regression.py``) against the
reference's (``benchmarks/check_regression.py``): ``timing_direction``,
``compare`` and ``check_files`` give equal results on the same
documents, built here (not read from ``results/``); the CLI's exit codes
and messages; ``--baseline-dir`` has no default; and two CPU runs of the
port's ``kernel_bench`` gate clean on their exact fields."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

_ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_ROOT))

from benchmarks import check_regression as ref_cr        # noqa: E402
from repro_torch.benchmarks import check_regression as cr  # noqa: E402

BASE = {"rows": [{"codec": "flat", "R@100": 0.9609375,
                  "candidate_cost": 1920, "index_bytes": 5_120_000},
                 {"codec": "pq", "R@100": 0.875, "candidate_cost": 2048,
                  "index_bytes": 160_000}],
        "baseline": {"us_per_batch": 1000.0, "qps": 64.0,
                     "build_seconds": 2.5},
        "flags": {"equal_to_rebuild": True, "tombstones_absent": True},
        "note": "smoke", "missing_value": None}


def _edit(fn):
    doc = json.loads(json.dumps(BASE))
    fn(doc)
    return doc


def _set(path, value):
    def fn(doc):
        node = doc
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value
    return fn


def _del(path):
    def fn(doc):
        node = doc
        for k in path[:-1]:
            node = node[k]
        del node[path[-1]]
    return fn


# (case, baseline, fresh, timing_ratio, failures expected)
CASES = [
    ("identical", BASE, BASE, 4.0, 0),
    ("one_ulp_recall", BASE,
     _edit(_set(("rows", 0, "R@100"), 0.9609374999999999)), 4.0, 1),
    ("3.5x_slower_batch", BASE,
     _edit(_set(("baseline", "us_per_batch"), 3500.0)), 4.0, 0),
    ("5x_slower_batch", BASE,
     _edit(_set(("baseline", "us_per_batch"), 5000.0)), 4.0, 1),
    ("faster_qps", BASE, _edit(_set(("baseline", "qps"), 1000.0)), 4.0, 0),
    ("slower_qps", BASE, _edit(_set(("baseline", "qps"), 10.0)), 4.0, 1),
    ("5x_slower_batch_inf_ratio", BASE,
     _edit(_set(("baseline", "us_per_batch"), 5000.0)), float("inf"), 0),
    ("flag_flip", BASE,
     _edit(_set(("flags", "equal_to_rebuild"), False)), 4.0, 1),
    ("missing_key", BASE, _edit(_del(("rows", 0, "candidate_cost"))),
     4.0, 1),
    ("added_key", BASE, _edit(_set(("rows", 1, "new_field"), 1)), 4.0, 1),
    ("list_length", BASE, _edit(lambda d: d["rows"].pop()), 4.0, 1),
    ("int_to_float", BASE,
     _edit(_set(("rows", 0, "candidate_cost"), 1920.0)), 4.0, 0),
    ("int_to_float_drift", BASE,
     _edit(_set(("rows", 0, "candidate_cost"), 1920.5)), 4.0, 1),
    ("bool_to_int", BASE,
     _edit(_set(("flags", "tombstones_absent"), 1)), 4.0, 1),
    ("int_to_bool", BASE,
     _edit(_set(("rows", 1, "candidate_cost"), True)), 4.0, 1),
    ("string_change", BASE, _edit(_set(("note",), "full")), 4.0, 1),
    ("none_to_number", BASE, _edit(_set(("missing_value",), 0)), 4.0, 1),
    ("many_at_once", BASE,
     _edit(lambda d: (_set(("flags", "equal_to_rebuild"), False)(d),
                      _del(("rows", 0, "candidate_cost"))(d),
                      _set(("rows", 0, "new_field"), 1)(d),
                      _set(("baseline", "build_seconds"), 20.0)(d))),
     4.0, 4),
]


def _write(d: pathlib.Path, name: str, doc) -> None:
    d.mkdir(parents=True, exist_ok=True)
    (d / name).write_text(json.dumps(doc))


@pytest.mark.parametrize("case,baseline,fresh,ratio,n_fails", CASES,
                         ids=[c[0] for c in CASES])
def test_gate_equals_the_reference(tmp_path, case, baseline, fresh, ratio,
                                   n_fails):
    kw = dict(timing_ratio=ratio, float_tol=0.0)
    got = cr.compare(baseline, fresh, **kw)
    assert got == ref_cr.compare(baseline, fresh, **kw)
    assert len(got) == n_fails, got
    _write(tmp_path / "base", "x.json", baseline)
    _write(tmp_path / "fresh", "x.json", fresh)
    args = (str(tmp_path / "base"), str(tmp_path / "fresh"), ["x.json"])
    got = cr.check_files(*args, **kw)
    assert got == ref_cr.check_files(*args, **kw)
    assert all(msg.startswith("x.json $") for msg in got)
    assert len(got) == n_fails, got


@pytest.mark.parametrize("missing", ["baseline", "fresh", "both"])
def test_gate_missing_files_equal_the_reference(tmp_path, missing):
    b, f = tmp_path / "base", tmp_path / "fresh"
    b.mkdir(), f.mkdir()
    if missing != "baseline" and missing != "both":
        _write(b, "x.json", BASE)
    if missing != "fresh" and missing != "both":
        _write(f, "x.json", BASE)
    _write(b, "y.json", BASE)
    _write(f, "y.json", BASE)
    kw = dict(timing_ratio=4.0, float_tol=0.0)
    got = cr.check_files(str(b), str(f), ["x.json", "y.json"], **kw)
    assert got == ref_cr.check_files(str(b), str(f), ["x.json", "y.json"],
                                     **kw)
    assert len(got) == 1 and got[0].startswith("x.json: ")
    assert ("no committed baseline" if missing != "fresh"
            else "fresh run missing") in got[0]


def test_timing_direction_equals_the_reference():
    keys = ["us_per_batch", "add_seconds_total", "base_build_seconds",
            "search_us_per_batch", "qps", "qps_runtime", "speedup",
            "speedup_vs_baseline", "fused_us_per_call", "p99_ms",
            "replay_us", "wall_s", "seconds", "us", "R@100", "MRR@10",
            "candidate_cost", "delta_docs", "mean_candidates", "n_live",
            "fill_fraction", "index_bytes", "cost_sup", "sup_wins",
            "n_rungs", "recall", "status", "bits"]
    got = {k: cr.timing_direction(k) for k in keys}
    assert got == {k: ref_cr.timing_direction(k) for k in keys}
    assert got["us_per_batch"] == "lower" and got["qps"] == "higher"
    assert got["R@100"] is None and got["candidate_cost"] is None
    assert cr.DEFAULT_FILES == ref_cr.DEFAULT_FILES


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(_ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.check_regression",
         *args], env=env, capture_output=True, text=True, timeout=60)


def test_gate_cli_exit_codes_and_messages(tmp_path):
    b, f = tmp_path / "base", tmp_path / "fresh"
    _write(b, "x.json", BASE)
    _write(f, "x.json", BASE)
    ok = _cli("--baseline-dir", str(b), "--fresh-dir", str(f),
              "--files", "x.json")
    assert ok.returncode == 0, ok.stderr
    assert ok.stdout.startswith("ok: x.json match the baselines in "
                                f"{b}/ (timing within 4.0x)")
    _write(f, "x.json", CASES[-1][2])
    bad = _cli("--baseline-dir", str(b), "--fresh-dir", str(f),
               "--files", "x.json", "y.json")
    assert bad.returncode == 1 and bad.stdout == ""
    lines = bad.stderr.splitlines()
    assert lines[0] == f"REGRESSION: 5 mismatch(es) vs {b}/"
    want = ref_cr.check_files(str(b), str(f), ["x.json", "y.json"],
                              timing_ratio=4.0, float_tol=0.0)
    assert lines[1:] == [f"  {msg}" for msg in want]
    # no default baseline directory: the port never reads results/
    none = _cli("--fresh-dir", str(f))
    assert none.returncode == 2
    assert "--baseline-dir" in none.stderr and "required" in none.stderr


def test_two_cpu_runs_of_kernel_bench_gate_clean(tmp_path):
    """Two processes' ``kernel_bench --smoke --check`` reports agree on
    every exact field.  Their wall-clock fields are not held
    (``--timing-ratio inf``): on a shared CPU one of them,
    ``assign_topk.unfused_us_per_call``, has swung 25x between two
    otherwise idle runs."""
    env = dict(os.environ, PYTHONPATH=str(_ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.benchmarks.kernel_bench",
         "--smoke", "--check", "--device", "cpu", "--out",
         str(tmp_path / run / "BENCH_kernels.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for run in "ab"]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    gate = _cli("--baseline-dir", str(tmp_path / "a"), "--fresh-dir",
                str(tmp_path / "b"), "--files", "BENCH_kernels.json",
                "--timing-ratio", "inf")
    assert gate.returncode == 0, gate.stderr
    a = json.loads((tmp_path / "a" / "BENCH_kernels.json").read_text())
    assert a["interpret_mode"] is True and not a["check_failures"]

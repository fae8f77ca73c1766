"""The port's kernel benchmark (``python -m
repro_torch.benchmarks.kernel_bench``) on the CPU: ``--smoke --check
--device cpu`` exits 0 with no check failure, and its report has the
keys and shapes of the reference's ``benchmarks/kernel_bench.py``
report (``c_blk`` is null: the CUDA kernels have no TPU tile).  The
reference report is built from the reference's own section functions
at the smoke shapes, so a key it adds shows up here."""
import importlib.util
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SPEC = importlib.util.spec_from_file_location(
    "reference_kernel_bench", os.path.join(REPO, "benchmarks",
                                           "kernel_bench.py"))
jbench = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(jbench)


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return type(tree).__name__


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    out = tmp_path_factory.mktemp("kernel_bench") / "report.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.kernel_bench",
         "--smoke", "--check", "--device", "cpu", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=600, cwd=REPO)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    printed = json.loads(r.stdout)
    assert json.loads(out.read_text()) == printed
    return printed


def test_kernel_bench_smoke_check_passes_on_cpu(report):
    assert report["check_failures"] == []
    assert report["bench"] == "kernels" and report["smoke"] is True
    assert report["backend"] == "cpu" and report["interpret_mode"] is True
    for section in ("pq_adc", "sq8_dot", "assign_topk"):
        for key, val in report[section].items():
            if key.endswith("_us_per_call"):
                assert val > 0, (section, key)


def test_kernel_bench_report_has_the_reference_keys_and_shapes(report):
    want = dict(bench="kernels", smoke=True,
                backend="cpu", interpret_mode=True,
                pq_adc=jbench._bench_pq_adc(b=8, m=4, k=64, n=4000, c=512,
                                            c_blk=128),
                sq8_dot=jbench._bench_sq8(b=8, h=32, n=4000, c=512,
                                          c_blk=128),
                assign_topk=jbench._bench_topk(b=8, l=128, h=32, k=6),
                check_failures=[])
    assert set(report) == set(want)
    for section in ("pq_adc", "sq8_dot", "assign_topk"):
        assert set(report[section]) == set(want[section]), section
        shape = dict(want[section]["shape"])
        if "c_blk" in shape:
            shape["c_blk"] = None
        assert report[section]["shape"] == shape, section
        for key, val in want[section].items():
            if isinstance(val, bool):
                assert report[section][key] is True, (section, key)

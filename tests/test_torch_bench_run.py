"""The port's bench driver (``src/repro_torch/benchmarks/run.py``) against
the reference's (``benchmarks/run.py``): the same dispatch table, the
coverage guard over the port's modules on disk, every row printer fed
the same report printing the same lines, the subprocess arguments (the
reference's plus ``--device``), and one real driver run on the CPU."""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

_ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(_ROOT))

from benchmarks import run as ref_run                    # noqa: E402
from repro_torch.benchmarks import run as port_run      # noqa: E402

CPU = torch.device("cpu")


def test_dispatch_keys_equal_the_reference():
    assert set(port_run.DISPATCH) == set(ref_run.DISPATCH)
    assert len(port_run.DISPATCH) == 14


def test_modules_on_disk_are_benchmarks_helpers_or_tools():
    on_disk = {p.stem for p in
               (_ROOT / "src" / "repro_torch" / "benchmarks").glob("*.py")}
    names = set(port_run.discovered())
    assert names == set(port_run.DISPATCH)
    assert names | port_run.HELPER_MODULES | set(port_run.TOOL_MODULES) \
        == on_disk
    assert not names & port_run.HELPER_MODULES
    assert not port_run.HELPER_MODULES & set(port_run.TOOL_MODULES)
    assert ref_run.HELPER_MODULES <= port_run.HELPER_MODULES
    # the port's diagnostics have no reference counterpart
    ref_disk = {p.stem for p in (_ROOT / "benchmarks").glob("*.py")}
    assert not set(port_run.TOOL_MODULES) & ref_disk


def test_list_prints_the_reference_names(capsys):
    port_run.main(["--list"])
    assert capsys.readouterr().out.split() == sorted(ref_run.DISPATCH)


def test_driver_reports_all_dispatch_problems(monkeypatch):
    """A removed row and a ghost row are named in one exit."""
    patched = dict(port_run.DISPATCH)
    del patched["autotune"]                     # on disk, no entry
    patched["ghost_bench"] = lambda dev: None   # entry, no file
    monkeypatch.setattr(port_run, "DISPATCH", patched)
    with pytest.raises(SystemExit) as e:
        port_run.main(["--list"])
    msg = str(e.value)
    assert "autotune" in msg and "ghost_bench" in msg


def test_driver_names_a_new_module_without_a_row(monkeypatch, tmp_path):
    for p in port_run._DIR.glob("*.py"):
        (tmp_path / p.name).symlink_to(p)
    (tmp_path / "new_bench.py").write_text("")
    monkeypatch.setattr(port_run, "_DIR", tmp_path)
    with pytest.raises(SystemExit) as e:
        port_run.main(["--list"])
    assert "new_bench" in str(e.value)


def test_unknown_benchmark_is_refused():
    with pytest.raises(SystemExit) as e:
        port_run.main(["--only", "no_such_bench", "--device", "cpu"])
    assert "no_such_bench" in str(e.value)


# --- row printers -----------------------------------------------------

def _bench(us, **kw):
    return dict(fused_us_per_call=us, unfused_us_per_call=us * 1.5,
                c_blk=None, n_candidates=131072, **kw)


REPORTS = {
    "sharded_search": {
        "baseline": {"us_per_batch": 11390.4, "qps": 5619.3},
        "sharded": [{"shards": 2, "us_per_batch": 21913.2,
                     "doc_ids_identical": True,
                     "speedup_vs_baseline": 0.52}]},
    "filtered_search": {
        "points": [{"pass_rate": r, "search_us_per_batch": 9015.3 + r,
                    "R@R_vs_filtered_oracle": 0.3392 * r,
                    "mean_candidates": 436.4 * r,
                    "tenant_isolated": r != 0.0625}
                   for r in (1.0, 0.5, 0.25, 0.125, 0.0625)],
        "allow_all_equals_unfiltered": True},
    "streaming_updates": {
        "points": [{"fill_fraction": f, "search_us_per_batch": 8254.4 + f,
                    "R@100": 0.75 + f / 10}
                   for f in (0.0, 0.25, 0.5, 1.0)],
        "compaction": {"seconds": 0.3701, "equal_to_rebuild": True},
        "deletes": {"tombstones_absent": False}},
    "serving_load": {"layouts": {
        name: {"qps_runtime": 3141.5 + i, "qps_serial": 124.2,
               "bit_identical": True, "poisson": {"p99_ms": 19.73 + i},
               "cache": {"hits": 32}}
        for i, name in enumerate(("plain", "sharded", "mutable",
                                  "sharded_mutable"))}},
    "mesh_serving": {
        "geometries": {g: {"us_per_batch": 14803.2 + i,
                           "qps_emulated": 2161.8 * (i + 1),
                           "runtime_bit_identical": True,
                           "poisson": {"p99_ms": 7.57 + i}}
                       for i, g in enumerate(("1x1", "2x1", "4x1", "1x2",
                                              "2x2"))},
        "failover": {"partial_flagged": True,
                     "rejoin_bit_identical": True}},
    "hybrid_fusion": {
        "top_r": 100,
        "dense_only": {"search_us_per_batch": 8626.2, "R@100": 0.765625},
        "points": [{"fusion_weight": w, "search_us_per_batch": 13806.1 + w,
                    "R@100": 0.75 + w / 20}
                   for w in (0.0, 0.25, 0.5, 0.75, 1.0)],
        "best_weight": 0.25, "fused_ge_dense": True,
        "fallback_equals_dense": True},
    "autotune": {
        "tuned": {"kc": 4, "k2": 6, "refine_mult": 4, "cost": 3024,
                  "recall": 0.9309},
        "default": {"cost": 4240, "recall": 0.96212},
        "adaptive": {"n_rungs": 2, "mean_cost": 2900.5, "recall": 0.93},
        "runtime": {"warm_compiles": {str(b): 1 for b in range(12)},
                    "post_warmup_compiles": 0,
                    "per_rung_bit_identical": True}},
    "sup_distill": {
        "trajectory": {"n_steps": 160, "loss_first": 3.35541,
                       "loss_last": 3.08501,
                       "frac_improving_windows": 1.0},
        "top_r": 100,
        "operating_points": [{"kc": kc, "k2": k2, "cost_sup": 704 * kc,
                              "recall_unsup": 0.2958 + kc / 100,
                              "recall_sup": 0.3219 + kc / 90}
                             for kc, k2 in ((1, 2), (2, 4), (12, 16))],
        "variants": {"mutable_lifecycle": {"compact_equals_scratch": True}},
        "sup_wins": 3, "n_operating_points": 6,
        "roundtrip": {"planes_bit_identical": True}},
    "kernel_bench": {
        "backend": "cpu",
        "pq_adc": _bench(170.4, fused_matches_ref=True,
                         unfused_matches_ref=True,
                         qps_candidates_fused=24086986.0,
                         qps_candidates_unfused=26511556.0),
        "sq8_dot": _bench(143.6, fused_matches_ref=True,
                          qps_candidates_fused=28732837.0),
        "assign_topk": _bench(82.2, ids_bit_identical=True,
                              scores_match=False)},
}

#: reference module → what its ``run()`` returns, and the port's call
TABLES = {
    "table1_main": [dict(method=m, **{"R@100": 0.9588 - i / 50,
                                      "MRR@10": 0.7908 - i / 70},
                         candidates=20000.0 / (i + 1),
                         index_bytes=5_120_000 - i * 4096)
                    for i, m in enumerate(("Flat(brute force)", "IVF-OPQ",
                                           "HI2_sup"))],
    "table2_robustness": [dict(model=m, method=meth, R100=0.95 - i / 9)
                          for i, (m, meth) in enumerate(
                              (("encA", "Flat"), ("encB(weaker)",
                                                  "HI2_unsup")))],
    "table3_codec": [dict(codec=c, **{"R@100": 0.9 + i / 100},
                          index_bytes=4_700_000 // (i + 1))
                     for i, c in enumerate(("flat", "pq", "refine:pq:4"))],
    "fig3_tradeoff": {"IVF-OPQ": [(105.4, 0.78), (183.2, 0.79625)],
                      "HI2_sup": [(203.0, 0.7925)]},
    "fig4_ablation": {"HI2(full)": [(134.2, 0.84875), (284.0, 0.88125)]},
}


def _printed(fn, capsys, *args) -> list:
    fn(*args)
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("name", sorted(REPORTS))
def test_subprocess_rows_equal_the_reference(name, monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(ref_run, "_subprocess_json",
                        lambda module, args: (calls.append((module, args)),
                                              REPORTS[name])[1])
    monkeypatch.setattr(port_run, "_subprocess_json",
                        lambda module, args, dev: (
                            calls.append((module, args, dev)),
                            REPORTS[name])[1])
    want = _printed(ref_run.DISPATCH[name], capsys)
    got = _printed(port_run.DISPATCH[name], capsys, CPU)
    assert got == want and len(got) >= 2
    (ref_mod, ref_args), (mod, args, dev) = calls
    assert mod == ref_mod == name and args == ref_args and dev == CPU


@pytest.mark.parametrize("name", sorted(TABLES))
def test_table_rows_equal_the_reference(name, monkeypatch, capsys):
    import importlib
    ref_mod = importlib.import_module(f"benchmarks.{name}")
    port_mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
    kwargs = []
    monkeypatch.setattr(ref_mod, "run", lambda: TABLES[name])
    monkeypatch.setattr(port_mod, "run",
                        lambda **kw: (kwargs.append(kw), TABLES[name])[1])
    want = _printed(ref_run.DISPATCH[name], capsys)
    got = _printed(port_run.DISPATCH[name], capsys, CPU)
    assert got == want and len(got) >= 1
    # Table 3 at its full size, as the reference's run() defaults
    assert kwargs == [dict(device=CPU, **({"smoke": False}
                                          if name == "table3_codec"
                                          else {}))]


def test_subprocess_json_runs_the_port_module_with_device(monkeypatch):
    seen = {}

    def fake_run(cmd, **kw):
        seen.update(cmd=cmd, **kw)
        return subprocess.CompletedProcess(cmd, 0, 'a note\n{"a": 1}\n',
                                           "")

    monkeypatch.setattr(port_run.subprocess, "run", fake_run)
    monkeypatch.setenv("PYTHONPATH", "elsewhere")
    assert port_run._subprocess_json("sharded_search", ["--x"],
                                     CPU) == {"a": 1}
    assert seen["cmd"] == [sys.executable, "-m",
                           "repro_torch.benchmarks.sharded_search", "--x",
                           "--device", "cpu"]
    assert seen["env"]["PYTHONPATH"] == \
        f"{_ROOT / 'src'}:elsewhere"

    def failing(cmd, **kw):
        return subprocess.CompletedProcess(cmd, 1, "out-text", "err-text")

    monkeypatch.setattr(port_run.subprocess, "run", failing)
    with pytest.raises(SystemExit) as e:
        port_run._subprocess_json("sharded_search", [], CPU)
    assert str(e.value) == "sharded_search failed:\nout-text\nerr-text"


def test_extras_print_the_reference_rows(monkeypatch, capsys):
    """The driver-level extras: core search on a shrunk common index and
    the plain ADC at the reference's shapes."""
    from repro_torch.benchmarks import common
    for k, v in dict(N_DOCS=2000, N_QUERIES=96, N_CLUSTERS=32).items():
        monkeypatch.setattr(common, k, v)
    monkeypatch.setattr(common, "time_call",
                        lambda fn, *a, device, **kw: (fn(*a), 1234.4)[1])
    port_run._run_core_search(CPU)
    port_run._run_kernels(CPU)
    assert capsys.readouterr().out.splitlines() == [
        "hi2_search_batch,1234,per_query_us=12.9",
        "hi2_search_64q,1234,oracle_path",
        f"kernel/pq_adc_oracle,1234,cands_per_s={64 * 2048 / 1234.4e-6:.3g}"]


def test_one_driver_run_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(_ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "--only",
         "sharded_search", "kernel_bench", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    rows = [line.split(",", 2) for line in lines[1:]]
    assert [n for n, _, _ in rows] == [
        "sharded/baseline", "sharded/2shards", "kernel_bench/pq_adc",
        "kernel_bench/sq8_dot", "kernel_bench/assign_topk"]
    assert all(float(us) > 0 for _, us, _ in rows)
    assert "identical=True" in rows[1][2]
    assert "ids_bit_identical=True;scores_match=True" in rows[4][2]

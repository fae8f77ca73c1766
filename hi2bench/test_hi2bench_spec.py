"""``BENCHMARK.json`` and the files it names: every cell resolves by name,
a new configuration, mix and metric are taken up as new files alone,
and the harness imports nothing it may not."""
from __future__ import annotations

import ast
import hashlib
import json
import pathlib
import re
import shutil
import sys

import pytest

from hi2bench import run, spec
from hi2bench.conftest import HERE, ROOT, last_json, run_script

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_resolves_to_its_files():
    bench = spec.load()
    assert bench["paths"] == ["hi2bench"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench)
        assert cell.config["name"] == w["config"]
        assert cell.traffic["arrivals"]["process"] in ("closed", "open")
        parts = cell.config["codec"].split(":")
        base = parts[1] if parts[0] == "refine" else parts[0]
        assert callable(spec.codec(base).draw)
        assert (HERE / "reference" / "codecs" / f"{base}.py").is_file()
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.reader(m["name"]))
        for m in cell.per_layer:
            assert m["moves"] in names
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
            assert callable(spec.counts(m["name"][:-9]).work)
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("hi2bench/")


def test_names_units_and_keys_keep_to_the_contract():
    bench = spec.load()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in bench["per_layer"]}
    assert layers <= {"runtime", "server", "search stages", "kernels",
                      "device"}
    assert len(json.dumps(bench)) < 64 * 1024


def _digest(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()
                                                     ).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def _copy(tmp_path: pathlib.Path) -> pathlib.Path:
    dst = tmp_path / "checkout"
    shutil.copytree(HERE, dst / "hi2bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


#: a reference module of a configuration with a serve setting that no
#: configuration of the benchmark sets: RRF fusion at dense weight 1.0,
#: where the fused rows are the dense rows with each rank's RRF mass as
#: its score, and the sparse path's matches count among the candidates
FUSED_REFERENCE = """
import torch

from . import hi2

SERVE = frozenset({"fusion_weight"})
RRF_K = 60


def _n_sparse(p, tm):
    t = p.term_entries[tm.clamp(min=0).long()]
    ids = torch.where((tm >= 0)[:, :, None] & (t >= 0), t, -1)
    s = torch.sort(ids.reshape(tm.shape[0], -1).long(), -1)[0]
    new = torch.ones_like(s, dtype=torch.bool)
    new[:, 1:] = s[:, 1:] != s[:, :-1]
    return (new & (s >= 0)).sum(-1)


def _fused(r, n_sparse):
    rank = torch.arange(r.top_scores.shape[1], dtype=torch.float64,
                        device=r.top_scores.device)
    mass = torch.where(torch.isfinite(r.top_scores), 1.0 / (RRF_K + 1.0 + rank),
                       -torch.inf)
    return hi2.Ranked(n_cand=r.n_cand + n_sparse, cand=r.cand,
                      top_ids=r.top_ids, top_scores=mass)


def search(p, qe, qt, cfg, **kw):
    assert cfg["serve"]["fusion_weight"] == 1.0
    first, tie, second = hi2.search(p, qe, qt, cfg, **kw)
    tm = hi2.dispatch(p, qe, qt, cfg["kc"], cfg["k2"], torch.float64, 0.0)[3]
    first = _fused(first, _n_sparse(p, tm))
    if second is not None:
        second = _fused(second, _n_sparse(p, tm[tie]))
    return first, tie, second


def final_scores(p, qe, ranked, ids, budget=None):
    eq = ids.long()[:, :, None] == ranked.top_ids[:, None, :]
    mass = torch.gather(ranked.top_scores, 1, eq.long().argmax(-1))
    return torch.where(eq.any(-1) & (ids >= 0), mass, -torch.inf)
"""


def _add_cell(bench: dict, name: str, config: str, mix: str) -> None:
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": mix, "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "qps":
            m["workloads"].append(name)


#: new files, each new in kind: a configuration with a serve setting and
#: a reference module that no configuration has; a mix of an arrival
#: process, a query draw and a runtime setting that no mix has
DUMMIES = {
    "config": ("dummy_cfg.bulk256", "dummy_cfg", "bulk256"),
    "mix": ("msmarco_opq.dummy_mix", "msmarco_opq", "dummy_mix"),
}


@pytest.mark.parametrize("kind", sorted(DUMMIES))
def test_new_config_mix_and_metric_are_new_files_alone(tmp_path, kind):
    dst = _copy(tmp_path)
    before = _digest(dst / "hi2bench")
    here = dst / "hi2bench"
    cell_name, config, mix_name = DUMMIES[kind]
    cfg = json.loads((here / "configs" / "msmarco_opq.json").read_text())
    cfg.update(name="dummy_cfg", reference="dummy_fused",
               serve={"fusion_weight": 1.0})
    (here / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    (here / "reference" / "dummy_fused.py").write_text(FUSED_REFERENCE)
    mix = json.loads((here / "traffic" / "bulk256.json").read_text())
    mix.update(rows_per_request=1, pool_requests=64,
               draw={"law": "zipf", "s": 1.2},
               arrivals={"process": "open",
                         "rates": [[0.1, 400.0], [0.05, 0.0]]},
               lead_s=0.2, tiny={"check_queries": 32})
    mix["runtime"].update(cache_size=32, min_bucket=1, queue_depth=512)
    (here / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (here / "metrics" / "dummy.batches.py").write_text(
        "def read(ctx):\n"
        "    return ctx.stats1['n_batches'] - ctx.stats0['n_batches']\n")
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy_cfg", "source": "x",
                             "file": "hi2bench/configs/dummy_cfg.json",
                             "reduced": [], "why": "a test"})
    _add_cell(bench, cell_name, config, mix_name)
    bench["per_layer"].append({"name": "dummy.batches", "unit": "batches",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "runtime", "moves": "qps",
                               "workloads": [cell_name]})
    # a metric split by its cells shares the reader of its stem
    bench["per_layer"].append({"name": "device.idle_pct.dummy", "unit": "%",
                               "better": "lower", "source": "device_trace",
                               "layer": "device", "moves": "qps",
                               "workloads": [cell_name]})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(here)
    assert {k: v for k, v in after.items() if k in before} == before

    cell = spec.cell(cell_name, spec.load(dst), here)
    assert cell.config["name"] == config
    assert cell.traffic == json.loads(
        (here / "traffic" / f"{mix_name}.json").read_text())
    assert [m["name"] for m in cell.per_layer] == ["dummy.batches",
                                                   "device.idle_pct.dummy"]
    # the copy's own runner finds and reads them, end to end
    for trace in ("0", "1"):
        rc, out, err = run_script(
            [here / "run.py", "--workload", cell_name, "--seed",
             2**31 + 3, "--seconds", "0.5", "--trace", trace, "--device",
             "cpu", "--tiny"], cwd=dst)
        assert rc == 0, err[-2000:]
        res = last_json(out)
        assert res["correct"] is True, res["checks"]
        assert res["failed"] == 0 and res["attempted"] > 0
        if trace == "1":
            assert res["metrics"]["dummy.batches"]["value"] > 0
        else:
            assert res["metrics"]["qps"]["value"] > 0
    if kind == "mix":
        assert "lateness_ms" in res["traffic"]
    else:
        # the served rows carry the fusion: RRF masses, not dot products
        assert res["checks"]["score_err"]["value"] < 1e-6


def test_a_config_with_a_setting_its_reference_does_not_model_is_refused():
    from hi2bench import check
    cfg = spec.config("msmarco_opq")
    assert check.reference(cfg).__name__ == "hi2bench.reference.hi2"
    cfg["serve"] = {"fusion_weight": 0.5}
    with pytest.raises(ValueError, match="fusion_weight"):
        check.reference(cfg)


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    dst = _copy(tmp_path)
    rc, out, err = run_script(
        [dst / "hi2bench" / "run.py", "--workload", "msmarco_opq.bulk256",
         "--seed", 2**31 + 1, "--seconds", "1", "--trace", "0",
         "--device", "cpu", "--tiny"], cwd=dst, pythonpath=())
    assert rc != 0
    assert "correct" not in out


def test_no_card_no_result():
    """Off the card the benchmark exits non-zero and prints nothing on
    standard output (the check sits in ``main``, not at import)."""
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            "sys.argv[0] = 'run.py'; from hi2bench import run; "
            "sys.exit(run.main(sys.argv[1:]))")
    rc, out, err = run_script(
        ["--workload", "msmarco_opq.bulk256", "--seed", 2**33,
         "--seconds", "1", "--trace", "0"], code=code,
        pythonpath=(ROOT, ROOT / "src"))
    assert rc != 0 and out.strip() == ""
    assert "no CUDA device" in err


def test_forbidden_modules_are_compared_by_whole_top_level_name(
        monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxfake.sub", object())
    got = run.loaded_forbidden()
    assert "repro_torch_fake" not in got and "jaxfake" not in got
    monkeypatch.setitem(sys.modules, "repro.sub", object())
    assert "repro" in run.loaded_forbidden()


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(p for p in HERE.rglob("*.py")
                                        if "__pycache__" not in p.parts),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    found = _imports(path)
    assert not found & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    if "reference" in path.relative_to(HERE).parts:
        assert "repro_torch" not in found
        assert found <= {"__future__", "dataclasses", "importlib", "typing",
                         "torch", "numpy", "math"}


def test_only_the_system_and_codec_files_import_the_program():
    users = {str(p.relative_to(HERE)) for p in HERE.rglob("*.py")
             if "__pycache__" not in p.parts and not p.name.startswith(
                 ("test_", "conftest"))
             and "repro_torch" in _imports(p)}
    assert users == {"system.py", "codecs/opq.py"}

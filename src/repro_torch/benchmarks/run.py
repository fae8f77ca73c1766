"""Benchmark driver (port of ``benchmarks/run.py``): enumerates and
dispatches every benchmark entry point of the port, so one command
reproduces the full bench suite.  Prints ``name,us_per_call,derived``
CSV rows under the reference's row names and derived keys.

    python -m repro_torch.benchmarks.run                # everything, card
    python -m repro_torch.benchmarks.run --list         # what would run
    python -m repro_torch.benchmarks.run --only table3_codec --device cpu

``--device`` (default ``cuda``) goes to every benchmark, in this process
and in the subprocesses; without a card, and without ``--device cpu``,
the driver exits nonzero through :func:`repro_torch.device.resolve`.

Every module in ``src/repro_torch/benchmarks/`` that is neither a helper
(:data:`HELPER_MODULES`) nor one of the port's own diagnostics
(:data:`TOOL_MODULES`) must have an entry in :data:`DISPATCH`; the
driver exits nonzero, naming every missing and every stale entry, if
one does not, so a new benchmark cannot silently drop out of the suite.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

import torch

from repro_torch import device as dev_mod

#: benchmarks/ modules that are infrastructure, not benchmarks
HELPER_MODULES = {"__init__", "common", "run", "check_regression",
                  "timing", "synth_msmarco"}

#: the port's diagnostics (no reference counterpart), outside the suite
TOOL_MODULES = {
    "kernel_variants": "a kernel source against its parent's; needs a "
                       "card and --parent",
    "build_repeat": "two builds of one seed at N 1,048,576 compared leaf "
                    "for leaf; needs a card",
    "bucket_invariance": "which query-side products change bits with the "
                         "batch size; a probe of the runtime's buckets",
    "lm_memory": "peak device memory of the LM cells that fill one card; "
                 "sizes chip_smoke.py's phases 25-26",
}

_DIR = pathlib.Path(__file__).resolve().parent
_SRC = _DIR.parents[1]


def discovered() -> list[str]:
    """Module names of every benchmark entry point on disk."""
    return sorted(p.stem for p in _DIR.glob("*.py")
                  if p.stem not in HELPER_MODULES
                  and p.stem not in TOOL_MODULES)


def _run_core_search(dev: torch.device) -> None:
    from repro_torch.benchmarks import common
    from repro_torch.core import hybrid_index as hi

    qe, qt = common.queries()
    idx = common.unsup_index(dev)
    us = common.time_call(
        lambda: hi.search(idx, qe, qt, kc=common.KC, k2=common.K2,
                          top_r=common.TOP_R, device=dev), device=dev)
    per_query = us / qe.shape[0]
    print(f"hi2_search_batch,{us:.0f},per_query_us={per_query:.1f}",
          flush=True)
    us64 = common.time_call(
        lambda: hi.search(idx, qe[:64], qt[:64], kc=common.KC, k2=common.K2,
                          top_r=common.TOP_R, device=dev), device=dev)
    print(f"hi2_search_64q,{us64:.0f},oracle_path", flush=True)


def _run_kernels(dev: torch.device) -> None:
    # the plain version's timing only; the hand-written kernels' times
    # are kernel_bench's (fused against unfused)
    from repro_torch.benchmarks import common
    from repro_torch.kernels.pq_adc import ref as adc_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    lut = torch.randn((64, 8, 256), generator=gen, device=dev)
    codes = torch.randint(0, 256, (64, 2048, 8), generator=gen, device=dev,
                          dtype=torch.int32)
    us = common.time_call(adc_ref.pq_adc, lut, codes, device=dev)
    scored = 64 * 2048
    print(f"kernel/pq_adc_oracle,{us:.0f},cands_per_s={scored/us*1e6:.3g}",
          flush=True)


def _table1(dev: torch.device) -> None:
    from repro_torch.benchmarks import table1_main
    for row in table1_main.run(device=dev):
        print(f"table1/{row['method']},0,"
              f"R@100={row['R@100']:.4f};MRR@10={row['MRR@10']:.4f};"
              f"cands={row['candidates']:.0f};"
              f"index_mb={row['index_bytes']/2**20:.1f}", flush=True)


def _table2(dev: torch.device) -> None:
    from repro_torch.benchmarks import table2_robustness
    for row in table2_robustness.run(device=dev):
        print(f"table2/{row['model']}/{row['method']},0,"
              f"R@100={row['R100']:.4f}", flush=True)


def _table3(dev: torch.device) -> None:
    from repro_torch.benchmarks import table3_codec
    for row in table3_codec.run(smoke=False, device=dev):
        print(f"table3/{row['codec']},0,"
              f"R@100={row['R@100']:.4f};"
              f"index_mb={row['index_bytes']/2**20:.1f}", flush=True)


def _fig3(dev: torch.device) -> None:
    from repro_torch.benchmarks import fig3_tradeoff
    for name, pts in fig3_tradeoff.run(device=dev).items():
        pts_s = ";".join(f"({c:.0f}:{r:.4f})" for c, r in pts)
        print(f"fig3/{name},0,{pts_s}", flush=True)


def _fig4(dev: torch.device) -> None:
    from repro_torch.benchmarks import fig4_ablation
    for name, pts in fig4_ablation.run(device=dev).items():
        pts_s = ";".join(f"({c:.0f}:{r:.4f})" for c, r in pts)
        print(f"fig4/{name},0,{pts_s}", flush=True)


def _subprocess_json(module: str, extra_args: list[str],
                     dev: torch.device) -> dict:
    """Run a benchmark in a process of its own (its own allocator, caches
    and ``gc.freeze``, as a user's run) and parse its JSON stdout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{_SRC}:{env.get('PYTHONPATH', '')}".rstrip(":")
    r = subprocess.run(
        [sys.executable, "-m", f"repro_torch.benchmarks.{module}",
         *extra_args, "--device", str(dev)],
        capture_output=True, text=True, env=env)
    if r.returncode != 0:
        sys.exit(f"{module} failed:\n{r.stdout}\n{r.stderr}")
    return json.loads(r.stdout[r.stdout.index("{"):])


def _sharded_search(dev: torch.device) -> None:
    rep = _subprocess_json("sharded_search",
                           ["--devices", "2", "--docs", "4000",
                            "--queries", "64"], dev)
    base = rep["baseline"]
    print(f"sharded/baseline,{base['us_per_batch']:.0f},"
          f"qps={base['qps']:.0f}", flush=True)
    for e in rep["sharded"]:
        print(f"sharded/{e['shards']}shards,{e['us_per_batch']:.0f},"
              f"identical={e['doc_ids_identical']};"
              f"speedup={e['speedup_vs_baseline']}", flush=True)


def _filtered_search(dev: torch.device) -> None:
    rep = _subprocess_json("filtered_search", ["--smoke", "--check"], dev)
    for pt in rep["points"]:
        print(f"filtered/pass{pt['pass_rate']:.2f},"
              f"{pt['search_us_per_batch']:.0f},"
              f"R@R={pt['R@R_vs_filtered_oracle']:.4f};"
              f"cands={pt['mean_candidates']:.0f};"
              f"isolated={pt['tenant_isolated']}", flush=True)
    print(f"filtered/allow_all,0,"
          f"equals_unfiltered={rep['allow_all_equals_unfiltered']}",
          flush=True)


def _streaming_updates(dev: torch.device) -> None:
    rep = _subprocess_json("streaming_updates", ["--smoke", "--check"], dev)
    for p in rep["points"]:
        print(f"streaming/fill{p['fill_fraction']:.2f},"
              f"{p['search_us_per_batch']:.0f},R@100={p['R@100']:.4f}",
              flush=True)
    c = rep["compaction"]
    print(f"streaming/compaction,{c['seconds']*1e6:.0f},"
          f"equal_to_rebuild={c['equal_to_rebuild']};"
          f"tombstones_absent={rep['deletes']['tombstones_absent']}",
          flush=True)


def _serving_load(dev: torch.device) -> None:
    rep = _subprocess_json("serving_load", ["--smoke", "--check"], dev)
    for name in ("plain", "sharded", "mutable", "sharded_mutable"):
        r = rep["layouts"][name]
        print(f"serving/{name},{1e6 / r['qps_runtime']:.0f},"
              f"speedup={r['qps_runtime'] / r['qps_serial']:.1f};"
              f"identical={r['bit_identical']};"
              f"p99_ms={r['poisson']['p99_ms']};"
              f"cache_hits={r['cache']['hits']}", flush=True)


def _mesh_serving(dev: torch.device) -> None:
    rep = _subprocess_json("mesh_serving", ["--smoke", "--check"], dev)
    for name, r in rep["geometries"].items():
        print(f"mesh/{name},{r['us_per_batch']:.0f},"
              f"qps_emulated={r['qps_emulated']};"
              f"identical={r['runtime_bit_identical']};"
              f"p99_ms={r['poisson']['p99_ms']}", flush=True)
    d = rep["failover"]
    print(f"mesh/failover,0,"
          f"partial={d['partial_flagged']};"
          f"rejoin_identical={d['rejoin_bit_identical']}", flush=True)


def _hybrid_fusion(dev: torch.device) -> None:
    rep = _subprocess_json("hybrid_fusion", ["--smoke", "--check"], dev)
    r = rep["top_r"]
    d = rep["dense_only"]
    print(f"hybrid/dense_only,{d['search_us_per_batch']:.0f},"
          f"R@{r}={d[f'R@{r}']:.4f}", flush=True)
    for pt in rep["points"]:
        print(f"hybrid/w{pt['fusion_weight']:.2f},"
              f"{pt['search_us_per_batch']:.0f},"
              f"R@{r}={pt[f'R@{r}']:.4f}", flush=True)
    print(f"hybrid/best,0,weight={rep['best_weight']};"
          f"fused_ge_dense={rep['fused_ge_dense']};"
          f"fallback={rep['fallback_equals_dense']}", flush=True)


def _autotune(dev: torch.device) -> None:
    rep = _subprocess_json("autotune", ["--smoke", "--check"], dev)
    t, d, a = rep["tuned"], rep["default"], rep["adaptive"]
    print(f"autotune/default,0,cost={d['cost']};R@100={d['recall']:.4f}",
          flush=True)
    print(f"autotune/tuned,0,kc={t['kc']};k2={t['k2']};"
          f"mult={t['refine_mult']};cost={t['cost']};"
          f"R@100={t['recall']:.4f}", flush=True)
    print(f"autotune/adaptive,0,rungs={a['n_rungs']};"
          f"mean_cost={a['mean_cost']};R@100={a['recall']:.4f}",
          flush=True)
    rt = rep["runtime"]
    print(f"autotune/runtime,0,"
          f"programs={len(rt['warm_compiles'])};"
          f"post_warmup={rt['post_warmup_compiles']};"
          f"identical={rt['per_rung_bit_identical']}", flush=True)


def _sup_distill(dev: torch.device) -> None:
    rep = _subprocess_json("sup_distill", ["--smoke", "--check"], dev)
    t = rep["trajectory"]
    print(f"sup_distill/train,0,steps={t['n_steps']};"
          f"loss={t['loss_first']:.4f}->{t['loss_last']:.4f};"
          f"improving={t['frac_improving_windows']:.2f}", flush=True)
    r = rep["top_r"]
    for p in rep["operating_points"]:
        print(f"sup_distill/kc{p['kc']}k2{p['k2']},0,"
              f"cost={p['cost_sup']};R@{r}_unsup={p['recall_unsup']:.4f};"
              f"R@{r}_sup={p['recall_sup']:.4f}", flush=True)
    life = rep["variants"]["mutable_lifecycle"]
    print(f"sup_distill/variants,0,"
          f"wins={rep['sup_wins']}/{rep['n_operating_points']};"
          f"roundtrip={rep['roundtrip']['planes_bit_identical']};"
          f"compact={life['compact_equals_scratch']}", flush=True)


def _kernel_bench(dev: torch.device) -> None:
    rep = _subprocess_json("kernel_bench", ["--smoke", "--check"], dev)
    for name in ("pq_adc", "sq8_dot", "assign_topk"):
        e = rep[name]
        derived = ";".join(f"{k}={v}" for k, v in sorted(e.items())
                           if isinstance(v, bool)
                           or k.startswith("qps"))
        print(f"kernel_bench/{name},{e['fused_us_per_call']:.0f},"
              f"{derived}", flush=True)


#: every benchmark entry point; the driver refuses to run if a
#: benchmark module exists without a row here
DISPATCH = {
    "autotune": _autotune,
    "kernel_bench": _kernel_bench,
    "table1_main": _table1,
    "table2_robustness": _table2,
    "table3_codec": _table3,
    "fig3_tradeoff": _fig3,
    "fig4_ablation": _fig4,
    "sharded_search": _sharded_search,
    "sup_distill": _sup_distill,
    "streaming_updates": _streaming_updates,
    "filtered_search": _filtered_search,
    "hybrid_fusion": _hybrid_fusion,
    "serving_load": _serving_load,
    "mesh_serving": _mesh_serving,
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--only", nargs="*", default=None,
                    help="run just these benchmarks")
    ap.add_argument("--list", action="store_true",
                    help="print the dispatch table and exit")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (their plain "
                         "versions), for every benchmark")
    args = ap.parse_args(argv)

    names = discovered()
    # collect EVERY dispatch-table problem before exiting, so one run
    # surfaces the full repair list instead of one entry at a time
    problems = []
    missing = sorted(set(names) - set(DISPATCH))
    if missing:
        problems.append(
            f"benchmarks without a DISPATCH entry in "
            f"repro_torch/benchmarks/run.py: {', '.join(missing)} — add "
            "one so `python -m repro_torch.benchmarks.run` reproduces the "
            "full suite")
    stale = sorted(set(DISPATCH) - set(names))
    if stale:
        problems.append(f"DISPATCH entries without a repro_torch/"
                        f"benchmarks/*.py file: {', '.join(stale)}")
    if problems:
        sys.exit("; ".join(problems))
    if args.list:
        for n in names:
            print(n)
        return
    selected = args.only if args.only else names
    unknown = sorted(set(selected) - set(DISPATCH))
    if unknown:
        sys.exit(f"unknown benchmark(s): {', '.join(unknown)}; "
                 f"known: {', '.join(names)}")
    dev = dev_mod.resolve(args.device)

    print("name,us_per_call,derived")
    if not args.only:           # driver-level extras only on full runs
        _run_core_search(dev)
    for name in selected:
        DISPATCH[name](dev)
    if not args.only:
        _run_kernels(dev)


if __name__ == "__main__":
    main()

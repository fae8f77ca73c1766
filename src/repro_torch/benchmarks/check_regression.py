"""Bench regression gate (port of ``benchmarks/check_regression.py``):
compare fresh benchmark JSONs against baseline JSONs in a directory the
caller names.

    python -m repro_torch.benchmarks.check_regression \\
        --baseline-dir build/bench/a --fresh-dir build/bench/b

Quality and structural fields (recall, candidate counts, bytes, budgets,
equality flags) must match the baseline **exactly** — they are
deterministic functions of the code, so any drift is a real behaviour
change.  Wall-clock fields (``*_us*``, ``*seconds*``, ``qps``,
``speedup*``) vary with the runner and are only checked directionally
within ``--timing-ratio``.

Exit status is nonzero on any regression, listing every mismatch with
its JSON path.  ``--baseline-dir`` has no default: the port reads no
baselines of its own from the repository (``results/`` holds the JAX
package's), so the caller always says which run is the baseline.
The module itself uses only the standard library.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

#: benchmark files the gate covers (baseline name = fresh name)
DEFAULT_FILES = ("BENCH_codec.json", "sharded_search.json",
                 "BENCH_streaming.json", "BENCH_filtered.json",
                 "BENCH_serving.json", "BENCH_kernels.json",
                 "BENCH_mesh.json", "BENCH_hybrid.json",
                 "BENCH_autotune.json", "BENCH_sup.json")

_HIGHER_BETTER = ("qps", "speedup")
_LOWER_BETTER = ("us_per_batch", "us_per_call", "_us", "us", "seconds",
                 "_s", "ms")


def timing_direction(key: str):
    """'higher'/'lower' for wall-clock-dependent keys, None for exact
    fields.  Matched on key names so new benchmarks get the right
    treatment by following the naming convention."""
    k = key.lower()
    if any(k == p or k.startswith(p) for p in _HIGHER_BETTER):
        return "higher"
    if "seconds" in k or "us_per" in k:    # add_seconds_total, us_per_batch
        return "lower"
    if any(k == p or k.endswith(p) for p in _LOWER_BETTER):
        return "lower"
    return None


def compare(baseline, fresh, *, timing_ratio: float, float_tol: float,
            path: str = "$", key: str = "") -> list[str]:
    """Recursively diff two JSON documents; returns failure strings."""
    fails = []
    if type(baseline) is not type(fresh) and not (
            isinstance(baseline, (int, float))
            and isinstance(fresh, (int, float))
            and not isinstance(baseline, bool)
            and not isinstance(fresh, bool)):
        return [f"{path}: type changed "
                f"{type(baseline).__name__} -> {type(fresh).__name__}"]
    if isinstance(baseline, dict):
        for k in sorted(baseline.keys() | fresh.keys()):
            sub = f"{path}.{k}"
            if k not in fresh:
                fails.append(f"{sub}: missing from fresh run")
            elif k not in baseline:
                fails.append(f"{sub}: not in baseline (refresh the "
                             "baseline to admit new fields)")
            else:
                fails += compare(baseline[k], fresh[k],
                                 timing_ratio=timing_ratio,
                                 float_tol=float_tol, path=sub, key=k)
    elif isinstance(baseline, list):
        if len(baseline) != len(fresh):
            fails.append(f"{path}: length {len(baseline)} -> {len(fresh)}")
        else:
            for i, (b, f) in enumerate(zip(baseline, fresh)):
                fails += compare(b, f, timing_ratio=timing_ratio,
                                 float_tol=float_tol, path=f"{path}[{i}]",
                                 key=key)
    elif isinstance(baseline, bool) or isinstance(baseline, str) \
            or baseline is None:
        if baseline != fresh:
            fails.append(f"{path}: {baseline!r} -> {fresh!r}")
    elif isinstance(baseline, (int, float)):
        direction = timing_direction(key)
        if direction is None:
            if abs(float(baseline) - float(fresh)) > float_tol:
                fails.append(f"{path}: {baseline} -> {fresh} "
                             f"(exact field, tol={float_tol})")
        elif direction == "lower":
            if float(fresh) > float(baseline) * timing_ratio:
                fails.append(f"{path}: {fresh} > {timing_ratio}x baseline "
                             f"{baseline} (slower)")
        else:
            if float(fresh) < float(baseline) / timing_ratio:
                fails.append(f"{path}: {fresh} < baseline {baseline} / "
                             f"{timing_ratio} (slower)")
    else:
        fails.append(f"{path}: unhandled JSON type "
                     f"{type(baseline).__name__}")
    return fails


def check_files(baseline_dir: str, fresh_dir: str, files, *,
                timing_ratio: float, float_tol: float) -> list[str]:
    fails = []
    for name in files:
        b_path = os.path.join(baseline_dir, name)
        f_path = os.path.join(fresh_dir, name)
        if not os.path.exists(b_path):
            fails.append(f"{name}: no committed baseline at {b_path} — "
                         "generate it and commit it")
            continue
        if not os.path.exists(f_path):
            fails.append(f"{name}: fresh run missing at {f_path}")
            continue
        with open(b_path) as f:
            baseline = json.load(f)
        with open(f_path) as f:
            fresh = json.load(f)
        fails += [f"{name} {msg}" for msg in
                  compare(baseline, fresh, timing_ratio=timing_ratio,
                          float_tol=float_tol)]
    return fails


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--baseline-dir", required=True,
                    help="directory with the baseline JSONs")
    ap.add_argument("--fresh-dir", required=True,
                    help="directory with this run's benchmark JSONs")
    ap.add_argument("--files", nargs="*", default=list(DEFAULT_FILES))
    ap.add_argument("--timing-ratio", type=float, default=4.0,
                    help="allowed slowdown factor for wall-clock fields")
    ap.add_argument("--float-tol", type=float, default=0.0,
                    help="absolute tolerance for exact numeric fields "
                         "(default: bit-exact)")
    args = ap.parse_args(argv)

    fails = check_files(args.baseline_dir, args.fresh_dir, args.files,
                        timing_ratio=args.timing_ratio,
                        float_tol=args.float_tol)
    if fails:
        print(f"REGRESSION: {len(fails)} mismatch(es) vs "
              f"{args.baseline_dir}/", file=sys.stderr)
        for msg in fails:
            print(f"  {msg}", file=sys.stderr)
        sys.exit(1)
    print(f"ok: {', '.join(args.files)} match the baselines in "
          f"{args.baseline_dir}/ (timing within {args.timing_ratio}x)")


if __name__ == "__main__":
    main()

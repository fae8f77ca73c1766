"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs): for each seed, in one process,

  sound    a short window of the cell's traffic through the program, and
           the comparison's numbers over the seed's sample of its rows;
  control  the plain reference put in the program's place at the
           precision below the configuration's (float32 with TF32
           products), on the same sampled queries, compared the same
           way.

    python3 hi2bench/calibrate.py --workload msmarco_opq.bulk256 \\
        --seeds 11 12 13 --seconds 3

One JSON line a seed; ``--device cpu --tiny`` rehearses on the CPU.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from hi2bench import check, run, spec, traffic
    cell = spec.cell(args.workload, spec.load())
    cfg = spec.sized(cell.config, args.tiny)
    mix = spec.sized(cell.traffic, args.tiny)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        out = {"workload": cell.name, "seed": seed}
        t0 = time.perf_counter()
        cut = run.Prepared(cfg, mix, seed, dev)
        log = traffic.run(cut.rt, cut.qe_h, cut.qt_h, mix, seed,
                          args.seconds, overloaded=cut.overloaded)
        cut.release()
        out["requests"] = log.n
        t1 = time.perf_counter()
        out["sound"] = run.judge(cut, cfg, mix, log, seed)
        out["sound_s"] = time.perf_counter() - t1
        planes, pool = cut.planes, cut.pool
        rows = torch.from_numpy(run.sample(mix, log, seed)[3]).to(dev)
        qe, qt = pool[0][rows], pool[1][rows]
        t1 = time.perf_counter()
        ids, sc, nc = check.control_rows(planes, cfg, qe, qt)
        out["control"] = check.compare(planes, cfg, qe, qt, ids, sc, nc)
        out["control_s"] = time.perf_counter() - t1
        out["queries"] = int(rows.numel())
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        del planes, pool
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

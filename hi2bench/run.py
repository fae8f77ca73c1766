"""Run one cell of the benchmark once:

    python3 hi2bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

It draws the cell's planes and query pool on the card from the seed,
builds the port's server and serving runtime over them and warms the
cell's buckets (all of it ``setup_s``), drives the cell's traffic for
the window, checks a sample of the served rows against the plain
reference, and prints one JSON line last on standard output: the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics read from a
profiled window (``--trace 1``).  ``--device cpu --tiny`` rehearses the
same steps on the CPU at the configuration's ``tiny`` sizes; such a run
prints no device metric.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse                                    # noqa: E402
import gc                                          # noqa: E402
import json                                        # noqa: E402
import math                                        # noqa: E402
import os                                          # noqa: E402
import pathlib                                     # noqa: E402
import sys                                         # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level modules that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: a rehearsal, with --tiny")
    ap.add_argument("--tiny", action="store_true",
                    help="the configuration's tiny sizes (CPU rehearsal)")
    return ap.parse_args(argv)


def say(what: str) -> None:
    """A progress line on standard error, with the seconds since start."""
    print(f"[hi2bench] {time.perf_counter() - T_START:8.2f} s  {what}",
          file=sys.stderr, flush=True)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Context:
    """What a metric's reader sees: the configuration and mix, the
    window's log, ``setup_s``, the runtime's ``stats()`` as the window
    opened and closed, and the traced window (``--trace 1``, else
    None)."""

    def __init__(self, cfg, mix, log, setup_s, stats0, stats1, trace,
                 planes, pool):
        self.cfg, self.mix, self.log, self.setup_s = cfg, mix, log, setup_s
        self.stats0, self.stats1, self.trace = stats0, stats1, trace
        self._planes, self._pool = planes, pool
        self._live = None

    def bucket_batches(self) -> dict:
        """Batches the runtime ran in the window, by bucket rows."""
        a, b = self.stats0["bucket_counts"], self.stats1["bucket_counts"]
        return {int(k): b[k] - a.get(k, 0) for k in b if b[k] - a.get(k, 0)}

    def batch_live(self) -> list:
        """Each batch of the window (a closed mix's request is one
        batch, with the cache off): its rows b, candidate slots c a
        query, live slots and distinct live documents, from the
        reference's candidate sets."""
        if self._live is None:
            self._live = batch_live(self.cfg, self.mix, self.log,
                                    self._planes, self._pool)
        return self._live


def batch_live(cfg, mix, log, planes, pool) -> list:
    import torch
    from hi2bench.reference import hi2 as ref
    if (mix["arrivals"]["process"] != "closed"
            or mix["rows_per_request"] != cfg["query_batch"]
            or mix["runtime"].get("cache_size")):
        return []
    qe, qt = pool
    c = (cfg["kc"] * cfg["cluster_capacity"]
         + cfg["k2"] * cfg["term_capacity"])
    memo: dict = {}
    out = []
    for rows in log.rows:
        key = int(rows[0])
        if key not in memo:
            r = torch.from_numpy(rows).to(qe.device)
            cl, _, _, tm = ref.dispatch(planes, qe[r], qt[r], cfg["kc"],
                                        cfg["k2"], torch.float64, 0.0)
            cand, n = ref.candidates(planes, cl, tm)
            flat = cand[cand != ref.SENTINEL]
            memo[key] = {"b": int(rows.size), "c": c, "n_live": int(n.sum()),
                         "distinct": int(torch.unique(flat).numel())}
        out.append(memo[key])
    return out


class Prepared:
    """A cell's planes, query pool and warmed runtime."""

    def __init__(self, cfg: dict, mix: dict, seed: int, dev):
        import torch
        from hi2bench import planes as planes_mod, system, traffic
        self.dev = dev
        say("program imported" if "repro_torch" in sys.modules
            else "start of set-up")
        self.planes, self.pool, extra = planes_mod.draw(
            cfg, seed, dev, traffic.pool_size(mix))
        self.qe_h, self.qt_h = (t.cpu().numpy() for t in self.pool)
        say("planes and query pool drawn")
        self.rt = system.runtime(self.planes, extra, cfg, mix, dev)
        del extra
        say(f"runtime warmed: {len(self.rt.buckets)} bucket(s), capture "
            f"{sum(self.rt.capture_seconds.values()):.2f} s")
        self.overloaded = system.overloaded()
        traffic.warm(self.rt, self.qe_h, self.qt_h, mix, seed,
                     overloaded=self.overloaded)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        say("warm traffic done")

    def release(self) -> None:
        """Stop the runtime and free the program's state; the planes and
        the pool stay for the reference."""
        import torch
        self.rt.close()
        self.rt = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def sample(mix: dict, log, seed: int):
    """Served rows of a sample of the finished requests drawn from the
    seed: (ids, scores, n_candidates, pool rows) numpy planes, or None
    when no request finished."""
    import numpy as np
    from hi2bench import check
    finished = sorted(i for i in log.kept if log.ok[i])
    if not finished:
        return None
    want = max(1, mix["check_queries"] // mix["rows_per_request"])
    rng = np.random.default_rng([seed, 13])
    pick = np.sort(rng.choice(len(finished), min(want, len(finished)),
                              replace=False))
    return check.as_numpy_rows([log.kept[finished[i]] for i in pick],
                               [log.rows[finished[i]] for i in pick])


def judge(cut: Prepared, cfg: dict, mix: dict, log, seed: int) -> dict:
    """The comparison's numbers over the seed's sample of served rows."""
    import torch
    from hi2bench import check
    got = sample(mix, log, seed)
    if got is None:
        return {k: check.NOT_A_CANDIDATE for k in check.NAMES}
    ids, sc, nc, rows = (torch.from_numpy(a).to(cut.dev) for a in got)
    return check.compare(cut.planes, cfg, cut.pool[0][rows],
                         cut.pool[1][rows], ids, sc, nc)


def main(argv=None) -> int:
    args = parse(argv)
    from hi2bench import spec
    bench = spec.load()
    cell = spec.cell(args.workload, bench)
    cfg = spec.sized(cell.config, args.tiny)
    mix = spec.sized(cell.traffic, args.tiny)

    import torch
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device: this benchmark runs on the card",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
    dev = torch.device(args.device)
    src = ROOT / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    os.environ.setdefault("USE_FLAX", "0")
    # any kernel cache of the program stays inside the checkout, at a
    # fixed path (the port's own nvcc builds land in build/kernels/)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    from hi2bench import check, trace, traffic
    check.reference(cfg)

    cut = Prepared(cfg, mix, args.seed, dev)
    if args.trace:
        _spans(cut.rt)
    got: dict = {}
    with trace.window(bool(args.trace), dev.type == "cuda", got) as opened:
        def at_start():
            got["stats0"] = cut.rt.stats()
            opened()
        log = traffic.run(cut.rt, cut.qe_h, cut.qt_h, mix, args.seed,
                          args.seconds, overloaded=cut.overloaded,
                          at_start=at_start)
    # set-up ends where the window opens (an open mix's lead-in included)
    setup_s = log.t0 - T_START
    stats0, stats1 = got["stats0"], cut.rt.stats()
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
            else None)
    cut.release()
    say(f"window closed: {log.n} requests")
    numbers = judge(cut, cfg, mix, log, args.seed)
    say("reference compared")
    limits = cfg["limits"]
    failed = log.failed
    # a request that never came back is wrong as well
    correct = (check.verdict(numbers, limits)
               and traffic.not_served(log, mix) == 0)

    metrics = {}
    ctx = Context(cfg, mix, log, setup_s, stats0, stats1, got.get("trace"),
                  cut.planes, cut.pool)
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    say("metrics read")
    odd = [k for k, v in metrics.items() if not math.isfinite(v["value"])]
    if odd:
        # a tail past the requests that failed has no value: the run is
        # not correct, and says so with the metric left null
        print(f"metrics without a finite value: {odd} ({failed} of "
              f"{log.n} requests failed)", file=sys.stderr)
        correct = False
        for k in odd:
            metrics[k]["value"] = None
    attempted = log.n
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    tr = got.get("trace")
    if tr is not None and dev.type == "cuda":
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["traffic"] = {"runtime": {k: stats1[k] - stats0[k] for k in
                                     ("n_served", "n_batches", "n_rejected")}}
    if mix["arrivals"]["process"] == "open":
        result["traffic"]["lateness_ms"] = traffic.lateness_ms(log)
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in check.NAMES}

    bad = loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded in this process: {bad}",
              file=sys.stderr)
        return 3
    for line in check.lines(numbers, limits):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def _spans(rt) -> None:
    """Harness spans around the runtime's batch steps, so that the trace
    can say what the host did in an idle gap."""
    from torch.profiler import record_function

    from hi2bench.trace import SPANS
    for attr, label in zip(("query", "_execute", "_run_batch"), SPANS):
        fn = getattr(rt, attr, None)
        if fn is None:
            continue

        def wrapped(*a, _fn=fn, _label=label, **k):
            with record_function(_label):
                return _fn(*a, **k)
        setattr(rt, attr, wrapped)


if __name__ == "__main__":
    sys.exit(main())

"""Kernel benchmark: fused against unfused against the plain versions on
the scoring hot path (port of ``benchmarks/kernel_bench.py``; DESIGN.md
§11).

    python -m repro_torch.benchmarks.kernel_bench --smoke --check \\
        --device cpu                                    # CPU, plain path
    python -m repro_torch.benchmarks.kernel_bench --check --out F.json

Three comparisons at the candidate shapes of the reference's ``run``:

  · ``pq_adc``: the fused gather + ADC kernel (``pq_adc_fused``) against
    the unfused path (``plane[ids]`` into a (B, C, m) tensor, then the
    ``pq_adc`` kernel) and the plain version;
  · ``sq8_dot``: the fused gather + dequantized dot kernel against the
    gather + einsum path;
  · ``assign_topk``: the ``topk_scores`` dispatch kernel against its
    plain version (a full score plane and a stable sort).

The report has the reference's keys.  ``backend`` names the device;
``interpret_mode`` is true exactly when the plain versions stood in for
the kernels (a CPU run), so the times then measure PyTorch's CPU
kernels, not the card.  ``c_blk`` is null: the CUDA kernels have no
TPU candidate tile.  Times are a synchronize-ended host clock over 3
calls after 1 warm-up call.  The report goes to stdout and, with
``--out``, to that file only.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch import device as dev_mod
from repro_torch.kernels.assign_topk import ops as at_ops
from repro_torch.kernels.assign_topk import ref as at_ref
from repro_torch.kernels.pq_adc import ops as adc_ops
from repro_torch.kernels.pq_adc import ref as adc_ref
from repro_torch.kernels.sq8_dot import ops as sq8_ops
from repro_torch.kernels.sq8_dot import ref as sq8_ref


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_call(fn, dev: torch.device, warmup: int = 1, iters: int = 3
               ) -> float:
    for _ in range(warmup):
        fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / iters * 1e6  # µs per call


def _allclose(a: torch.Tensor, b: torch.Tensor, tol: float = 1e-3) -> bool:
    a, b = a.cpu(), b.cpu()
    if not torch.equal(torch.isinf(a), torch.isinf(b)):
        return False
    fin = torch.isfinite(a)
    return bool(torch.allclose(a[fin], b[fin], atol=tol, rtol=tol))


def _ids_live(rng, b, c, n, dev):
    ids = torch.from_numpy(rng.integers(0, n, (b, c)).astype(np.int32))
    live = torch.from_numpy(rng.random((b, c)) < 0.9)
    return ids.to(dev), live.to(dev)


def _bench_pq_adc(dev, b, m, k, n, c) -> dict:
    rng = np.random.default_rng(0)
    lut = torch.from_numpy(rng.normal(size=(b, m, k)).astype(
        np.float32)).to(dev)
    plane = torch.from_numpy(rng.integers(0, k, (n, m)).astype(
        np.uint8)).to(dev)
    ids, live = _ids_live(rng, b, c, n, dev)

    def fused():
        return adc_ops.pq_adc_fused(lut, plane, ids, live)

    def unfused():
        codes = plane[ids.long()]                    # (B, C, m) in memory
        return torch.where(live, adc_ops.pq_adc(lut, codes), -torch.inf)

    def oracle():
        return adc_ref.pq_adc_fused(lut, plane, ids, live)

    want = oracle()
    us_f = _time_call(fused, dev)
    us_u = _time_call(unfused, dev)
    us_r = _time_call(oracle, dev)
    cands = b * c
    return {
        "shape": {"B": b, "m": m, "k": k, "N": n, "C": c, "c_blk": None},
        "fused_us_per_call": round(us_f, 1),
        "unfused_us_per_call": round(us_u, 1),
        "ref_us_per_call": round(us_r, 1),
        "qps_candidates_fused": round(cands / us_f * 1e6, 0),
        "qps_candidates_unfused": round(cands / us_u * 1e6, 0),
        "fused_matches_ref": _allclose(fused(), want),
        "unfused_matches_ref": _allclose(unfused(), want),
    }


def _bench_sq8(dev, b, h, n, c) -> dict:
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32)).to(dev)
    plane = torch.from_numpy(rng.integers(0, 256, (n, h)).astype(
        np.uint8)).to(dev)
    ids, live = _ids_live(rng, b, c, n, dev)

    def fused():
        return sq8_ops.sq8_dot_fused(q, plane, ids, live)

    def unfused():
        rows = plane[ids.long()].float()             # (B, C, h) in memory
        return torch.where(live, torch.einsum("bh,bch->bc", q, rows),
                           -torch.inf)

    want = sq8_ref.sq8_dot_fused(q, plane, ids, live)
    us_f = _time_call(fused, dev)
    us_u = _time_call(unfused, dev)
    cands = b * c
    return {
        "shape": {"B": b, "h": h, "N": n, "C": c, "c_blk": None},
        "fused_us_per_call": round(us_f, 1),
        "unfused_us_per_call": round(us_u, 1),
        "qps_candidates_fused": round(cands / us_f * 1e6, 0),
        "qps_candidates_unfused": round(cands / us_u * 1e6, 0),
        "fused_matches_ref": _allclose(fused(), want),
    }


def _bench_topk(dev, b, l, h, k) -> dict:
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32)).to(dev)
    emb = torch.from_numpy(rng.normal(size=(l, h)).astype(
        np.float32)).to(dev)

    def fused():
        return at_ops.topk_scores(x, emb, k)

    def unfused():
        return at_ref.topk_scores(x, emb, k)

    ws, wi = unfused()
    gs, gi = fused()
    us_f = _time_call(fused, dev)
    us_u = _time_call(unfused, dev)
    return {
        "shape": {"B": b, "L": l, "h": h, "k": k},
        "fused_us_per_call": round(us_f, 1),
        "unfused_us_per_call": round(us_u, 1),
        "ids_bit_identical": bool(torch.equal(wi.cpu(), gi.cpu())),
        "scores_match": _allclose(gs, ws, tol=1e-5),
    }


def run(args) -> dict:
    """The report of one run at the smoke or the full shapes."""
    dev = dev_mod.resolve(args.device)
    with torch.inference_mode():
        if args.smoke:
            adc = _bench_pq_adc(dev, b=8, m=4, k=64, n=4000, c=512)
            sq8 = _bench_sq8(dev, b=8, h=32, n=4000, c=512)
            topk = _bench_topk(dev, b=8, l=128, h=32, k=6)
        else:
            adc = _bench_pq_adc(dev, b=64, m=8, k=256, n=100_000, c=2048)
            sq8 = _bench_sq8(dev, b=64, h=64, n=100_000, c=2048)
            topk = _bench_topk(dev, b=64, l=1024, h=64, k=6)

    failures = []
    for name, rep, keys in (
            ("pq_adc", adc, ("fused_matches_ref", "unfused_matches_ref")),
            ("sq8_dot", sq8, ("fused_matches_ref",)),
            ("assign_topk", topk, ("ids_bit_identical", "scores_match"))):
        for kf in keys:
            if not rep[kf]:
                failures.append(f"{name}.{kf} is False")

    return {
        "bench": "kernels",
        "smoke": bool(args.smoke),
        "backend": dev.type,
        "interpret_mode": dev.type != "cuda",
        "pq_adc": adc,
        "sq8_dot": sq8,
        "assign_topk": topk,
        "check_failures": failures,
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="CI-sized shapes")
    ap.add_argument("--check", action="store_true",
                    help="exit nonzero if any kernel disagrees with its "
                         "plain version")
    ap.add_argument("--out", default=None, help="also write JSON here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the hand-written kernels) or cpu "
                         "(their plain PyTorch versions)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    report = run(args)
    text = json.dumps(report, indent=1, sort_keys=True)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    if args.check and report["check_failures"]:
        sys.exit("kernel parity violated: "
                 + "; ".join(report["check_failures"]))


if __name__ == "__main__":
    main()

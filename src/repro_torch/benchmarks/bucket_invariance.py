"""Which query-side products give a query other bits in a batch of b rows
than in a batch of 256 (no reference counterpart: the reference leans on
XLA for this, DESIGN.md §10).

    python -m repro_torch.benchmarks.bucket_invariance [--device cuda]

For each product of the search path that mixes a query's own numbers
(the OPQ rotation, the ADC LUT, SQ8's bias, refine's and flat's batched
dots, the dispatch scores) and each of the card's score kernels, random
inputs from ``--seed`` at the ``serve_msmarco`` widths are run at 256
rows and at each bucket b of the runtime's ladder on the first b rows;
the buckets whose rows differ from the 256-row rows in any bit are
printed, for the product as written and through
:func:`repro_torch.rowwise.fixed_rows` (what the port runs), as one JSON
line.  Exit status 1 if a product as the port runs it differs.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from repro_torch import device as dev_mod
from repro_torch import rowwise
from repro_torch.kernels.assign_topk import ops as at_ops
from repro_torch.kernels.pq_adc import ops as adc_ops
from repro_torch.kernels.sq8_dot import ops as sq8_ops

BUCKETS = (1, 2, 3, 4, 8, 16, 32, 64, 128)
FULL = 256


def _differing(fn, *xs) -> list:
    """Buckets b whose rows of ``fn(*(x[:b] for x in xs))`` differ from
    the first b rows of ``fn(*xs)`` (every output of a tuple)."""
    def outs(r):
        return r if isinstance(r, tuple) else (r,)
    full = outs(fn(*xs))
    return [b for b in BUCKETS
            if not all(torch.equal(o, f[:b]) for o, f in
                       zip(outs(fn(*(x[:b].clone() for x in xs))), full))]


def run(args) -> dict:
    dev = dev_mod.resolve(args.device)
    g = torch.Generator(device=dev).manual_seed(args.seed)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=g)

    h, l, m, k = 768, args.clusters, 96, 256
    q, emb, rot = randn(FULL, h), randn(l, h), randn(h, h)
    cw, lo = randn(m, k, h // m), randn(h)
    refine_rows, flat_rows = randn(FULL, 400, h), randn(FULL, 64, h)
    products = {
        "opq rotation q @ R": (lambda x: x @ rot, (q,)),
        "adc LUT einsum": (lambda x: torch.einsum(
            "bmd,mkd->bmk", x.reshape(x.shape[0], m, -1), cw), (q,)),
        "sq8 bias q @ lo": (lambda x: x @ lo, (q,)),
        "refine dots (R' 400)": (lambda x, r: torch.einsum(
            "bh,brh->br", x, r), (q, refine_rows)),
        "flat dots (C 64)": (lambda x, r: torch.einsum(
            "bh,bch->bc", x, r), (q, flat_rows)),
        "dispatch scores q @ emb.T": (lambda x: x @ emb.T, (q,)),
    }
    out = {"device": str(dev), "buckets": list(BUCKETS), "products": {}}
    for name, (fn, xs) in products.items():
        out["products"][name] = {
            "as_written": _differing(fn, *xs),
            "fixed_rows": _differing(
                lambda *ys, fn=fn: rowwise.fixed_rows(fn, *ys), *xs)}
    if dev.type == "cuda":
        n = args.rows
        plane = torch.randint(0, 256, (n, m), device=dev, generator=g,
                              dtype=torch.uint8)
        splane = torch.randint(0, 256, (n // 4, h), device=dev, generator=g,
                               dtype=torch.uint8)
        ids = torch.randint(0, n // 4, (FULL, 8192), device=dev, generator=g,
                            dtype=torch.int32)
        ids[:, 4096:] = ids[0, 4096:]          # rows the queries share
        live = torch.rand(FULL, 8192, device=dev, generator=g) > 0.3
        lut = randn(FULL, m, k)
        out["kernels"] = {
            "topk_scores": _differing(
                lambda x: at_ops.topk_scores(x, emb, 30), q),
            "pq_adc_fused": _differing(
                lambda t, i, v: adc_ops.pq_adc_fused(
                    t.contiguous(), plane, i.contiguous(), v.contiguous()),
                lut, ids, live),
            "sq8_dot_fused": _differing(
                lambda x, i, v: sq8_ops.sq8_dot_fused(
                    x.contiguous(), splane, i.contiguous(), v.contiguous()),
                q, ids, live)}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--clusters", type=int, default=10_000)
    ap.add_argument("--rows", type=int, default=2_000_000,
                    help="code-plane rows of the kernels' inputs")
    report = run(ap.parse_args(argv))
    print(json.dumps(report))
    bad = [n for n, r in report["products"].items() if r["fixed_rows"]]
    bad += [n for n, r in report.get("kernels", {}).items() if r]
    if bad:
        sys.exit(f"bucket_invariance: rows depend on the batch size: {bad}")


if __name__ == "__main__":
    main()

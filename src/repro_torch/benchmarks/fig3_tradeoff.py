"""Paper Figure 3 — effectiveness/efficiency trade-off curves (port of
``benchmarks/fig3_tradeoff.py``).

    python -m repro_torch.benchmarks.fig3_tradeoff [--device cpu]

For each method, sweep the dispatch width and report
(candidate budget, R@100) pairs — the paper's recall-latency curve with
candidates as the latency proxy (§5.1).

The sweep rides :func:`repro_torch.core.exec.frontier.sweep` over the
shared :data:`~repro_torch.core.exec.frontier.WIDTH_GRID` /
:data:`~repro_torch.core.exec.frontier.IVF_KC_GRID` — the same grids the
offline width autotuner (``repro_torch.launch.tune``, DESIGN.md §14)
optimizes over, so this figure and the tuner can never disagree on the
operating points.  :func:`rows` draws the curves over given indexes.
"""
from __future__ import annotations

import argparse

from repro_torch import device as dev_mod
from repro_torch.benchmarks import common
from repro_torch.core import hybrid_index as hi
from repro_torch.core.exec import frontier


def _curve(search_fn, grid) -> list[tuple[float, float]]:
    """One (cost, recall) curve: fig3 reports the MEASURED mean
    candidate count as the cost axis (the tuner uses the static
    candidate_cost proxy; same grid, same point schema)."""

    def run(kc, k2):
        ev = common.evaluate(search_fn(kc, k2))
        return ev["R@100"], ev["candidates"]

    return [(p.cost, p.recall) for p in frontier.sweep(run, grid)]


def rows(idx, sup, device: dev_mod.DeviceLike = "cuda"
         ) -> dict[str, list[tuple[float, float]]]:
    """The three curves over HI²_unsup ``idx`` and HI²_sup ``sup``."""
    dev = dev_mod.resolve(device)
    qe, qt = common.queries()
    return {
        "IVF-OPQ": _curve(
            lambda kc, k2: hi.search_ivf(idx, qe, qt, kc=kc,
                                         top_r=common.TOP_R, device=dev),
            tuple((kc, 1) for kc in frontier.IVF_KC_GRID)),
        "HI2_unsup": _curve(
            lambda kc, k2: hi.search(idx, qe, qt, kc=kc, k2=k2,
                                     top_r=common.TOP_R, device=dev),
            frontier.WIDTH_GRID),
        "HI2_sup": _curve(
            lambda kc, k2: hi.search(sup, qe, qt, kc=kc, k2=k2,
                                     top_r=common.TOP_R, device=dev),
            frontier.WIDTH_GRID),
    }


def run(device: dev_mod.DeviceLike = "cuda"
        ) -> dict[str, list[tuple[float, float]]]:
    dev = dev_mod.resolve(device)
    return rows(common.unsup_index(dev), common.sup_index(dev), dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)
    for name, pts in run(args.device).items():
        print(name, " ".join(f"({c:.0f},{r:.3f})" for c, r in pts))


if __name__ == "__main__":
    main()

"""Paper Figure 4 — ablation: w.o. Term vs w.o. Clus vs full hybrid,
at matched dispatch widths (RQ2 complementarity; port of
``benchmarks/fig4_ablation.py``).

    python -m repro_torch.benchmarks.fig4_ablation [--device cpu]

:func:`rows` draws the three curves over a given HI²_unsup index, at
``common.TOP_R``, for the benchmark corpus's queries unless given
others.
"""
from __future__ import annotations

import argparse

from repro_torch import device as dev_mod
from repro_torch.benchmarks import common
from repro_torch.core import hybrid_index as hi

#: the widths of each curve
IVF_KC = (2, 4, 8, 12, 16)
TERM_K2 = (2, 4, 8, 12, 16)
HYBRID = ((1, 2), (2, 4), (4, 8), (6, 12), (8, 16))


def rows(idx, device: dev_mod.DeviceLike = "cuda", queries=None,
         qrels=None) -> dict[str, list[tuple[float, float]]]:
    """The curves over ``idx``: (mean candidates, R@100) per width, for
    ``queries`` ((embeddings, tokens), default the benchmark corpus's)
    against ``qrels`` (default its qrels)."""
    dev = dev_mod.resolve(device)
    qe, qt = common.queries() if queries is None else queries
    top_r = common.TOP_R

    def point(res):
        ev = common.evaluate(res, qrels)
        return (ev["candidates"], ev["R@100"])

    return {
        "w.o.Term(IVF)": [
            point(hi.search_ivf(idx, qe, qt, kc=kc, top_r=top_r,
                                device=dev))
            for kc in IVF_KC],
        "w.o.Clus(term-only)": [
            point(hi.search_term_only(idx, qe, qt, k2=k2, top_r=top_r,
                                      device=dev))
            for k2 in TERM_K2],
        "HI2(full)": [
            point(hi.search(idx, qe, qt, kc=kc, k2=k2, top_r=top_r,
                            device=dev))
            for kc, k2 in HYBRID],
    }


def run(device: dev_mod.DeviceLike = "cuda"
        ) -> dict[str, list[tuple[float, float]]]:
    dev = dev_mod.resolve(device)
    return rows(common.unsup_index(dev), dev)


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

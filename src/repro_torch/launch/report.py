"""Roofline report: reads the dry run's JSON records and emits the
tables (port of ``repro/launch/report.py``: ``load_records``,
``roofline_row``, ``fmt_s`` and ``emit_tables``), at the H100 peaks of
:mod:`repro_torch.launch.roofline`.

    PYTHONPATH=src python -m repro_torch.launch.report --dir build/dryrun

Each record describes one card, so the terms divide by its
``n_devices`` (1).  A table is titled by its mesh and by the card and
power limit its records were counted on (``nvidia-smi``'s line; "no card
visible" for a CPU dry run).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch import roofline


def _model_flops_for(cell: dict) -> float | None:
    """MODEL_FLOPS = 6·N_active·D (train) / 2·N_active·D (inference)."""
    from repro_torch.configs import registry
    arch_id, shape_name = cell["cell"].split("/")
    arch = registry.get(arch_id)
    shape = arch.shapes[shape_name]
    if arch.family != "lm":
        return None
    cfg = arch.make_config(shape)
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return roofline.model_flops(n_active, tokens, training=True)
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return roofline.model_flops(n_active, tokens, training=False)
    # decode: one token per sequence
    return roofline.model_flops(n_active, shape.global_batch,
                                training=False)


def load_records(directory: str, tag: str) -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(directory, f"*_{tag}.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def roofline_row(rec: dict) -> dict | None:
    if rec.get("status") != "ok":
        return None
    n = rec["n_devices"]
    cost = rec["cost"]
    terms = roofline.roofline_terms(cost["flops"], cost["bytes"],
                                    rec["collectives"]["total_bytes"], n)
    mf = _model_flops_for(rec)
    row = dict(cell=rec["cell"], n_devices=n,
               hbm_gb=rec["memory"]["per_device_gb"], fits=rec.get("fits"),
               **terms)
    row["useful_frac"] = (mf / cost["flops"]) if (mf and cost["flops"]) \
        else None
    # roofline fraction: ideal (dominant-term) time / sum of all terms —
    # how close a perfectly-overlapped execution would run to the
    # dominant-resource bound
    tot = terms["compute_s"] + terms["memory_s"] + terms["collective_s"]
    dom = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    row["roofline_frac"] = dom / tot if tot else None
    return row


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def emit_tables(directory: str) -> str:
    out = []
    for tag, title in (("sp", "single-pod 16×16"),
                       ("mp", "multi-pod 2×16×16")):
        recs = load_records(directory, tag)
        if not recs:
            continue
        cards = sorted({r["card"] for r in recs if r.get("card")})
        where = ", ".join(cards) if cards else "no card visible"
        out.append(f"\n### Mesh: {title}; terms at one H100's peaks "
                   f"({roofline.PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16, "
                   f"{roofline.HBM_BW / 1e12:.2f} TB/s HBM, "
                   f"{roofline.LINK_BW / 1e9:.0f} GB/s NVLink); counted "
                   f"on: {where}\n")
        out.append("| cell | status | HBM GB/dev | fits | compute | memory | "
                   "collective | dominant | MODEL/counted flops | "
                   "roofline frac |")
        out.append("|---|---|---|---|---|---|---|---|---|---|")
        for rec in recs:
            if rec["status"] == "skipped":
                out.append(f"| {rec['cell']} | SKIP ({rec['reason'][:40]}…) "
                           f"| – | – | – | – | – | – | – | – |")
                continue
            if rec["status"] != "ok":
                out.append(f"| {rec['cell']} | **FAILED** | – | – | – | – "
                           f"| – | – | – | – |")
                continue
            row = roofline_row(rec)
            uf = f"{row['useful_frac']:.2f}" if row["useful_frac"] else "n/a"
            fit = "n/a" if row["fits"] is None else (
                "yes" if row["fits"] else "no")
            out.append(
                f"| {row['cell']} | ok | {row['hbm_gb']:.2f} | {fit} "
                f"| {fmt_s(row['compute_s'])} | {fmt_s(row['memory_s'])} "
                f"| {fmt_s(row['collective_s'])} | {row['dominant']} "
                f"| {uf} | {row['roofline_frac']:.2f} |")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join("build", "dryrun"))
    args = ap.parse_args(argv)
    print(emit_tables(args.dir))


if __name__ == "__main__":
    main()

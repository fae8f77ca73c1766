"""``sq8_dot_fused``' share of its roofline: the least time each batch of
the window needs by ``counts/sq8_dot_fused.py`` (its own live slots and
distinct live rows), summed, over the kernel's device time there."""

from hi2bench import spec

KERNEL = r"\bsq8_grouped\b"


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    sel = t.select(KERNEL)
    batches = ctx.batch_live()
    if not sel.any() or not batches:
        return None
    cfg = ctx.cfg
    need = sum(spec.bound_s("sq8_dot_fused", b=b["b"], c=b["c"],
                            h=cfg["hidden"], n_live=b["n_live"],
                            distinct=b["distinct"]) for b in batches)
    return 100.0 * need / t.seconds(sel)

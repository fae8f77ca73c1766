"""``pq_adc_fused``' share of its roofline: the least time each batch of
the window needs by ``counts/pq_adc_fused.py`` (its own live slots and
distinct live rows), summed, over the kernel's device time there."""

from hi2bench import spec

KERNEL = r"\badc_fused\b"


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    sel = t.select(KERNEL)
    batches = ctx.batch_live()
    if not sel.any() or not batches:
        return None
    cfg = ctx.cfg
    need = sum(spec.bound_s("pq_adc_fused", b=b["b"], c=b["c"], m=cfg["pq_m"],
                            k=cfg["pq_k"], n_live=b["n_live"],
                            distinct=b["distinct"]) for b in batches)
    return 100.0 * need / t.seconds(sel)

"""``topk_scores``' share of its roofline: the least time its work needs
(``counts/topk_scores.py`` at each batch's rows) summed over the batches
the runtime ran in the window, over the kernel's device time there."""

from hi2bench import spec

KERNEL = r"\btopk_kernel\b"


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    sel = t.select(KERNEL)
    if not sel.any():
        return None
    cfg = ctx.cfg
    need = sum(n * spec.bound_s("topk_scores", n=b, l=cfg["n_clusters"],
                                h=cfg["hidden"], k=cfg["kc"])
               for b, n in ctx.bucket_batches().items())
    return 100.0 * need / t.seconds(sel)

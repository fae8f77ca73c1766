"""Device ms a batch: every kernel and memset of the traced window (the
search stages, all inside the bucket's graph; the runtime's copies in
and out left out) over the batches the runtime ran in it."""


def read(ctx):
    t = ctx.trace
    batches = ctx.stats1["n_batches"] - ctx.stats0["n_batches"]
    if t is None or batches <= 0:
        return None
    work = t.kinds != "memcpy"
    if not work.any():
        return None
    return t.seconds(work) * 1e3 / batches

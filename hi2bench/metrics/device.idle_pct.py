"""Share of the traced window in which no device operation ran
(``torch.profiler``, CUPTI)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.names.size == 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

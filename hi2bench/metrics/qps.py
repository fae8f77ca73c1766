"""Queries completed by the window's end over the window's seconds; a
request that failed, or that admission control rejected, completes
nothing."""

import numpy as np


def read(ctx):
    log = ctx.log
    done = np.isfinite(log.done) & (log.done <= log.t1)
    return ctx.mix["rows_per_request"] * int(done.sum()) / (log.t1 - log.t0)

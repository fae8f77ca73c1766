"""Device ms a batch in the sort kernels (gather, dedup and the top-R′
selection sort stably): every kernel that a sort launches, matched by
the table below, over the batches the runtime ran in the window."""

#: profiler names of the kernels that torch's sort launches on the card
SORT_KERNELS = (
    r"RadixSort",                  # cub: onesweep, histogram, segmented
    r"SegmentedSort",
    r"[Ss]ortKVInPlace",           # torch's in-place small sorts
    r"MergeSort",
    r"BlockSort",
    r"fill_index_and_segment",     # torch's segmented-sort set-up
    r"sort_postprocess",
)


def read(ctx):
    t = ctx.trace
    batches = ctx.stats1["n_batches"] - ctx.stats0["n_batches"]
    if t is None or t.names.size == 0 or batches <= 0:
        return None
    sel = t.select("|".join(SORT_KERNELS)) & (t.kinds == "kernel")
    if not sel.any():
        return None
    return t.seconds(sel) * 1e3 / batches

"""``topk_scores``: the top-k of x·embᵀ for N queries over L clusters of
width h.  Operations: the product's 2·N·L·h, at the float32 FMA peak,
since the dispatch ids must equal the float32 product's exactly.
Bytes: the queries and the cluster plane read once, (score, id) pairs of
k a query written once."""

PEAK = "fp32_flops"


def work(n: int, l: int, h: int, k: int) -> tuple:
    return 2 * n * l * h, 4 * (n * h + l * h) + 8 * n * k

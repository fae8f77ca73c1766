"""``sq8_dot_fused``: a batch of b queries over C candidate slots each,
n_live of them live, against h-byte SQ8 rows.  Bytes: each slot's 4-byte
id (a dead slot has to be read to be skipped); a 4-byte score for each
live slot; the b scaled float32 queries; each distinct live document's h
code bytes once.  Operations: a multiply and an add a live slot and
dimension."""

PEAK = "fp32_flops"


def work(b: int, c: int, h: int, n_live: int, distinct: int) -> tuple:
    return 2 * n_live * h, 4 * b * c + 4 * n_live + b * h * 4 + distinct * h

"""``pq_adc_fused``: a batch of b queries over C candidate slots each,
n_live of them live, against m-code OPQ rows (k codewords a code).
Bytes: each slot's 4-byte id (a dead slot has to be read to be skipped);
a 4-byte score for each live slot; the b (m, k) float32 tables; each
distinct live document's m code bytes once.  Operations: one add a live
slot and code."""

PEAK = "fp32_flops"


def work(b: int, c: int, m: int, k: int, n_live: int, distinct: int
         ) -> tuple:
    return n_live * m, 4 * b * c + 4 * n_live + b * m * k * 4 + distinct * m

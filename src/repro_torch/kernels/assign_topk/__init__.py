"""Dispatch top-k kernel (port of ``repro/kernels/assign_topk``: the
``topk_scores`` entry; ``assign_argmax`` is still to be ported)."""

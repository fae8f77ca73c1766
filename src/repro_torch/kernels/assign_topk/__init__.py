"""Dispatch top-k and KMeans assignment kernels (port of
``repro/kernels/assign_topk``: the ``topk_scores`` and ``assign_argmax``
entries)."""

"""Joint optimisation of HI²_sup, paper §4.3 (port of
``repro/core/distill.py``: the parameter bundle ``DistillParams``; the
losses, ``kl``, ``loss_fn``, the negative mines and ``DistillBatch``
come with supervised training).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import term_selector as ts_mod


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


class DistillParams(NamedTuple):
    cluster_embeddings: torch.Tensor   # (L, h)
    term_mlp: ts_mod.TermMLP
    encoder: dict                      # the term-scorer encoder's params

    def to(self, device) -> "DistillParams":
        return DistillParams(self.cluster_embeddings.to(device),
                             self.term_mlp.to(device),
                             _tree_to(self.encoder, device))

"""The latency proxy of DESIGN.md §2 (port of
``repro/core/exec/cost.py``): static candidate slots per query, plus
the codec's refine work."""
from __future__ import annotations

from typing import Iterable, Tuple

from repro_torch.core import codecs

Family = Tuple[int, int]     # (cluster list capacity, term list capacity)


def candidate_budget(kc: int, k2: int, families: Iterable[Family]) -> int:
    """Static per-query candidate slots over every gather source."""
    return sum(kc * c_cap + k2 * t_cap for c_cap, t_cap in families)


def candidate_cost(codec_spec: str, kc: int, k2: int, top_r: int,
                   families: Iterable[Family]) -> int:
    """:func:`candidate_budget` plus the codec's refine work."""
    return codecs.get(codec_spec).candidate_cost(
        candidate_budget(kc, k2, families), top_r)

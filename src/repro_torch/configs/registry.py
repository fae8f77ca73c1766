"""Architecture registry: ``--arch <id>`` resolution for every launcher
(port of ``repro/configs/registry.py``).

Each entry carries the exact published config, a reduced smoke-test
config (same family, small dims), its shape set, and per-shape skips
with reasons (DESIGN.md §4).  The port registers the families it has:
recsys (``dlrm-rm2``, ``sasrec``, ``dien``, ``mind``), the GNN
(``gatedgcn``), the dense LMs (``llama3-8b``, ``internlm2-1.8b``,
``stablelm-3b``), the MoE LMs (``mixtral-8x22b``, ``olmoe-1b-7b``) and
``hi2-synth``: every arch the reference registers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ArchDef:
    arch_id: str
    family: str                            # "lm" | "gnn" | "recsys" | "hi2"
    source: str
    make_config: Callable[..., Any]              # (shape=None) -> config
    make_reduced: Callable[[], Any]              # smoke config
    shapes: dict[str, Any]
    skip_shapes: dict[str, str] = dataclasses.field(default_factory=dict)
    extra: bool = False                    # beyond the 10 assigned archs


_REGISTRY: dict[str, ArchDef] = {}


def register(arch: ArchDef) -> ArchDef:
    _REGISTRY[arch.arch_id] = arch
    return arch


def get(arch_id: str) -> ArchDef:
    if arch_id not in _REGISTRY:
        _load_all()
    return _REGISTRY[arch_id]


def all_archs() -> dict[str, ArchDef]:
    _load_all()
    return dict(_REGISTRY)


def _load_all() -> None:
    # import side effects register each arch
    from repro_torch.configs import (dien, dlrm_rm2,  # noqa: F401
                                     gatedgcn, hi2_synth, internlm2_1_8b,
                                     llama3_8b, mind, mixtral_8x22b,
                                     olmoe_1b_7b, sasrec, stablelm_3b)


def cells(include_skipped: bool = False,
          include_extra: bool = False) -> list[tuple[str, str]]:
    """Every (arch_id, shape_name) pair — the dry-run grid.

    The assigned cells by default;
    ``include_extra`` adds the paper's own hi2-synth serving cells.
    """
    out = []
    for aid, arch in sorted(all_archs().items()):
        if arch.extra and not include_extra:
            continue
        for shape_name in arch.shapes:
            if shape_name in arch.skip_shapes and not include_skipped:
                continue
            out.append((aid, shape_name))
    return out

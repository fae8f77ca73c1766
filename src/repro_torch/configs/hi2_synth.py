"""hi2-synth — the paper's OWN system at production scale, as a dry-run
cell (extra, beyond the 10 assigned archs): HI²_sup serving over an
MS MARCO-scale corpus (port of ``repro/configs/hi2_synth.py``).

    corpus   8,841,823 docs × h=768        (paper §5.1)
    clusters L=10,000  (capacity 1024 ≈ paper avg 884 + headroom)
    terms    V=30,522 (BERT vocab), K₁ᵀ=3 ⇒ capacity 1024
    codec    OPQ m=96, k=256
    search   K^C=30, K₂ᵀ=32, R=100 (the HI²_sup operating point)
    queries  batch 256 × 32 tokens
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import registry


@dataclasses.dataclass(frozen=True)
class HI2ServeShape:
    name: str
    kind: str = "hi2_serve"
    n_docs: int = 8_841_984     # 8,841,823 padded to a multiple of 512
    hidden: int = 768
    n_clusters: int = 10_000
    vocab: int = 30_528         # 30,522 padded to a multiple of 16
    cluster_capacity: int = 1_024
    term_capacity: int = 1_024
    pq_m: int = 96
    pq_k: int = 256
    codec: str = "opq"          # any repro_torch.core.codecs spec
    kc: int = 30
    k2: int = 32
    top_r: int = 100
    query_batch: int = 256
    query_len: int = 32


@dataclasses.dataclass(frozen=True)
class HI2ShardedServeShape(HI2ServeShape):
    """Document-sharded serving (DESIGN.md §6): doc planes split over
    the mesh model axis (16-way on the single-pod mesh → ~553k docs ×
    96 uint8 codes ≈ 53 MB per device), queries over the data axis."""
    kind: str = "hi2_serve_sharded"


@dataclasses.dataclass(frozen=True)
class HI2FilteredServeShape(HI2ServeShape):
    """Filtered serving (DESIGN.md §9): the same serving step plus a
    per-doc namespace plane ((n_docs,) i32, doc-sharded like every
    other doc plane) and a per-query namespace bitmap
    ((batch, ⌈N/32⌉) u32, batch-sharded like the queries) — multi-tenant
    isolation at the paper's operating point with zero extra budget."""
    kind: str = "hi2_serve_filtered"
    n_namespaces: int = 64      # tenants; bitmap width = 2 u32 words


@dataclasses.dataclass(frozen=True)
class HI2BucketServeShape(HI2ServeShape):
    """One serving-runtime micro-batch bucket (DESIGN.md §10): the same
    §2 serving step at a small power-of-two query batch.  The runtime
    pre-compiles one program per bucket; this cell lowers the smallest
    interesting rung at MS MARCO scale to keep the bucket ladder's
    compile story visible in the dry-run grid (the ``serve_msmarco``
    cell is the ``max_batch`` rung)."""
    kind: str = "hi2_serve_bucket"
    query_batch: int = 8


@dataclasses.dataclass(frozen=True)
class HI2Config:
    pass


ARCH = registry.register(registry.ArchDef(
    arch_id="hi2-synth", family="hi2", source="this paper (HI², §5.1)",
    make_config=lambda shape=None: HI2Config(),
    make_reduced=lambda: HI2Config(),
    shapes={"serve_msmarco": HI2ServeShape("serve_msmarco"),
            "serve_msmarco_sharded":
                HI2ShardedServeShape("serve_msmarco_sharded"),
            # the refine index setting (DESIGN.md §7): sq8 stage-1 codes
            # (768 B/doc, still 1/4 of flat) + fp16 refine plane, exact
            # re-rank of the merged top-R′ frontier after the shard merge
            "serve_msmarco_refine_sq8":
                HI2ShardedServeShape("serve_msmarco_refine_sq8",
                                     codec="refine:sq8:4"),
            # filtered search (DESIGN.md §9): 64-tenant namespace bitmaps
            # through the exec layer's filter stage
            "serve_msmarco_filtered":
                HI2FilteredServeShape("serve_msmarco_filtered"),
            # the serving runtime's smallest micro-batch bucket (§10)
            "serve_msmarco_bucket8":
                HI2BucketServeShape("serve_msmarco_bucket8")},
    extra=True))

"""KMeans, single device (port of ``repro/core/kmeans.py``:
``assign_blocked``, ``_update``, ``_reseed_empty``, ``kmeans_fit`` and
``kmeans_cost``; ``kmeans_fit_sharded`` comes with multi-device).

The substrate of the cluster selector (paper §4.1: cluster embeddings
from KMeans over all document embeddings) and of PQ training (one
KMeans per embedding fragment, §3.2).  Assignment goes through
:func:`repro_torch.kernels.assign_topk.ops.assign_argmax`: on a CUDA
tensor the hand-written kernel, one launch per call over the whole
(m, n, h) batch (it builds no (n, L) score plane); on a CPU tensor its
plain version, a fp32 matmul + argmax in blocks of ``block`` points as
in the reference (``assign_blocked``, plain jnp there).  TF32 stays off
(``repro_torch/__init__.py``), since it would move assignments.  Every function also takes a leading batch axis — points
(m, n, h) against centroids (m, L, h) — which is the reference's
``vmap`` of m independent fits written out (``pq.train_pq``).

Initialisation and reseeding draw from an explicit ``torch.Generator``
on the points' device; they cannot match ``jax.random`` bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.assign_topk import ops as at_ops


def _assign(x: torch.Tensor, c: torch.Tensor, block: int) -> torch.Tensor:
    x, c = x.float(), c.float().contiguous()
    if x.device.type == "cuda":
        return at_ops.assign_argmax(x, c)[1]
    return torch.cat([at_ops.assign_argmax(xb, c)[1]
                      for xb in x.split(block, dim=1)], dim=1)


#: rows narrower than this many elements are summed column by column
NARROW = 32


def segment_sum(values: torch.Tensor, segments: torch.Tensor,
                n_segments: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Sums of the rows of ``values`` (n, ...) per segment id
    (``segments``, (n,) in [0, n_segments)) → ((n_segments, ...) sums,
    (n_segments,) i64 row counts), each segment's rows added in row
    order, ((0 + v₀) + v₁) + …, on every device.

    CUDA's float ``index_add_`` adds with atomics, in an order that
    changes from run to run, so two builds with one seed would differ
    (KMeans centroids, then every list).  Here a stable sort groups each
    segment's rows in row order and ``segment_reduce`` adds each run, one
    thread per segment and column on the card: the CPU ``index_add_``'s
    own order, so the CPU's bits are unchanged and the card's equal them
    on equal inputs.  A long segment is one long serial add on the card,
    so callers drop the rows they do not need summed."""
    # the narrowest key type that holds every id and n_segments: the
    # card's radix sort takes one pass per key byte, and a stable sort's
    # order is the same whatever the type
    key = segments.long()
    for t in (torch.int16, torch.int32):
        if n_segments < torch.iinfo(t).max:
            key = segments.to(t)
            break
    sorted_key, order = torch.sort(key, stable=True)
    # exact row counts from the sorted ids (no histogram atomics)
    counts = torch.searchsorted(sorted_key, torch.arange(
        n_segments + 1, dtype=key.dtype, device=key.device)).diff()
    rows = values.reshape(values.shape[0], -1)
    w = rows.shape[1]
    if w < NARROW:
        # narrow rows (PQ's 32-byte fragments) gathered in sorted order
        # are random 32-byte reads: on an H100 a (w, n) copy, a gather
        # inside each column and a sum along it take a third of their
        # time (benchmarks/build_repeat.py --parts).  2-D, since the
        # card's segment_reduce sums a 1-D input with a tree
        cols = torch.gather(rows.T.contiguous(), 1, order.expand(w, -1))
        sums = torch.segment_reduce(
            cols, "sum", lengths=counts.expand(w, -1).contiguous(),
            axis=1).T.contiguous()
    else:
        sums = torch.segment_reduce(torch.index_select(rows, 0, order),
                                    "sum", lengths=counts, axis=0)
    return sums.reshape((n_segments,) + tuple(values.shape[1:])), counts


def _sums(x: torch.Tensor, assign: torch.Tensor, n_clusters: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    m, _, h = x.shape
    flat = (assign.long() + n_clusters * torch.arange(
        m, device=x.device)[:, None]).reshape(-1)
    sums, counts = segment_sum(x.reshape(-1, h).float(), flat,
                               m * n_clusters)
    return (sums.reshape(m, n_clusters, h),
            counts.float().reshape(m, n_clusters))


def _reseed(generator: torch.Generator, c: torch.Tensor,
            counts: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    m, n, h = x.shape
    idx = torch.randint(0, n, c.shape[:2], generator=generator,
                        device=x.device)
    cand = torch.gather(x, 1, idx[..., None].expand(-1, -1, h)).float()
    return torch.where((counts < 0.5)[..., None], cand, c)


def _init(generator: torch.Generator, x: torch.Tensor, n_clusters: int
          ) -> torch.Tensor:
    """n_clusters distinct random points per batch (with replacement
    only when there are fewer points than clusters)."""
    m, n, h = x.shape
    if n >= n_clusters:
        idx = torch.rand((m, n), generator=generator,
                         device=x.device).argsort(dim=-1)[:, :n_clusters]
    else:
        idx = torch.randint(0, n, (m, n_clusters), generator=generator,
                            device=x.device)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, h)).float()


def assign_blocked(x: torch.Tensor, centroids: torch.Tensor,
                   block: int = 4096) -> torch.Tensor:
    """argmin_j ‖x_i − c_j‖² for every point, in blocks of ``block``
    points: ‖x‖² is constant per point, so the argmin is the argmax of
    ⟨x, c⟩ − ‖c‖²/2 (ties to the lower index).  (n, h) × (L, h) → (n,)
    i32, or batched (m, n, h) × (m, L, h) → (m, n) i32."""
    if x.dim() == 3:
        return _assign(x, centroids, block)
    return _assign(x[None], centroids[None], block)[0]


def _update(x: torch.Tensor, assign: torch.Tensor, n_clusters: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Centroid sums (L, h) and counts (L,) of the points assigned to
    each cluster (batched: (m, L, h), (m, L))."""
    if x.dim() == 3:
        return _sums(x, assign, n_clusters)
    sums, counts = _sums(x[None], assign[None], n_clusters)
    return sums[0], counts[0]


def _reseed_empty(generator: torch.Generator, centroids: torch.Tensor,
                  counts: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Empty clusters are re-seeded to random points (the standard Lloyd
    fix): one candidate point is drawn per cluster and used only where
    the cluster is empty."""
    if x.dim() == 3:
        return _reseed(generator, centroids, counts, x)
    return _reseed(generator, centroids[None], counts[None], x[None])[0]


def kmeans_fit(generator: torch.Generator, x: torch.Tensor, n_clusters: int,
               n_iters: int = 20, block: int = 4096
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm → (centroids (L, h) f32, assignments (n,) i32),
    or batched over a leading axis: (m, L, h), (m, n)."""
    xb = x if x.dim() == 3 else x[None]
    c = _init(generator, xb, n_clusters)
    for _ in range(n_iters):
        sums, counts = _sums(xb, _assign(xb, c, block), n_clusters)
        c = _reseed(generator, sums / torch.clamp(counts, min=1.0)[..., None],
                    counts, xb)
    a = _assign(xb, c, block)
    return (c, a) if x.dim() == 3 else (c[0], a[0])


def kmeans_cost(x: torch.Tensor, centroids: torch.Tensor,
                assign: torch.Tensor) -> torch.Tensor:
    """Mean squared distance of points to their assigned centroid."""
    d = x.float() - centroids[assign.long()]
    return torch.mean(torch.sum(d * d, dim=-1))

"""Mixture-of-Experts FFN with top-k routing and capacity-bounded
dispatch (port of ``repro/models/moe.py``: ``init``, ``MoEStats``,
``forward``, ``_local_moe_body`` and ``forward_shard_map``).

    router logits (N, E) → top-k ids / weights (N, k)
    position in expert   = running count over the (token, slot) order
    expert buffer (E, C, d) ← the kept assignments' rows
    expert SwiGLU (E, C, d) × (E, d, f) batched products
    token out ← each slot's expert row × routing weight, slot by slot

The reference's numerics are kept where they decide bits or routes:

* the top-k is a stable descending sort, so tied probabilities go to the
  lower expert as ``lax.top_k`` gives them (PyTorch's own top-k breaks
  ties otherwise, and at bf16 the router logits tie often);
* the gate and up products stay f32 through silu and their product,
  which is rounded once to x's dtype; the down product is f32, then
  rounded (:func:`repro_torch.models.layers.matmul_f32`);
* the combine adds the k slots one at a time in slot order, rounding to
  x's dtype after each add, as the reference's ``segment_sum`` of the
  slot rows does; the routing weight is rounded to x's dtype first.

Every step is the same bits on every run of the card, so a layer that
``torch.utils.checkpoint`` recomputes routes as its forward did: the
token rows reach the buffer through a broadcast (whose backward is a sum
over the k slots, not an atomic add) and an ``index_put`` at unique
slots, and the positions come from a stable sort by expert.

:func:`forward_shard_map` is the data-parallel layout on a
:class:`repro_torch.distributed.collectives.Mesh`: each data position
dispatches its own tokens into its own capacity buffer, each model
position holds a slice of every expert's ffn dim, and the partial
outputs are summed over ``model``.  The mesh is an argument where the
reference reads the ambient one.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from repro_torch import work
from repro_torch.distributed import collectives
from repro_torch.models import layers


def init(generator: torch.Generator, d_model: int, d_ff: int,
         n_experts: int, dtype=torch.float32) -> dict:
    """The router (``layers.dense_init``, f32 whatever ``dtype``), then
    ``w_gate`` and ``w_up`` (E, d, f) at d^-½ and ``w_down`` (E, f, d)
    at f^-½ in ``dtype``, drawn in that order from ``generator``."""
    def ew(shape, scale):
        return (layers._normal(generator, shape) * scale).to(dtype)

    return {
        "router": layers.dense_init(generator, d_model, n_experts,
                                    torch.float32),
        "w_gate": ew((n_experts, d_model, d_ff), d_model ** -0.5),
        "w_up": ew((n_experts, d_model, d_ff), d_model ** -0.5),
        "w_down": ew((n_experts, d_ff, d_model), d_ff ** -0.5),
    }


class MoEStats(NamedTuple):
    aux_loss: torch.Tensor      # Switch load-balance loss, 0-dim f32
    dropped_frac: torch.Tensor  # share of assignments dropped at capacity


class Route(NamedTuple):
    """One MoE call's routing, as :func:`record_routes` keeps it."""
    expert: torch.Tensor        # (N, k) expert ids, lax.top_k's order
    position: torch.Tensor      # (N, k) place in the expert's buffer
    kept: torch.Tensor          # (N, k) bool: position < capacity
    logits: torch.Tensor        # (N, E) f32 router logits
    where: tuple = ()           # the mesh position; () off a mesh


_routes: Optional[list] = None


@contextlib.contextmanager
def record_routes():
    """Collect the :class:`Route` of every MoE call made inside the block
    (detached; a mesh's positions append from their threads).  Under
    remat a recomputed layer records again."""
    global _routes
    outer, _routes = _routes, []
    try:
        yield _routes
    finally:
        _routes = outer


def capacity_for(n_tokens: int, top_k: int, capacity_factor: float,
                 n_experts: int) -> int:
    """Buffer slots an expert: ``max(int(n·k·cf / E), 1)``."""
    return max(int(n_tokens * top_k * capacity_factor / n_experts), 1)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, descending, equal
    values in ascending index order (a stable descending sort)."""
    values, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], ids[..., :k]


def _positions(flat_e: torch.Tensor, n_experts: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each assignment's place among its expert's assignments in flat
    (token, slot) order — the reference's cumsum over the (N·k, E)
    one-hot, from a stable sort by expert — and the count an expert
    (int64, added into E zeros: a static shape, so the routes also run on
    fake tensors, where ``bincount``'s output size depends on the
    data)."""
    counts = flat_e.new_zeros(n_experts).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    order = torch.sort(flat_e, stable=True).indices
    rank = torch.arange(flat_e.numel(), device=flat_e.device) - (
        starts[flat_e[order]])
    return torch.empty_like(rank).index_put_((order,), rank), counts


def combine(flat_out: torch.Tensor, w: torch.Tensor, k: int
            ) -> torch.Tensor:
    """Token rows from the (N·k, d) slot rows (token-major) and their
    weights (N·k,) in the rows' dtype: the weighted rows added slot by
    slot from zero, rounded to the rows' dtype after each add — the bits
    of the reference's ``segment_sum`` over the slots (a sum in f32
    rounded once differs at bf16)."""
    nk, d = flat_out.shape
    weighted = (flat_out * w[:, None]).view(nk // k, k, d)
    out = flat_out.new_zeros((nk // k, d))
    for j in range(k):
        out = out + weighted[:, j]
    return out


def _moe(xt: torch.Tensor, logits: torch.Tensor, w_gate: torch.Tensor,
         w_up: torch.Tensor, w_down: torch.Tensor, *, n_experts: int,
         top_k_: int, capacity: int, where: tuple = ()
         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Route, dispatch, expert SwiGLU and combine of tokens ``xt`` (n, d)
    under router ``logits`` (n, E) f32, the expert weights in xt's dtype
    → (out (n, d) in xt's dtype, aux f32, dropped share f32)."""
    n, d = xt.shape
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = top_k(probs, top_k_)
    top_w = top_w / torch.clamp(top_w.sum(dim=-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(-1)
    pos, counts = _positions(flat_e, n_experts)
    flat_keep = pos < capacity
    if _routes is not None:
        _routes.append(Route(top_e.detach(), pos.view(n, top_k_).detach(),
                             flat_keep.view(n, top_k_), logits.detach(),
                             where))

    # dispatch: each kept (expert, position) slot is written once; the
    # dropped assignments all go to one spare row past the buffer
    slot = flat_e * capacity + pos
    spare = n_experts * capacity
    rows = xt[:, None, :].expand(n, top_k_, d)
    buf = xt.new_zeros((spare + 1, d)).index_put(
        (torch.where(flat_keep, slot, spare).view(n, top_k_),), rows)
    buf = buf[:spare].view(n_experts, capacity, d)

    gate = layers.matmul_f32(buf, w_gate)
    up = layers.matmul_f32(buf, w_up)
    if torch.is_grad_enabled():
        h = torch.nn.functional.silu(gate) * up
    else:      # the same values, two (E, C, f) f32 planes fewer
        h = torch.nn.functional.silu(gate, inplace=True).mul_(up)
    out_buf = layers.matmul_f32(h.to(xt.dtype), w_down).to(xt.dtype)

    # combine: a dropped assignment reads its expert's slot 0 at weight 0
    flat_out = out_buf.view(spare, d)[
        torch.where(flat_keep, slot, flat_e * capacity)]
    out = combine(flat_out, (flat_keep * top_w.reshape(-1)).to(xt.dtype),
                  top_k_)

    # Switch aux loss: E · Σ_e f_e · P_e (top-k ids are distinct a token,
    # so f_e is the share of tokens routed to e); divisors are tensors,
    # as CUDA would multiply by a Python scalar's reciprocal
    n_t = torch.tensor(n, dtype=torch.float32, device=xt.device)
    f_e = counts.float() / n_t
    p_e = probs.sum(dim=0) / n_t
    aux = n_experts * torch.sum(f_e * p_e)
    dropped = 1.0 - flat_keep.sum().float() / (n_t * top_k_)
    return out, aux, dropped


def forward(params: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25
            ) -> tuple[torch.Tensor, MoEStats]:
    """x (B, S, D) → (B, S, D), with capacity from all B·S tokens.  The
    router logits are ``layers.dense``'s (rounded to x's dtype), then
    f32."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    logits = layers.dense(params["router"], xt).float()
    out, aux, dropped = _moe(
        xt, logits, params["w_gate"].to(x.dtype), params["w_up"].to(x.dtype),
        params["w_down"].to(x.dtype), n_experts=n_experts, top_k_=top_k,
        capacity=capacity_for(b * s, top_k, capacity_factor, n_experts))
    return out.reshape(b, s, d), MoEStats(aux_loss=aux, dropped_frac=dropped)


# --------------------------------------------------------------------------
# the data-parallel layout on a mesh (the reference's shard_map)
# --------------------------------------------------------------------------

def _local_moe_body(xt: torch.Tensor, router_w: torch.Tensor,
                    w_gate: torch.Tensor, w_up: torch.Tensor,
                    w_down: torch.Tensor, *, n_experts: int, top_k: int,
                    capacity: int, where: tuple = ()
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One position's MoE over its own tokens ``xt`` (n_local, d) with
    fully local dispatch, its expert weights a slice of the ffn dim in
    xt's dtype → (partial out, aux, dropped share).  Here the router
    logits are the f32 product, never rounded to xt's dtype."""
    logits = layers.matmul_f32(xt, router_w.to(xt.dtype))
    return _moe(xt, logits, w_gate, w_up, w_down, n_experts=n_experts,
                top_k_=top_k, capacity=capacity, where=where)


def _add_in_order(xs: list, device: torch.device) -> torch.Tensor:
    """((x₀ + x₁) + x₂) + … on ``device``: the psum's rank order."""
    acc = xs[0].to(device)
    for x in xs[1:]:
        acc = acc + x.to(device)
    return acc


def forward_shard_map(params: dict, x: torch.Tensor, *, n_experts: int,
                      top_k: int, capacity_factor: float = 1.25,
                      mesh: Optional[collectives.Mesh] = None
                      ) -> tuple[torch.Tensor, MoEStats]:
    """The MoE layer on ``mesh``'s positions → ((B, S, D) on x's device,
    stats).  The batch splits over the ``pod`` / ``data`` axes, each data
    position routing its B·S / |data| tokens into buffers of its own
    capacity ``max(int(n_local·k·cf/E), 1)``; model position j holds
    the j-th slice of every expert's ffn dim (the weights cast to x's
    dtype, as the reference gathers them), and the outputs are summed
    over ``model`` in rank order.  aux and dropped are averaged over the
    data positions.  Differentiable: the inputs are copied to the
    positions by the controlling thread (:func:`collectives.replicate`)
    and the positions run under :meth:`Mesh.run` with ``grad``.  With no
    mesh, :func:`forward`."""
    if mesh is None:
        return forward(params, x, n_experts=n_experts, top_k=top_k,
                       capacity_factor=capacity_factor)
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    model = ("model",) if "model" in mesh.shape else ()
    if not data_axes or mesh.axis_size(data_axes + model) != mesh.size:
        raise ValueError(f"forward_shard_map splits over ('pod', 'data') "
                         f"and 'model'; mesh {mesh.shape} has other axes")
    n_data = mesh.axis_size(data_axes)
    n_model = mesh.axis_size(model) if model else 1
    b, s, d = x.shape
    f = params["w_gate"].shape[-1]
    if b % n_data or f % n_model:
        raise ValueError(f"batch {b} over {n_data} data positions, ffn dim "
                         f"{f} over {n_model} model positions")
    bl, fl = b // n_data, f // n_model
    capacity = capacity_for(bl * s, top_k, capacity_factor, n_experts)

    def coord_of(r: int, j: int) -> tuple:
        return next(c for c in mesh.positions()
                    if mesh.rank(data_axes, c) == r
                    and (not model or mesh.rank(model, c) == j))

    grid = [[coord_of(r, j) for j in range(n_model)] for r in range(n_data)]
    dev = {c: mesh.devices[c] for row in grid for c in row}
    every = [c for row in grid for c in row]
    inputs: dict = {c: {} for c in every}
    for c, w in zip(every, collectives.replicate(
            params["router"]["w"], [dev[c] for c in every])):
        inputs[c]["router"] = w
    for r, row in enumerate(grid):
        block = x[r * bl:(r + 1) * bl].reshape(bl * s, d)
        for c, xl in zip(row, collectives.replicate(
                block, [dev[c] for c in row])):
            inputs[c]["x"] = xl
    for j in range(n_model):
        col = [grid[r][j] for r in range(n_data)]
        ffn = slice(j * fl, (j + 1) * fl)
        for name, w in (("w_gate", params["w_gate"][:, :, ffn]),
                        ("w_up", params["w_up"][:, :, ffn]),
                        ("w_down", params["w_down"][:, ffn, :])):
            for c, wc in zip(col, collectives.replicate(
                    w.to(x.dtype), [dev[c] for c in col])):
                inputs[c][name] = wc

    def body(coord):
        t = inputs[coord]
        for v in t.values():
            # made on the caller's stream, read on this one
            if v.is_cuda and not work.is_fake(v):
                v.record_stream(torch.cuda.current_stream(v.device))
        return _local_moe_body(t["x"], t["router"], t["w_gate"], t["w_up"],
                               t["w_down"], n_experts=n_experts,
                               top_k=top_k, capacity=capacity, where=coord)

    res = mesh.run(body, grad=True)
    home = x.device
    out = torch.cat([_add_in_order([res[c][0] for c in row], home)
                     for row in grid]).reshape(b, s, d)
    # every model position of a data row routes alike: keep column 0's
    n_t = torch.tensor(n_data, dtype=torch.float32, device=home)
    aux = _add_in_order([res[row[0]][1] for row in grid], home) / n_t
    dropped = _add_in_order([res[row[0]][2] for row in grid], home) / n_t
    return out, MoEStats(aux_loss=aux, dropped_frac=dropped)

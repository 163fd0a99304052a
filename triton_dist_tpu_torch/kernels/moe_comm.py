"""TP-MoE: routing, the grouped gate/up + SwiGLU, the grouped down
projection and the weighted combine, chunk by chunk around the ring.

Counterpart of ``triton_dist_tpu/kernels/moe_comm.py`` (``_chunk_gate_up``,
``ag_moe_gate_up_shard``, ``_chunk_down_combine``, ``moe_reduce_rs_shard``,
``tp_moe_rs_shard``, ``tp_moe_ar_shard``). Every expert's ff dimension is
split over the ranks, so every rank runs every token chunk's grouped GEMMs
on its ff slab and the down projection's fp32 partials reduce over the
ranks:

* the AG-MoE ring (``ag_moe_gate_up_shard``): the token chunks travel the
  ring (``runtime/mesh.py`` ``ring_ag_chunks``, where JAX uses
  ``lax.ppermute``); each chunk is routed with its own capacity
  (``capacity_for(Tc, ...)``), dispatched and run through the grouped
  gate/up SwiGLU (row 8);
* the MoE-RS ring (``moe_reduce_rs_shard``): a chunk's fp32 partial travels
  the ring (``mesh.ppermute``), each rank adding its down projection and
  combine of that chunk, until every rank holds its own chunk reduced.

Routing is per chunk, JAX's documented contract: under capacity pressure
the chunked paths drop other tokens than the unchunked ones. At world 1
there is one chunk, all T tokens, and no hop.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels.group_gemm import group_gemm, group_gemm_swiglu, matmul_f32
from triton_dist_tpu_torch.kernels.moe_utils import (
    RoutingPlan,
    capacity_for,
    combine,
    dispatch,
    make_routing_plan,
    topk_routing,
)
from triton_dist_tpu_torch.runtime import mesh


def _world(ctx) -> int:
    return 1 if ctx is None else ctx.world


def _chunk_gate_up(x_chunk: torch.Tensor, w_router: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor, *, top_k: int, capacity_factor: float, swiglu=group_gemm_swiglu):
    """Route one token chunk (Tc, d) and run the gate/up grouped GEMM with
    its SwiGLU (``swiglu(x (E, C, d), w_gate, w_up)``). Returns (plan,
    combine weights (Tc, K), h (E, C, ff))."""
    tc = x_chunk.shape[0]
    e = w_router.shape[1]
    idx, w = topk_routing(matmul_f32(x_chunk, w_router), top_k)
    plan = make_routing_plan(idx, e, capacity_for(tc, top_k, e, capacity_factor))
    return plan, w, swiglu(dispatch(x_chunk, plan), w_gate, w_up)


def _chunk_down_combine(state: tuple[RoutingPlan, torch.Tensor, torch.Tensor],
                        w_down: torch.Tensor) -> torch.Tensor:
    """Down-projection grouped GEMM + fp32 weighted combine of one chunk."""
    plan, w, h = state
    y = group_gemm(h, w_down)  # (E, C, d)
    return combine(y, plan, w, plan.slot.shape[0], out_dtype=torch.float32)


def tp_moe_partial(x, w_router, w_gate, w_up, w_down, *, top_k: int, capacity_factor: float,
                   swiglu=group_gemm_swiglu) -> torch.Tensor:
    """All of x (T, d) as one chunk: routed with one capacity, run through
    ``swiglu`` and the down GEMM, combined in fp32 (this rank's partial
    over its ff columns; ``TP_MoE``'s unchunked branch reduces and casts it)."""
    state = _chunk_gate_up(x, w_router, w_gate, w_up, top_k=top_k, capacity_factor=capacity_factor,
                           swiglu=swiglu)
    return _chunk_down_combine(state, w_down)


def ag_moe_gate_up_shard(ctx, x: torch.Tensor, w_router, w_gate, w_up, *, top_k: int,
                         capacity_factor: float) -> list:
    """The AG-MoE ring: ``states[s]`` = (plan, weights, h) of the chunk of
    rank ``(me - s) % world`` (step 0 is this rank's own, x (Tc, d))."""
    chunks = [x] if _world(ctx) == 1 else mesh.ring_ag_chunks(ctx, x)
    return [_chunk_gate_up(c, w_router, w_gate, w_up, top_k=top_k, capacity_factor=capacity_factor)
            for c in chunks]


def moe_reduce_rs_shard(ctx, states: list, w_down: torch.Tensor, *, out_dtype) -> torch.Tensor:
    """The MoE-RS ring over ``states`` as ``ag_moe_gate_up_shard`` gives
    them: the fp32 partial of chunk ``(me - 1 - t) % world`` travels one hop
    right at every step t and gains this rank's down projection of the chunk
    it reaches, so after world - 1 hops this rank holds its own chunk summed
    over the ranks; cast once."""
    world = _world(ctx)
    if world == 1:
        return _chunk_down_combine(states[0], w_down).to(out_dtype)
    acc = _chunk_down_combine(states[1], w_down)  # chunk me - 1
    for t in range(world - 1):
        acc = mesh.ppermute(ctx, acc, 1)
        acc = acc + _chunk_down_combine(states[(t + 2) % world], w_down)
    return acc.to(out_dtype)


def tp_moe_rs_shard(ctx, x: torch.Tensor, w_router, w_gate, w_up, w_down, *, top_k: int,
                    capacity_factor: float) -> torch.Tensor:
    """TP-MoE of the seq-sharded ("dist") regime: this rank's tokens x (Tc,
    d) → (Tc, d), the AG-MoE ring then the MoE-RS ring."""
    states = ag_moe_gate_up_shard(ctx, x, w_router, w_gate, w_up, top_k=top_k, capacity_factor=capacity_factor)
    return moe_reduce_rs_shard(ctx, states, w_down, out_dtype=x.dtype)


def tp_moe_ar_shard(ctx, x: torch.Tensor, w_router, w_gate, w_up, w_down, *, top_k: int,
                    capacity_factor: float) -> torch.Tensor:
    """TP-MoE of the replicated ("dist_ar") regime: x (T, d) on every rank →
    (T, d). Each rank slices the chunks the MoE-RS ring asks for from x
    (``states[s]`` = chunk ``(me - s) % world``, T/world tokens each), runs
    the ring, and an all-gather rebuilds the replicated output. Needs T %
    world == 0."""
    world = _world(ctx)
    t = x.shape[0]
    if t % world:
        raise ValueError(f"tp_moe_ar_shard splits {t} tokens over {world} ranks: not divisible")
    chunk = t // world
    me = 0 if ctx is None else ctx.rank
    states = []
    for s in range(world):
        c = (me - s) % world
        states.append(_chunk_gate_up(x[c * chunk:(c + 1) * chunk], w_router, w_gate, w_up, top_k=top_k,
                                     capacity_factor=capacity_factor))
    out = moe_reduce_rs_shard(ctx, states, w_down, out_dtype=x.dtype)
    return out if world == 1 else mesh.all_gather(ctx, out, 0)

"""TP-MoE: routing, the grouped gate/up + SwiGLU, the grouped down
projection and the weighted combine, at tensor-parallel world 1.

Counterpart of ``triton_dist_tpu/kernels/moe_comm.py`` (``_chunk_gate_up``,
``_chunk_down_combine``, ``tp_moe_rs_shard``, ``tp_moe_ar_shard``). In JAX
the token chunks travel a ring of ``world`` ranks. At world 1 the ring
collapses to one chunk, all T tokens: ``ring_ag_chunks`` yields ``x`` itself
(``allgather_gemm.py:254-266``), ``moe_reduce_rs_shard`` returns the one
chunk's down projection and combine before any ``ppermute``
(``moe_comm.py:124``), and the final all-gather of ``tp_moe_ar_shard`` is
the identity. So both functions are ``tp_moe_one_chunk``, which routes all
T tokens with ``capacity_for(T, k, E, factor)`` and combines in fp32;
``TP_MoE``'s unchunked branch calls it too. They take no world:
``TP_MoE`` refuses world > 1 before it calls them.
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


def _chunk_gate_up(x_chunk: torch.Tensor, w_router: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor, *, top_k: int, capacity_factor: float, swiglu):
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


def tp_moe_one_chunk(x, w_router, w_gate, w_up, w_down, *, top_k: int, capacity_factor: float,
                     swiglu=group_gemm_swiglu) -> torch.Tensor:
    """Every TP-MoE route at world 1: all of x (T, d) is the one chunk,
    routed, run through ``swiglu`` and the down GEMM, combined in fp32 and
    cast once."""
    state = _chunk_gate_up(x, w_router, w_gate, w_up, top_k=top_k,
                           capacity_factor=capacity_factor, swiglu=swiglu)
    return _chunk_down_combine(state, w_down).to(x.dtype)


def tp_moe_rs_shard(x: torch.Tensor, w_router, w_gate, w_up, w_down, *, top_k: int,
                    capacity_factor: float) -> torch.Tensor:
    """TP-MoE of the seq-sharded ("dist") regime: x (Tc, d) → (Tc, d). At
    world 1 the AG-MoE ring is the one local chunk and the MoE-RS ring ends
    before its first hop."""
    return tp_moe_one_chunk(x, w_router, w_gate, w_up, w_down, top_k=top_k,
                            capacity_factor=capacity_factor)


def tp_moe_ar_shard(x: torch.Tensor, w_router, w_gate, w_up, w_down, *, top_k: int,
                    capacity_factor: float) -> torch.Tensor:
    """TP-MoE of the replicated ("dist_ar") regime: x (T, d) → (T, d). At
    world 1 the one chunk is all of x and the final all-gather is the
    identity."""
    return tp_moe_one_chunk(x, w_router, w_gate, w_up, w_down, top_k=top_k,
                            capacity_factor=capacity_factor)

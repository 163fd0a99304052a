"""Trainable expert-parallel MoE: counterpart of
``triton_dist_tpu/function/ep_moe.py`` (``ep_moe_fused_fn``).

Every building block carries its own backward: the all-to-all is its own
transpose (``all_to_all_single_fn``, row 25 both ways with
``use_pallas_a2a``), the fused gate/up + SwiGLU recomputes its projections
(``group_gemm_swiglu_fn``, row 8 forward), and the router, dispatch,
down-projection and combine are tensor code that autograd differentiates,
as XLA differentiates them in JAX. The router's gradient flows through the
softmax / top-k combine weights.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.function.collectives import all_to_all_single_fn, group_gemm_swiglu_fn
from triton_dist_tpu_torch.kernels.moe_utils import (
    capacity_for,
    combine,
    dispatch as local_dispatch,
    make_routing_plan,
    regroup_by_expert,
    topk_routing,
    ungroup_to_peers,
)


def ep_moe_fused_fn(
    ctx,
    x: torch.Tensor,  # (T, d) this rank's tokens
    w_router: torch.Tensor,  # (d, E) replicated
    w_gate: torch.Tensor,  # (E_local, d, ff)
    w_up: torch.Tensor,  # (E_local, d, ff)
    w_down: torch.Tensor,  # (E_local, ff, d)
    *,
    num_experts: int,
    top_k: int,
    capacity_factor: float = 2.0,
    use_pallas_a2a: bool = False,
) -> torch.Tensor:
    """Differentiable EP MoE on ``ctx``'s ranks: dispatch all-to-all → fused
    gate/up + SwiGLU grouped GEMM → down grouped GEMM → return all-to-all →
    weighted combine; returns (T, d).

    Gradients (see ``function.collectives``): x and this rank's experts get
    the gradient of the sum of every rank's loss (the expert weights' rows
    reach them back through the all-to-all); ``w_router`` is replicated, so
    it gets this rank's tokens' contribution, and ``mesh.psum`` of the
    ranks' contributions is JAX's gradient."""
    world = 1 if ctx is None else ctx.world
    t, d = x.shape
    if num_experts % world:
        raise ValueError(f"{num_experts} experts do not split over {world} ranks")
    e_local = num_experts // world

    logits = torch.matmul(x.float(), w_router.float())
    idx, w = topk_routing(logits, top_k)
    cap = capacity_for(t, top_k, num_experts, capacity_factor)
    plan = make_routing_plan(idx, num_experts, cap)

    buf = local_dispatch(x, plan)  # (E, C, d) destination-major
    send = buf.reshape(world, e_local * cap, d)
    recv = all_to_all_single_fn(ctx, send, use_pallas_a2a)
    xe = regroup_by_expert(recv, world, e_local, cap)

    h = group_gemm_swiglu_fn(xe, w_gate, w_up)
    y = torch.bmm(h.float(), w_down.float()).to(x.dtype)  # (E_local, world·C, d)

    send_back = ungroup_to_peers(y, world, e_local, cap)
    recv_back = all_to_all_single_fn(ctx, send_back, use_pallas_a2a)
    return combine(recv_back.reshape(world * e_local, cap, d), plan, w, t)

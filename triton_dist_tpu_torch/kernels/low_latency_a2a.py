"""Low-latency EP all-to-all: fp8 wire, per-token scales, per-expert
panels. Counterpart of ``triton_dist_tpu/kernels/low_latency_a2a.py``
(``EPMoEMethod``, ``DEFAULT_EP_A2A_CROSSOVER_T``, ``ep_a2a_crossover_tokens``,
``get_auto_ep_moe_method``, ``quantize_fp8``, ``dequantize_fp8``,
``ll_dispatch_shard``, ``combine_leg_shard``, ``ll_combine_shard``,
``ep_moe_ll_shard``; ``combine_leg_shard`` lives in ``ep_a2a``, which its
plain combine shares). It has no kernel of its own: its legs are
``ep_a2a.all_to_all_single_shard`` (row 25 with ``use_pallas``).

Dispatch quantises each slot row to e4m3 with an fp32 scale (absmax / 448,
1 for a zero row), moves the payload as an int8 view and the scales as a
(world, chunk, 1) fp32 leg, and dequantises on arrival; at world 1 there is
no wire and no quantisation. Combine returns in the model dtype.

The crossover is JAX's default only: the tune cache behind
``agreed_cfg_value`` is not ported (ROADMAP queue 1 item B4), so every rank
routes on the same shape-only rule. The degraded-transport gate
(``resilience``) and the routing telemetry are not ported either (items A2
and A1).
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from triton_dist_tpu_torch.kernels.ep_a2a import all_to_all_single_shard, combine_leg_shard, world_of
from triton_dist_tpu_torch.kernels.group_gemm import group_gemm, group_gemm_swiglu, matmul_f32
from triton_dist_tpu_torch.kernels.moe_utils import (
    RoutingPlan,
    capacity_for,
    dispatch,
    make_routing_plan,
    regroup_by_expert,
    topk_routing,
)

FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


class EPMoEMethod(enum.Enum):
    """Which EP MoE data path a token batch takes."""

    AUTO = "auto"
    #: Dispatch → grouped expert MLP → combine: row 26 with the one-sided
    #: transport, else the same composition op by op (prefill).
    FUSED = "fused"
    #: The fp8-wire low-latency all-to-all, ``ep_moe_ll_shard`` (decode).
    LOW_LATENCY = "low_latency"
    #: The plain composition on the plain transport, no fp8 wire.
    XLA = "xla"


#: Tokens per rank at or below which AUTO takes the low-latency route.
DEFAULT_EP_A2A_CROSSOVER_T = 32


def ep_a2a_crossover_tokens(world: int) -> int:
    """The low_latency ↔ fused threshold (tokens per rank): JAX's default,
    the same on every rank."""
    return DEFAULT_EP_A2A_CROSSOVER_T


def get_auto_ep_moe_method(num_tokens: int, world: int) -> EPMoEMethod:
    """Decode-sized token batches take the fp8-wire low-latency route,
    prefill-sized ones the fused composition."""
    if num_tokens <= ep_a2a_crossover_tokens(world):
        return EPMoEMethod.LOW_LATENCY
    return EPMoEMethod.FUSED


def quantize_fp8(x: torch.Tensor):
    """Per-row absmax quantisation to e4m3: (q, scale (rows, 1) fp32) with
    ``x ≈ q.float() * scale``; a zero row gets scale 1. The bits equal
    JAX's: the scale is absmax / 448 in fp32, the payload x / scale rounded
    to nearest even."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / FP8_MAX, torch.ones_like(absmax))
    return (xf / scale).to(torch.float8_e4m3fn), scale


def dequantize_fp8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


@dataclasses.dataclass
class LLDispatchResult:
    """Low-latency dispatch output: per-expert panels and the combine state."""

    expert_inputs: torch.Tensor  # (E_local, world·C, d) dequantised, model dtype
    plan: RoutingPlan
    num_tokens: int


def ll_dispatch_shard(ctx, x: torch.Tensor, expert_idx: torch.Tensor, *, num_experts: int, capacity: int,
                      use_pallas: bool = True, wire_fp8: bool = True) -> LLDispatchResult:
    """fp8-wire dispatch: quantise → payload and scale all-to-alls →
    dequantised per-expert panels. No wire (and no quantisation) at world 1."""
    world = world_of(ctx)
    t, d = x.shape
    e_local = num_experts // world
    wire_fp8 = wire_fp8 and world > 1
    plan = make_routing_plan(expert_idx, num_experts, capacity)
    send = dispatch(x, plan).reshape(world, e_local * capacity, d)
    if wire_fp8:
        q, scale = quantize_fp8(send.reshape(-1, d))
        qv = q.view(torch.int8).reshape(world, e_local * capacity, d)
        recv_q = all_to_all_single_shard(ctx, qv, use_pallas=use_pallas).view(torch.float8_e4m3fn)
        recv_s = all_to_all_single_shard(ctx, scale.reshape(world, e_local * capacity, 1), use_pallas=use_pallas)
        recv = dequantize_fp8(recv_q.reshape(-1, d), recv_s.reshape(-1, 1), x.dtype)
        recv = recv.reshape(world, e_local * capacity, d)
    else:
        recv = all_to_all_single_shard(ctx, send, use_pallas=use_pallas)
    return LLDispatchResult(regroup_by_expert(recv, world, e_local, capacity), plan, t)


def ll_combine_shard(ctx, y: torch.Tensor, disp: LLDispatchResult, weights: torch.Tensor, *,
                     use_pallas: bool = True) -> torch.Tensor:
    """``combine_leg_shard`` bound to a dispatch result."""
    return combine_leg_shard(ctx, y, disp.plan, disp.num_tokens, weights, use_pallas=use_pallas)


def ep_moe_ll_shard(ctx, x: torch.Tensor, w_router, w_gate, w_up, w_down, *, num_experts: int, top_k: int,
                    capacity_factor: float = 2.0, use_pallas: bool = True, wire_fp8: bool = True) -> torch.Tensor:
    """The low-latency EP MoE: router → top-k → fp8 dispatch → grouped gate/up
    SwiGLU (row 8) → grouped down → combine. x (T, d) → (T, d)."""
    t = x.shape[0]
    idx, w = topk_routing(matmul_f32(x, w_router), top_k)
    cap = capacity_for(t, top_k, num_experts, capacity_factor)
    disp = ll_dispatch_shard(ctx, x, idx, num_experts=num_experts, capacity=cap, use_pallas=use_pallas,
                             wire_fp8=wire_fp8)
    h = group_gemm_swiglu(disp.expert_inputs.contiguous(), w_gate, w_up)
    y = group_gemm(h, w_down)
    return ll_combine_shard(ctx, y, disp, w, use_pallas=use_pallas)

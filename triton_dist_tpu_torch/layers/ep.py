"""Expert-parallel MoE layer: counterpart of ``triton_dist_tpu/layers/ep.py``
(``EP_MoE``).

Rank r owns experts ``[r·E_local, (r+1)·E_local)``; tokens go to their
experts' owners by an all-to-all and come back by another. Three branches,
with JAX's flag names:

* ``fused_kernel``: ``ep_moe_fused_kernel_shard`` (row 26: dispatch, expert
  MLP and return in one kernel call; with ``low_latency`` too, its fp8
  wire, row 26b);
* ``low_latency``: ``ep_moe_ll_shard``, the fp8-wire dispatch (row 25 with
  ``use_pallas_a2a``), the grouped gate/up SwiGLU (row 8) and down GEMM, the
  return leg;
* neither: the plain composition ``ep_dispatch_shard`` → grouped GEMMs →
  ``ep_combine_shard``.
"""

from __future__ import annotations

import torch
from torch import nn

from triton_dist_tpu_torch.kernels.ep_a2a import ep_combine_shard, ep_dispatch_shard
from triton_dist_tpu_torch.kernels.ep_fused import ep_moe_fused_kernel_shard
from triton_dist_tpu_torch.kernels.group_gemm import group_gemm, group_gemm_swiglu, matmul_f32
from triton_dist_tpu_torch.kernels.low_latency_a2a import ep_moe_ll_shard
from triton_dist_tpu_torch.kernels.moe_utils import capacity_for, topk_routing


class EP_MoE(nn.Module):
    """MoE with whole experts per rank. ``w_router`` (d, E) replicated;
    ``w_gate`` and ``w_up`` (E_local, d, ff), ``w_down`` (E_local, ff, d),
    this rank's slabs. ``ctx``: the ranks (None at world 1)."""

    def __init__(self, w_router, w_gate, w_up, w_down, *, num_experts: int = 8, top_k: int = 2,
                 capacity_factor: float = 2.0, ctx=None, use_pallas_a2a: bool = False,
                 low_latency: bool = False, fused_kernel: bool = False):
        super().__init__()
        self.register_buffer("w_router", w_router, persistent=False)
        self.register_buffer("w_gate", w_gate, persistent=False)
        self.register_buffer("w_up", w_up, persistent=False)
        self.register_buffer("w_down", w_down, persistent=False)
        self.num_experts, self.top_k, self.capacity_factor = num_experts, top_k, capacity_factor
        self.ctx = ctx
        self.use_pallas_a2a, self.low_latency, self.fused_kernel = use_pallas_a2a, low_latency, fused_kernel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (T, d), this rank's tokens → (T, d)."""
        weights = (self.w_router, self.w_gate, self.w_up, self.w_down)
        kw = dict(num_experts=self.num_experts, top_k=self.top_k, capacity_factor=self.capacity_factor)
        if self.fused_kernel:
            return ep_moe_fused_kernel_shard(self.ctx, x, *weights, **kw, wire_fp8=self.low_latency,
                                             fallback_wire_fp8=self.low_latency,
                                             use_pallas_a2a=self.use_pallas_a2a)
        if self.low_latency:
            return ep_moe_ll_shard(self.ctx, x, *weights, **kw, use_pallas=self.use_pallas_a2a, wire_fp8=True)
        t = x.shape[0]
        idx, w = topk_routing(matmul_f32(x, self.w_router), self.top_k)
        cap = capacity_for(t, self.top_k, self.num_experts, self.capacity_factor)
        disp = ep_dispatch_shard(self.ctx, x, idx, num_experts=self.num_experts, capacity=cap,
                                 use_pallas=self.use_pallas_a2a)
        h = group_gemm_swiglu(disp.expert_inputs.contiguous(), self.w_gate, self.w_up)
        y = group_gemm(h, self.w_down)
        return ep_combine_shard(self.ctx, y, disp, w, use_pallas=self.use_pallas_a2a)

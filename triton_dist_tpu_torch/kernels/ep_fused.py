"""Fused EP dispatch → grouped expert MLP → combine. Counterpart of
``triton_dist_tpu/kernels/ep_fused.py`` (``fused_moe_supported``,
``fused_dispatch_mlp_shard``, ``fused_dispatch_mlp_combine_shard``,
``ep_moe_fused_kernel_shard``).

``fused_dispatch_mlp_combine_shard`` is row 26 in the form ``EPMoELLM``
reaches (``combine=True``, ``wire_fp8=False``): on CUDA tensors the
hand-written kernel of ``csrc/ep_fused.cu`` (its header says what bounds it
on the H100 and how its design answers that), on CPU tensors its plain
version ``fused_ep_reference``: the plain dispatch all-to-all, the grouped
gate/up SwiGLU (``group_swiglu_reference``) and the down ``bmm`` in fp32,
the plain return all-to-all. The kernel's other variants, the fp8 dispatch
wire and ``combine=False`` (``fused_dispatch_mlp_shard``), are row 26b: their
plain versions run on CPU tensors, and on CUDA tensors they raise.

``fused_moe_supported`` is JAX's route rule, kept so that the port takes
the routes JAX takes: it checks the TPU kernel's VMEM plan. It says
nothing of the H100 kernel, whose limits are the heap's workspace (a call
goes in groups of experts that fit) and its 1024 signal slots.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.ep_a2a import SHMEM_ARGTYPES, world_of
from triton_dist_tpu_torch.kernels.group_gemm import (
    bmm_f32,
    group_gemm,
    group_gemm_swiglu,
    group_swiglu_reference,
    matmul_f32,
)
from triton_dist_tpu_torch.kernels.low_latency_a2a import (
    combine_leg_shard,
    dequantize_fp8,
    ep_moe_ll_shard,
    quantize_fp8,
)
from triton_dist_tpu_torch.kernels.moe_utils import (
    capacity_for,
    combine,
    dispatch,
    make_routing_plan,
    regroup_by_expert,
    topk_routing,
    ungroup_to_peers,
)
from triton_dist_tpu_torch.runtime import mesh
from triton_dist_tpu_torch.shmem.symm import MAX_SLOTS, WS_BYTES

_U64, _SZ, _P, _I = ctypes.c_uint64, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "tdt_ep_fused": SHMEM_ARGTYPES + [_P] * 6 + [_SZ] + [_I] * 6 + [_U64, _U64, _P],
}
TILE = 64
NEEDS_26B = ("row 26b: the fused EP kernel's fp8 dispatch wire and its combine=False form are not ported "
             "to CUDA (ROADMAP queue 2, row 26b)")


def fit_block(n: int, want: int) -> int:
    """Largest divisor of ``n`` that is ≤ ``want``, a multiple of 128 where
    one exists (a copy of JAX ``kernels/gemm.py:fit_block``)."""
    b = min(want, n)
    for c in range(b, 0, -1):
        if n % c == 0 and c % 128 == 0:
            return c
    return max(c for c in range(b, 0, -1) if n % c == 0)


def fused_moe_supported(world: int, cap: int, d: int, ff: int, itemsize: int, block_f: int = 512,
                        vmem_limit_mb: int = 100, combine: bool = True, wire_fp8: bool = False) -> bool:
    """JAX's route rule: whether the TPU kernel's VMEM plan (token panel,
    fp32 accumulator, staging, double-buffered weight tiles) fits
    ``vmem_limit_mb``. Where it does not, ``ep_moe_fused_kernel_shard``
    takes the low-latency composition, as JAX does."""
    bf = fit_block(ff, block_f)
    xs_item = 1 if wire_fp8 else itemsize
    panel = world * cap * d * (xs_item + 4 + (itemsize if combine else 0))
    if wire_fp8:
        panel += world * cap * 128 * 4
    tiles = 2 * (2 * d * bf + bf * d) * itemsize
    out_blocks = 0 if combine else 2 * world * cap * d * itemsize
    return panel + tiles + out_blocks <= vmem_limit_mb * 1024 * 1024


def _expert_mlp(xs: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """(E, rows, d) panels through gate/up SwiGLU and down, fp32 products,
    h and y rounded to the model dtype."""
    return bmm_f32(group_swiglu_reference(xs, w_gate, w_up), w_down).to(xs.dtype)


def _dispatch_mlp(ctx, send: torch.Tensor, w_gate, w_up, w_down, capacity: int, wire_fp8: bool) -> torch.Tensor:
    """Plain dispatch (with the fp8 wire: quantised payload and scales,
    dequantised on arrival) and the expert MLP: (E_local, world·C, d)."""
    world, chunk, d = send.shape
    e_local = chunk // capacity
    if wire_fp8:
        q, scale = quantize_fp8(send.reshape(-1, d))
        recv_q = mesh.all_to_all(ctx, q.view(torch.int8).reshape(world, chunk, d)).view(torch.float8_e4m3fn)
        recv_s = mesh.all_to_all(ctx, scale.reshape(world, chunk, 1))
        recv = dequantize_fp8(recv_q.reshape(-1, d), recv_s.reshape(-1, 1), send.dtype).reshape(world, chunk, d)
    else:
        recv = mesh.all_to_all(ctx, send)
    return _expert_mlp(regroup_by_expert(recv, world, e_local, capacity), w_gate, w_up, w_down)


def fused_ep_reference(ctx, send: torch.Tensor, w_gate, w_up, w_down, *, capacity: int,
                       wire_fp8: bool = False) -> torch.Tensor:
    """Plain version of row 26: dispatch all-to-all, expert MLP, return
    all-to-all. send (world, E_local·C, d) → comb (world, E_local·C, d)."""
    world, chunk, d = send.shape
    y = _dispatch_mlp(ctx, send, w_gate, w_up, w_down, capacity, wire_fp8)
    return mesh.all_to_all(ctx, ungroup_to_peers(y, world, chunk // capacity, capacity).contiguous())


def _library():
    return _build.load("ep_fused", _SIGNATURES)


def fused_ep_kernel(ctx, send: torch.Tensor, w_gate, w_up, w_down, *, capacity: int) -> torch.Tensor:
    """Row 26: send (world, E_local·C, d), w_gate and w_up (E_local, d, ff),
    w_down (E_local, ff, d) → comb (world, E_local·C, d), ``comb[p]`` rank
    p's experts' outputs for this rank's slots. CUDA tensors (fp32 or bf16,
    contiguous, d and ff multiples of 8) launch the kernel, in groups of
    experts whose two landing buffers fit the heap's workspace, one kernel
    call each; CPU tensors run ``fused_ep_reference``."""
    if send.device.type == "cpu":
        return fused_ep_reference(ctx, send, w_gate, w_up, w_down, capacity=capacity)
    w, dev = ctx.world, ctx.device
    tensors = (send, w_gate, w_up, w_down)
    if any(t.device != dev for t in tensors) or any(t.dtype != send.dtype for t in tensors):
        raise ValueError(f"fused_ep_kernel needs every operand on {dev} in one dtype")
    if send.dtype not in (torch.float32, torch.bfloat16) or not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"fused_ep_kernel takes contiguous fp32 or bf16 operands, got {send.dtype}")
    if send.dim() != 3 or send.shape[0] != w or send.shape[1] % capacity:
        raise ValueError(f"fused_ep_kernel: send {tuple(send.shape)} is not ({w}, E_local·{capacity}, d)")
    e_local, d = send.shape[1] // capacity, send.shape[2]
    ff = w_gate.shape[-1]
    if (w_gate.shape != (e_local, d, ff) or w_up.shape != w_gate.shape
            or w_down.shape != (e_local, ff, d)):
        raise ValueError(f"fused_ep_kernel: weights {tuple(w_gate.shape)}, {tuple(w_up.shape)}, "
                         f"{tuple(w_down.shape)} do not fit send {tuple(send.shape)}")
    if d % 8 or ff % 8:
        raise ValueError(f"fused_ep_kernel needs d and ff multiples of 8, got d={d}, ff={ff}")
    isz = send.element_size()
    ct = -(-capacity // TILE)
    group = min(e_local, WS_BYTES // (2 * w * capacity * d * isz), MAX_SLOTS // ct)
    if group < 1:
        raise ValueError(f"fused_ep_kernel: one expert at capacity {capacity} (d={d}) does not fit the "
                         f"workspace ({WS_BYTES} bytes) or the {MAX_SLOTS} signal slots")
    nt = -(-d // TILE)
    comb = torch.empty_like(send)
    heap, lib = ctx.heap, _library()
    for e0 in range(0, e_local, group):
        g = min(group, e_local - e0)
        groups = max(1, min(nt, MAX_SLOTS // (g * ct)))
        h = torch.empty((g, w * capacity, ff), dtype=send.dtype, device=dev)
        epoch = heap.next_epoch()
        off = e0 * capacity * d * isz
        code = lib.tdt_ep_fused(*heap.args(epoch), _P(send.data_ptr() + off), _build.ptr(w_gate[e0]),
                                _build.ptr(w_up[e0]), _build.ptr(w_down[e0]), _build.ptr(h),
                                _P(comb.data_ptr() + off), e_local * capacity * d, g, capacity, d, ff, groups,
                                1 if send.dtype == torch.bfloat16 else 0, _U64(heap.ws_off[epoch % 2]),
                                _U64(heap.flags_off[epoch % 2]), _build.stream_ptr(dev))
        _build.check(lib, code, "fused_ep_kernel")
    fused_ep_kernel.launches += 1
    return comb


#: Kernel launches so far (CUDA calls only).
fused_ep_kernel.launches = 0


def fused_dispatch_mlp_shard(ctx, send: torch.Tensor, w_gate, w_up, w_down, *, capacity: int,
                             wire_fp8: bool = False) -> torch.Tensor:
    """Dispatch + grouped MLP without the combine leg (row 26b): the
    per-expert output panels (E_local, world·C, d). World 1: the grouped
    GEMMs on the one rank's slots. CPU tensors run the plain version; CUDA
    tensors at world > 1 raise."""
    world, chunk, d = send.shape
    e_local = chunk // capacity
    if world_of(ctx) == 1:
        xs = send.reshape(e_local, capacity, d)
        return group_gemm(group_gemm_swiglu(xs, w_gate, w_up), w_down)
    if send.device.type != "cpu":
        raise NotImplementedError(NEEDS_26B)
    return _dispatch_mlp(ctx, send, w_gate, w_up, w_down, capacity, wire_fp8)


def fused_dispatch_mlp_combine_shard(ctx, send: torch.Tensor, w_gate, w_up, w_down, *, capacity: int,
                                     wire_fp8: bool = False) -> torch.Tensor:
    """Dispatch + grouped MLP + return all-to-all: the combine landing buffer
    (world, E_local·C, d), from peer p p's experts' outputs for this rank's
    slots, global-expert-major, ready for ``moe_utils.combine``. World 1: the
    grouped GEMMs, (1, E·C, d). ``wire_fp8`` on CUDA is row 26b and raises."""
    world, chunk, d = send.shape
    e_local = chunk // capacity
    if world_of(ctx) == 1:
        xs = send.reshape(e_local, capacity, d)
        return group_gemm(group_gemm_swiglu(xs, w_gate, w_up), w_down).reshape(1, chunk, d)
    if wire_fp8:
        if send.device.type != "cpu":
            raise NotImplementedError(NEEDS_26B)
        return fused_ep_reference(ctx, send, w_gate, w_up, w_down, capacity=capacity, wire_fp8=True)
    return fused_ep_kernel(ctx, send, w_gate, w_up, w_down, capacity=capacity)


def ep_moe_fused_kernel_shard(ctx, x: torch.Tensor, w_router, w_gate, w_up, w_down, *, num_experts: int,
                              top_k: int, capacity_factor: float = 2.0, block_f: int = 512,
                              fallback_wire_fp8: bool = False, use_pallas_a2a: bool = False,
                              combine_in_kernel: bool = True, wire_fp8: bool = False) -> torch.Tensor:
    """The fused EP MoE: route → row 26 (dispatch, expert MLP, return) → the
    local weighted unpermute. Where JAX's VMEM plan does not fit
    (``fused_moe_supported``) it takes ``ep_moe_ll_shard`` with
    ``fallback_wire_fp8`` and ``use_pallas_a2a``, as JAX does.
    ``combine_in_kernel=False`` is the two-step form: row 26b, then the
    return leg. x (T, d) → (T, d)."""
    world = world_of(ctx)
    t, d = x.shape
    e_local = num_experts // world
    ff = w_gate.shape[-1]
    cap = capacity_for(t, top_k, num_experts, capacity_factor)
    if not fused_moe_supported(world, cap, d, ff, x.element_size(), block_f, combine=combine_in_kernel,
                               wire_fp8=wire_fp8):
        return ep_moe_ll_shard(ctx, x, w_router, w_gate, w_up, w_down, num_experts=num_experts, top_k=top_k,
                               capacity_factor=capacity_factor, use_pallas=use_pallas_a2a,
                               wire_fp8=fallback_wire_fp8)
    idx, w = topk_routing(matmul_f32(x, w_router), top_k)
    plan = make_routing_plan(idx, num_experts, cap)
    send = dispatch(x, plan).reshape(world, e_local * cap, d)
    if combine_in_kernel:
        comb = fused_dispatch_mlp_combine_shard(ctx, send, w_gate, w_up, w_down, capacity=cap, wire_fp8=wire_fp8)
        return combine(comb.reshape(world * e_local, cap, d), plan, w, t)
    y = fused_dispatch_mlp_shard(ctx, send, w_gate, w_up, w_down, capacity=cap, wire_fp8=wire_fp8)
    return combine_leg_shard(ctx, y, plan, t, w, use_pallas=use_pallas_a2a)


def fused_ep_cost(world: int, e_local: int, capacity: int, d: int, ff: int, itemsize: int,
                  live_rows: int | None = None, live_experts: int | None = None) -> tuple[int, int, int]:
    """(FLOPs, HBM bytes, NVLink bytes) of one rank's row-26 call: the three
    products over the rows that hold a token (``live_rows``; all world·C
    rows of every local expert when not given: an empty slot is a zero row,
    whose output is zero), the weights of the experts that got a row
    (``live_experts``), send and comb read or written once; both legs'
    world - 1 remote chunks cross NVLink once."""
    rows = world * e_local * capacity if live_rows is None else live_rows
    experts = e_local if live_experts is None else live_experts
    chunk = world * e_local * capacity * d * itemsize
    flops = 2 * rows * d * ff * 3
    hbm = 3 * experts * d * ff * itemsize + 2 * chunk
    return flops, hbm, 2 * chunk * (world - 1) // world

"""Expert-parallel all-to-all: dispatch and combine over the ranks.
Counterpart of ``triton_dist_tpu/kernels/ep_a2a.py``
(``all_to_all_single_shard``, ``EPDispatchResult``, ``ep_dispatch_shard``,
``ep_combine_shard``, ``AllToAllContext``, ``create_all_to_all_context``,
``fast_all_to_all``; ``all_to_all_2d_shard`` is not ported, ROADMAP queue 1
item C).

Every rank owns ``E_local = E / world`` whole experts. The send buffer is
the routing plan's (E, C, d) slot grid viewed as (world, E_local·C, d),
destination-major, so one all-to-all is the dispatch; after it a rank holds
(world, E_local·C, d) source-major and regroups it into one (world·C, d)
panel per local expert. Combine is the reverse all-to-all and the weighted
gather (``moe_utils.combine``).

``all_to_all_single_shard`` has two transports, as in JAX: the plain one
(``runtime.mesh.all_to_all``, JAX's ``lax.all_to_all``) and, with
``use_pallas``, row 25 ``all_to_all_kernel``: on CUDA tensors the
hand-written kernel of ``csrc/ep_a2a.cu`` (its header says what bounds it
and how its design answers that), on CPU tensors its plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.moe_utils import (
    RoutingPlan,
    combine,
    dispatch,
    make_routing_plan,
    regroup_by_expert,
    ungroup_to_peers,
)
from triton_dist_tpu_torch.runtime import mesh
from triton_dist_tpu_torch.shmem.symm import MAX_SLOTS, WS_BYTES

_U64, _SZ, _P = ctypes.c_uint64, ctypes.c_size_t, ctypes.c_void_p
#: The leading C arguments of a collective entry point (``SymmHeap.args``).
SHMEM_ARGTYPES = [_P, _P, ctypes.c_int, ctypes.c_int, _U64, _U64]
_SIGNATURES = {
    "tdt_all_to_all": SHMEM_ARGTYPES + [_P, _SZ, _P, _SZ, _SZ, _SZ, _U64, _SZ, _U64, _P],
}
#: Bytes one block of the kernel moves: a peer's chunk goes in pieces of this.
PIECE_BYTES = 32 << 10


def _library():
    return _build.load("ep_a2a", _SIGNATURES)


def all_to_all_kernel(ctx, x: torch.Tensor) -> torch.Tensor:
    """Row 25: x (world, chunk, ...) with ``x[p]`` bound for rank p → out with
    ``out[p]`` = rank p's ``x[me]``, bit for bit. CUDA tensors launch the
    kernel (any dtype, a chunk of whole 4-byte words); a call whose landing
    buffer exceeds the heap's workspace goes in pieces along the chunk
    dimension, one kernel call each. CPU tensors run ``mesh.all_to_all``."""
    if x.device.type == "cpu":
        return mesh.all_to_all(ctx, x)
    w = ctx.world
    if x.device != ctx.device or x.dim() < 2 or x.shape[0] != w:
        raise ValueError(f"all_to_all_kernel needs ({w}, chunk, ...) on {ctx.device}, got {tuple(x.shape)} "
                         f"on {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("all_to_all_kernel needs a contiguous, 16-byte aligned tensor")
    chunk = x.shape[1]
    row = x[0, 0].numel() * x.element_size()
    if row % 4:
        raise ValueError(f"all_to_all_kernel moves whole 4-byte words: a row of {row} bytes")
    out = torch.empty_like(x)
    if chunk == 0 or row == 0:
        return out
    heap, lib = ctx.heap, _library()
    stride = chunk * row
    rows_per_call = (WS_BYTES - 16 * w) // (w * row)  # landing slots round up to 16 bytes
    if rows_per_call < 1:
        raise ValueError(f"all_to_all_kernel: a row of {row} bytes to each of {w} ranks exceeds the "
                         f"workspace ({WS_BYTES} bytes)")
    for c0 in range(0, chunk, rows_per_call):
        nbytes = (min(chunk, c0 + rows_per_call) - c0) * row
        piece = max(PIECE_BYTES, -(-nbytes // (MAX_SLOTS * 16)) * 16)
        epoch = heap.next_epoch()
        code = lib.tdt_all_to_all(*heap.args(epoch), _P(x.data_ptr() + c0 * row), stride,
                                  _P(out.data_ptr() + c0 * row), stride, nbytes, piece,
                                  _U64(heap.ws_off[epoch % 2]), -(-nbytes // 16) * 16,
                                  _U64(heap.flags_off[epoch % 2]), _build.stream_ptr(x.device))
        _build.check(lib, code, "all_to_all_kernel")
    all_to_all_kernel.launches += 1
    return out


#: Kernel launches so far (CUDA calls only).
all_to_all_kernel.launches = 0


def all_to_all_single_shard(ctx, x: torch.Tensor, *, use_pallas: bool = True) -> torch.Tensor:
    """Exchange per-peer chunks: ``out[p]`` = rank p's chunk for me. At world
    1 (or without a context) the identity; ``use_pallas`` takes row 25, else
    the plain transport."""
    if ctx is None or ctx.world == 1:
        return x
    if use_pallas:
        return all_to_all_kernel(ctx, x)
    return mesh.all_to_all(ctx, x)


@dataclasses.dataclass(frozen=True)
class EPDispatchResult:
    """Dispatch output and what combine needs of it."""

    expert_inputs: torch.Tensor  # (E_local, world·C, d) token slots per local expert
    plan: RoutingPlan  # this rank's send-side routing plan
    num_tokens: int


def world_of(ctx) -> int:
    """The world of ``ctx``; 1 without a context."""
    return 1 if ctx is None else ctx.world


def ep_dispatch_shard(ctx, x: torch.Tensor, expert_idx: torch.Tensor, *, num_experts: int, capacity: int,
                      use_pallas: bool = True) -> EPDispatchResult:
    """Route this rank's tokens x (T, d) with ``expert_idx`` (T, K) to the
    experts' owners: the plan, the slot grid, one all-to-all, the regroup."""
    world = world_of(ctx)
    t, d = x.shape
    if num_experts % world:
        raise ValueError(f"{num_experts} experts do not split over {world} ranks")
    e_local = num_experts // world
    plan = make_routing_plan(expert_idx, num_experts, capacity)
    send = dispatch(x, plan).reshape(world, e_local * capacity, d)
    recv = all_to_all_single_shard(ctx, send, use_pallas=use_pallas)
    return EPDispatchResult(regroup_by_expert(recv, world, e_local, capacity), plan, t)


def combine_leg_shard(ctx, y: torch.Tensor, plan: RoutingPlan, num_tokens: int, weights: torch.Tensor, *,
                      use_pallas: bool = True) -> torch.Tensor:
    """Expert outputs y (E_local, world·C, d) back to their tokens' owners in
    y's dtype, then the top-k weighted sum (fp32, cast to y's dtype), from an
    explicit routing plan (JAX keeps it in ``low_latency_a2a``; the fused
    kernel's ``combine=False`` form uses it directly)."""
    world = world_of(ctx)
    e_local, wc, d = y.shape
    capacity = wc // world
    send = ungroup_to_peers(y, world, e_local, capacity).contiguous()
    recv = all_to_all_single_shard(ctx, send, use_pallas=use_pallas)
    return combine(recv.reshape(world * e_local, capacity, d), plan, weights, num_tokens)


def ep_combine_shard(ctx, y: torch.Tensor, disp: EPDispatchResult, weights: torch.Tensor, *,
                     use_pallas: bool = True) -> torch.Tensor:
    """``combine_leg_shard`` bound to a dispatch result."""
    return combine_leg_shard(ctx, y, disp.plan, disp.num_tokens, weights, use_pallas=use_pallas)


@dataclasses.dataclass(frozen=True)
class AllToAllContext:
    """What a dispatch needs besides the tokens (JAX ``AllToAllContext``)."""

    ctx: object
    num_experts: int
    capacity: int
    use_pallas: bool = True


def create_all_to_all_context(ctx, num_experts: int, capacity: int, use_pallas: bool = True) -> AllToAllContext:
    return AllToAllContext(ctx=ctx, num_experts=num_experts, capacity=capacity, use_pallas=use_pallas)


def fast_all_to_all(a2a_ctx: AllToAllContext, x: torch.Tensor, expert_idx: torch.Tensor) -> EPDispatchResult:
    """``ep_dispatch_shard`` bound to a context."""
    return ep_dispatch_shard(a2a_ctx.ctx, x, expert_idx, num_experts=a2a_ctx.num_experts,
                             capacity=a2a_ctx.capacity, use_pallas=a2a_ctx.use_pallas)


def a2a_cost(x: torch.Tensor, world: int) -> tuple[int, int, int]:
    """(FLOPs, HBM bytes, NVLink bytes) of one rank's call: x read once and
    out written once; the world - 1 chunks bound for other ranks cross
    NVLink once."""
    nbytes = x.numel() * x.element_size()
    return 0, 2 * nbytes, nbytes * (world - 1) // world

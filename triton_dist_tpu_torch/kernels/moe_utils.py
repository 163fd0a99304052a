"""MoE token routing with a static per-expert capacity.

Counterpart of ``triton_dist_tpu/kernels/moe_utils.py`` (``CAPACITY_ALIGN``,
``capacity_for``, ``RoutingPlan``, ``make_routing_plan``, ``dispatch``,
``combine``, ``topk_routing``, and the expert-parallel layouts
``regroup_by_expert`` and ``ungroup_to_peers``). Top-k routing becomes a stable
sort over expert ids plus a position in each expert's run; each expert has
``capacity`` slots and assignments past it are dropped, first come first
served in token order. Every step is tensor code on the tokens' device, with
no host synchronisation.
"""

from __future__ import annotations

import dataclasses

import torch

#: Per-expert capacity is padded up to a multiple of this.
CAPACITY_ALIGN = 8


@dataclasses.dataclass(frozen=True)
class RoutingPlan:
    """Routing of T tokens × K experts into (E, C) slots.

    ``slot[t, k]``: flat slot ``e·C + pos`` of assignment (t, k), 0 where it
    was dropped; ``keep[t, k]``: False for a capacity-overflow assignment;
    ``token_of_slot[E·C]``: the token feeding each slot, or T for an empty
    slot (``dispatch`` pads the tokens with one zero row)."""

    slot: torch.Tensor  # (T, K) int32
    keep: torch.Tensor  # (T, K) bool
    token_of_slot: torch.Tensor  # (E·C,) int32 in [0, T]
    num_experts: int
    capacity: int


def capacity_for(tokens: int, topk: int, num_experts: int, factor: float = 1.25,
                 align: int = CAPACITY_ALIGN) -> int:
    """Per-expert slot count: ``int(T·K/E·factor) + 1``, aligned up."""
    c = int(tokens * topk / num_experts * factor) + 1
    return max(align, (c + align - 1) // align * align)


def regroup_by_expert(recv: torch.Tensor, world: int, e_local: int, capacity: int) -> torch.Tensor:
    """(world, e_local·C, d) source-major all-to-all output → (e_local,
    world·C, d) per-expert panels: each local expert sees every source
    rank's capacity block, in rank order."""
    d = recv.shape[-1]
    return (recv.reshape(world, e_local, capacity, d).transpose(0, 1)
            .reshape(e_local, world * capacity, d))


def ungroup_to_peers(y: torch.Tensor, world: int, e_local: int, capacity: int) -> torch.Tensor:
    """Inverse of ``regroup_by_expert``: (e_local, world·C, d) → (world,
    e_local·C, d), the peer-major layout of the return all-to-all."""
    d = y.shape[-1]
    return (y.reshape(e_local, world, capacity, d).transpose(0, 1)
            .reshape(world, e_local * capacity, d))


def make_routing_plan(expert_idx: torch.Tensor, num_experts: int, capacity: int) -> RoutingPlan:
    """The routing plan of ``expert_idx`` (T, K): a stable sort by expert
    makes each expert's run FIFO in token order; the position in the run is
    the sorted index minus the run's start; positions ≥ ``capacity`` drop."""
    t, k = expert_idx.shape
    dev = expert_idx.device
    flat_e = expert_idx.reshape(-1).long()
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    run_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_sorted = torch.arange(t * k, device=dev) - run_start
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < capacity
    slot = torch.where(keep, flat_e * capacity + pos, torch.zeros_like(pos))

    # Inverse map. Kept slots are distinct; every dropped assignment writes
    # to one spare entry past the end, which is cut off.
    n_slots = num_experts * capacity
    token_ids = torch.arange(t * k, device=dev) // k
    token_of_slot = torch.full((n_slots + 1,), t, dtype=torch.long, device=dev)
    token_of_slot.scatter_(0, torch.where(keep, slot, torch.full_like(slot, n_slots)), token_ids)
    return RoutingPlan(
        slot=slot.reshape(t, k).to(torch.int32),
        keep=keep.reshape(t, k),
        token_of_slot=token_of_slot[:n_slots].to(torch.int32),
        num_experts=num_experts,
        capacity=capacity,
    )


def dispatch(x: torch.Tensor, plan: RoutingPlan) -> torch.Tensor:
    """Gather tokens (T, d) into expert buffers (E, C, d); empty slots are
    zero rows."""
    d = x.shape[1]
    x_pad = torch.cat([x, x.new_zeros(1, d)], dim=0)
    return x_pad[plan.token_of_slot.long()].reshape(plan.num_experts, plan.capacity, d)


def combine(y: torch.Tensor, plan: RoutingPlan, weights: torch.Tensor, num_tokens: int,
            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Weighted gather back to token order, summed in fp32 over k:
    ``out[t] = Σ_k w[t, k]·y[slot[t, k]]``.

    A dropped assignment is masked by selection, not by a zero weight: its
    slot aliases slot 0, and 0 × a non-finite value is NaN."""
    d = y.shape[-1]
    gathered = y.reshape(-1, d)[plan.slot.reshape(-1).long()]  # (T·K, d)
    keep = plan.keep.reshape(-1, 1)
    gathered = torch.where(keep, gathered.float(), 0.0)
    w = torch.where(keep, weights.reshape(-1, 1).float(), 0.0)
    out = (gathered * w).reshape(num_tokens, -1, d).sum(dim=1)
    return out.to(out_dtype or y.dtype)


def topk_routing(logits: torch.Tensor, k: int):
    """Top-k gating of router logits (T, E): softmax in fp32, the k largest,
    renormalised by ``max(sum, 1e-20)``. Returns (expert_idx (T, K) int32,
    weights (T, K) in the logits' dtype).

    Equal probabilities go to the lower expert id, as ``jax.lax.top_k``
    does; ``torch.topk`` promises no order among equal values on CUDA, so
    this takes the first k of a stable descending sort."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :k], idx[:, :k]
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-20)
    return idx.to(torch.int32), w.to(logits.dtype)

"""Fused per-block decode kernels of the mega backend.

Counterpart of ``triton_dist_tpu/megakernel/kernels.py``, under the same
names. The kernels' wrappers, plain versions and CUDA sources sit with the
port's other kernels (``kernels/mega_decode.py``, ``kernels/mega_moe.py``,
``kernels/flash_decode.py``, ``csrc/``) and are exported here.
``fused_paged_attn_back`` is defined here, as in JAX: like the JAX one it is
a composition around one kernel (the block-table walk), not a kernel of its
own.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels.flash_decode import NULL_BLOCK, paged_flash_decode
from triton_dist_tpu_torch.kernels.group_gemm import matmul_f32
from triton_dist_tpu_torch.kernels.mega_decode import (  # noqa: F401
    fused_attn_back,
    fused_ln_qkv_rope,
    fused_mlp_block,
    fused_norm_head,
)
from triton_dist_tpu_torch.kernels.mega_moe import fused_moe_block  # noqa: F401


def paged_write_at(tables: torch.Tensor, lengths: torch.Tensor, active: torch.Tensor, bs: int):
    """Where each slot's new K/V row goes in a block pool: (physical block,
    row in the block, keep mask), each (B,). An inactive slot writes to the
    NULL block (its old blocks may already belong to another tenant); an
    active slot whose row ``lengths // bs`` lies past the table writes
    nothing, as JAX's out-of-range ``take_along_axis`` index drops the
    scatter."""
    mb = tables.shape[1]
    idx = (lengths // bs).long()
    blk = torch.gather(tables, 1, idx.clamp(max=mb - 1)[:, None])[:, 0]
    phys = torch.where(active, blk, torch.full_like(blk, NULL_BLOCK)).long()
    keep = (idx < mb) | ~active
    return phys, (lengths % bs).long(), keep


def write_pool_rows(pk, pv, li: int, k_new: torch.Tensor, v_new: torch.Tensor, at) -> None:
    """Write ``k_new``/``v_new`` (B, Hkv, D) into layer ``li`` of the
    stacked pools (L, num_blocks, Hkv, bs, D) in place, at ``at =
    paged_write_at(...)``. ``QuantPool`` pools take the rows quantized once,
    here, K and V in one pass (plain tensor ops: JAX's XLA code at this
    point); payload and scale land together."""
    from triton_dist_tpu_torch.models.quant import QuantPool, quantize_kv_rows

    phys, sub, keep = at
    if not isinstance(pk, QuantPool):
        _write_at(pk, li, k_new, phys, sub, keep)
        _write_at(pv, li, v_new, phys, sub, keep)
        return
    q, s = quantize_kv_rows(torch.stack((k_new, v_new)), pk.wire)  # (2, B, Hkv, D), (2, B, Hkv, 1)
    for i, pool in enumerate((pk, pv)):
        # The payload moves as bytes: not every op takes an fp8 tensor.
        _write_at(pool.q.view(torch.uint8), li, q[i].view(torch.uint8), phys, sub, keep)
        _write_at(pool.scale, li, s[i], phys, sub, keep)


def _write_at(pool: torch.Tensor, li: int, new: torch.Tensor, phys, sub, keep) -> None:
    pool[li, phys, :, sub] = torch.where(keep[:, None, None], new, pool[li, phys, :, sub])


def fused_paged_attn_back(
    q: torch.Tensor,  # (B, Hq, D) roped decode queries
    k_new: torch.Tensor,  # (B, Hkv, D) this step's K row
    v_new: torch.Tensor,  # (B, Hkv, D)
    pk,  # (L, num_blocks, Hkv, bs, D) stacked block pool, or a QuantPool
    pv,
    li: int,  # layer index into the pool's leading dim
    tables: torch.Tensor,  # (B, max_blocks) int32 physical block ids
    lengths: torch.Tensor,  # (B,) int32 valid length BEFORE this step
    active: torch.Tensor,  # (B,) bool serving slot mask
    wo: torch.Tensor,  # (Hq·D, n) o-projection
    *,
    scale: float | None = None,
    at=None,
):
    """Paged attention back-leg: pool scatter → block-table walk →
    o-projection partial. The new rows land at ``tables[b, lengths // bs]``,
    row ``lengths % bs`` (``paged_write_at``: inactive slots write to the
    NULL block), then ``paged_flash_decode`` attends over ``lengths +
    active`` keys and the rounded o goes through ``wo`` in fp32 (a plain
    ``matmul``, as JAX's ``jnp.dot``). Returns ``(partial (B, n) fp32, pk,
    pv)``; the pools are written in place. ``at`` passes a precomputed
    ``paged_write_at`` (the same for every layer of a step). ``pk``/``pv``
    may be ``QuantPool`` pairs: the new rows are quantized once at append
    and the walk is row 3b (JAX ``megakernel/kernels.py:533-570``)."""
    b, hq, d = q.shape
    if at is None:
        at = paged_write_at(tables, lengths, active, pk.shape[3])
    write_pool_rows(pk, pv, li, k_new, v_new, at)
    o = paged_flash_decode(q, pk[li], pv[li], tables, lengths + active.to(lengths.dtype), scale=scale)
    return matmul_f32(o.reshape(b, hq * d), wo), pk, pv

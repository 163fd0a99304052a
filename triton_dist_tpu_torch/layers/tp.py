"""Tensor-parallel layers: RMSNorm, RoPE, attention, MLP, MoE.

Counterpart of ``triton_dist_tpu/layers/tp.py`` (``RMSNorm``, ``apply_rope``,
``TP_Attn``, ``TP_MLP``, ``TP_MoE``). A layer takes its rank's shard of the
weights and the rank's ``runtime.mesh.DistContext`` (``ctx``; None at world
1). Per rank, as in JAX: ``TP_Attn`` holds its ``wqkv`` columns (its q, k
and v heads) and ``wo`` rows, ``TP_MLP`` its gate/up columns and down rows.
The modes are JAX's:

* ``xla``: plain products, then ``psum`` of the fp32 partials;
* ``dist`` (prefill, x sequence-sharded in and out): ``ag_gemm_shard`` on
  ``wqkv`` and ``ag_gemm_swiglu_shard`` on gate/up, ``gemm_rs_shard`` on
  ``wo`` and down (rows 16 and 17 above their crossovers);
* ``dist_ar`` (x replicated): plain products, ``gemm_ar_shard`` on ``wo``
  and down (row 19 for decode-sized or ragged m, row 18 above).

At world 1 every collective matmul is a plain product, so the three modes
compute the same. ``TP_MoE`` keeps the JAX branches by mode and token
count: the rings of ``kernels/moe_comm.py``, or the unchunked grouped GEMMs
followed by ``all_reduce_shard`` (rows 20-22) or ``psum``; at world 1 they
all route every token with one capacity, and all but ``xla`` run the
grouped gate/up kernel.

The caches are updated in place (JAX returns new arrays): ``decode`` and
``prefill_chunk`` write their new K/V rows into the tensors they are given
and return those same tensors.
"""

from __future__ import annotations

import torch
from torch import nn

from triton_dist_tpu_torch.kernels.allgather_gemm import ag_gemm_shard, ag_gemm_swiglu_shard
from triton_dist_tpu_torch.kernels.allreduce import AllReduceMethod, all_reduce_shard
from triton_dist_tpu_torch.kernels.flash_attn import flash_attention
from triton_dist_tpu_torch.kernels.flash_decode import flash_decode
from triton_dist_tpu_torch.kernels.gemm_allreduce import gemm_ar_shard
from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import gemm_rs_shard
from triton_dist_tpu_torch.kernels.group_gemm import group_gemm, group_gemm_swiglu, matmul_f32
from triton_dist_tpu_torch.kernels.moe_comm import tp_moe_ar_shard, tp_moe_partial, tp_moe_rs_shard
from triton_dist_tpu_torch.kernels.moe_utils import CAPACITY_ALIGN
from triton_dist_tpu_torch.kernels.norm_rope import apply_rope, rmsnorm
from triton_dist_tpu_torch.runtime.mesh import all_gather, psum

MODES = ("xla", "dist", "dist_ar")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


def _world(ctx) -> int:
    return 1 if ctx is None else ctx.world


def _psum_out(ctx, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The ``xla`` mode's row-parallel product: ``psum`` of the fp32
    partial, cast once (a plain product at world 1)."""
    if _world(ctx) == 1:
        return a @ w
    return psum(ctx, matmul_f32(a, w)).to(a.dtype)


class RMSNorm(nn.Module):
    """Qwen3 RMSNorm: normalise in fp32, cast to the input dtype, then scale
    by the weight (the cast comes before the multiply, as in JAX)."""

    def __init__(self, weight: torch.Tensor, eps: float = 1e-6):
        super().__init__()
        self.register_buffer("weight", weight, persistent=False)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.weight, self.eps)


class TP_MLP(nn.Module):
    """SwiGLU MLP: ``silu(x @ w_gate) * (x @ w_up)`` in fp32, cast, then
    ``@ w_down``; ``w_gate``/``w_up`` (d, ff_local), ``w_down`` (ff_local, d)."""

    def __init__(self, w_gate, w_up, w_down, *, ctx=None):
        super().__init__()
        self.register_buffer("w_gate", w_gate, persistent=False)
        self.register_buffer("w_up", w_up, persistent=False)
        self.register_buffer("w_down", w_down, persistent=False)
        self.ctx = ctx

    def forward(self, x: torch.Tensor, mode: str = "dist") -> torch.Tensor:
        """x: (m_shard, d) for ``dist`` (sequence-sharded), (m, d) for
        ``xla``/``dist_ar`` (replicated); the output is sharded like x."""
        _check_mode(mode)
        if mode == "dist":
            h = ag_gemm_swiglu_shard(self.ctx, x, self.w_gate, self.w_up)
            return gemm_rs_shard(self.ctx, h, self.w_down)
        g = matmul_f32(x, self.w_gate)
        u = matmul_f32(x, self.w_up)
        h = (torch.nn.functional.silu(g) * u).to(x.dtype)
        if mode == "xla":
            return _psum_out(self.ctx, h, self.w_down)
        return gemm_ar_shard(self.ctx, h, self.w_down)


#: TP-MoE routing capacity factor, shared by prefill and decode: every
#: caller must route tokens alike, or the paths drop different tokens.
MOE_CAPACITY_FACTOR = 2.0


def _xla_swiglu(xe: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor) -> torch.Tensor:
    """The ``xla`` mode's gate/up: two plain grouped GEMMs, each cast to
    x's dtype before the fp32 SwiGLU, as JAX does (no kernel)."""
    g = group_gemm(xe, w_gate).float()
    u = group_gemm(xe, w_up).float()
    return (torch.nn.functional.silu(g) * u).to(xe.dtype)


class TP_MoE(nn.Module):
    """Tensor-parallel MoE: every expert's ff dimension split over the ranks
    (at world 1, whole). Routing is top-k over the router's fp32 logits
    with a per-expert capacity of ``MOE_CAPACITY_FACTOR``; the down
    projection's partial sums reduce over the ranks in fp32.

    Weights (this rank's shard): ``w_router`` (d, E), ``w_gate`` and
    ``w_up`` (E, d, ff_local), ``w_down`` (E, ff_local, d)."""

    def __init__(self, w_router, w_gate, w_up, w_down, *, top_k: int = 8, ctx=None):
        super().__init__()
        self.register_buffer("w_router", w_router, persistent=False)
        self.register_buffer("w_gate", w_gate, persistent=False)
        self.register_buffer("w_up", w_up, persistent=False)
        self.register_buffer("w_down", w_down, persistent=False)
        self.top_k = top_k
        self.ctx = ctx

    def forward(self, x: torch.Tensor, mode: str = "dist_ar") -> torch.Tensor:
        """x (T, d) → (T, d), branch by branch as JAX's ``TP_MoE.__call__``:

        * ``dist`` (x seq-sharded): T < ``CAPACITY_ALIGN`` gathers the
          shards, takes the replicated path and keeps this rank's rows;
          otherwise the AG-MoE → MoE-RS ring pair, ``tp_moe_rs_shard``.
        * ``dist_ar`` (x replicated): T % world == 0 with T/world ≥
          ``CAPACITY_ALIGN`` takes the chunked ring, ``tp_moe_ar_shard``;
          otherwise all of x is routed at once, run through the grouped
          GEMMs, and the fp32 partials are all-reduced (``AUTO``).
        * ``xla``: the same unchunked routing with plain grouped GEMMs (no
          kernel), then a ``psum``.

        The ring paths route with a per-chunk capacity, the others with one
        capacity for all T tokens (JAX's contract). At world 1 the gather,
        the rings and the reductions are identities."""
        _check_mode(mode)
        ctx, world = self.ctx, _world(self.ctx)
        t = x.shape[0]
        weights = (self.w_router, self.w_gate, self.w_up, self.w_down)
        kw = dict(top_k=self.top_k, capacity_factor=MOE_CAPACITY_FACTOR)
        if mode == "dist":
            if t < CAPACITY_ALIGN:
                # Tiny seq shards: gather once, run the replicated path, keep
                # this rank's chunk.
                if world == 1:
                    return self.forward(x, mode="dist_ar")
                out = self.forward(all_gather(ctx, x, 0), mode="dist_ar")
                return out[ctx.rank * t:(ctx.rank + 1) * t]
            return tp_moe_rs_shard(ctx, x, *weights, **kw)
        if mode == "dist_ar" and t % world == 0 and t // world >= CAPACITY_ALIGN:
            return tp_moe_ar_shard(ctx, x, *weights, **kw)
        # Unchunked: all of x routed at once; fp32 partials on the wire.
        swiglu = _xla_swiglu if mode == "xla" else group_gemm_swiglu
        out = tp_moe_partial(x, *weights, swiglu=swiglu, **kw)
        if world > 1:
            out = psum(ctx, out) if mode == "xla" else all_reduce_shard(ctx, out, method=AllReduceMethod.AUTO)
        return out.to(x.dtype)


class TP_Attn(nn.Module):
    """QKV projection → per-head q/k RMSNorm → RoPE → flash attention or
    flash decode → O projection, over this rank's heads: ``wqkv`` (d,
    (hq + 2·hkv)·hd) read as [q | k | v] of the local heads, ``wo`` (hq·hd,
    d); ``num_q_heads``/``num_kv_heads`` are the local counts."""

    def __init__(self, wqkv, wo, q_norm: RMSNorm | None, k_norm: RMSNorm | None, *,
                 num_q_heads: int, num_kv_heads: int, head_dim: int = 128,
                 rope_theta: float = 1e6, ctx=None):
        super().__init__()
        self.ctx = ctx
        self.register_buffer("wqkv", wqkv, persistent=False)
        self.register_buffer("wo", wo, persistent=False)
        self.q_norm = q_norm
        self.k_norm = k_norm
        self.num_q_heads = num_q_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.rope_theta = rope_theta

    def _split_qkv(self, qkv: torch.Tensor, bsz: int, seq: int):
        hq, hkv, hd = self.num_q_heads, self.num_kv_heads, self.head_dim
        qkv = qkv.reshape(bsz, seq, hq + 2 * hkv, hd)
        q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
        if self.q_norm is not None:
            q = self.q_norm(q)
        if self.k_norm is not None:
            k = self.k_norm(k)
        # (B, H, S, D)
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def _rope_qk(self, qkv, pos, bsz, seq):
        q, k, v = self._split_qkv(qkv, bsz, seq)
        q = apply_rope(q, pos, self.rope_theta).contiguous()
        k = apply_rope(k, pos, self.rope_theta).contiguous()
        return q, k, v.contiguous()

    def _out(self, o: torch.Tensor, mode: str) -> torch.Tensor:
        """The O projection of a replicated call: ``psum`` (``xla``) or
        ``gemm_ar_shard``."""
        if mode == "xla":
            return _psum_out(self.ctx, o, self.wo)
        return gemm_ar_shard(self.ctx, o, self.wo)

    def prefill(self, x: torch.Tensor, pos: torch.Tensor, mode: str = "dist", bsz: int = 1):
        """x: (bsz·seq, d) tokens, this rank's (bsz·seq / world) rows in
        ``dist`` mode; pos: (bsz, seq). Returns (out sharded like x, (k, v)
        each (B, Hkv_local, S, D))."""
        _check_mode(mode)
        seq = pos.shape[1]
        qkv = ag_gemm_shard(self.ctx, x, self.wqkv) if mode == "dist" else x @ self.wqkv
        q, k, v = self._rope_qk(qkv, pos, bsz, seq)
        o = flash_attention(q, k, v, causal=True)
        o = o.transpose(1, 2).reshape(bsz * seq, -1)
        if mode == "dist":
            return gemm_rs_shard(self.ctx, o, self.wo), (k, v)
        return self._out(o, mode), (k, v)

    def prefill_chunk(self, x, pos, k_buf, v_buf, off: int, mode: str = "dist_ar",
                      bsz: int = 1):
        """One prefill chunk against running per-request buffers
        ``k_buf``/``v_buf`` (B, Hkv, P, D): writes the chunk's K/V rows at
        ``off + arange(C)`` (rows past P are dropped, as JAX's
        ``mode="drop"``) and attends the chunk's queries over the whole buffer
        with the offset causal mask. Returns (out (bsz·C, d), (k_buf, v_buf))."""
        _check_mode(mode)
        seq = pos.shape[1]
        q, k, v = self._rope_qk(x @ self.wqkv, pos, bsz, seq)
        n = max(0, min(seq, k_buf.shape[2] - off))
        k_buf[:, :, off:off + n] = k[:, :, :n]
        v_buf[:, :, off:off + n] = v[:, :, :n]
        o = flash_attention(q, k_buf, v_buf, causal=True, q_offset=off, kv_offset=0)
        o = o.transpose(1, 2).reshape(bsz * seq, -1)
        return self._out(o, "xla" if mode == "xla" else "dist_ar"), (k_buf, v_buf)

    def decode(self, x, pos, k_cache, v_cache, lengths, mode: str = "dist_ar"):
        """One-token decode. x: (bsz, d); pos, lengths: (bsz,) int32; caches
        (B, Hkv, S, D). Writes the new K/V at ``lengths`` (a slot whose
        length has reached S writes nothing, as JAX's out-of-bounds scatter
        drops), then attends over ``lengths + 1`` keys."""
        _check_mode(mode)
        bsz = x.shape[0]
        q, k, v = self._rope_qk(x @ self.wqkv, pos[:, None], bsz, 1)
        s = k_cache.shape[2]
        rows = torch.arange(bsz, device=x.device)
        idx = lengths.long().clamp(max=s - 1)
        keep = (lengths < s)[:, None, None]
        k_cache[rows, :, idx] = torch.where(keep, k[:, :, 0], k_cache[rows, :, idx])
        v_cache[rows, :, idx] = torch.where(keep, v[:, :, 0], v_cache[rows, :, idx])
        o = flash_decode(q[:, :, 0].contiguous(), k_cache, v_cache, lengths + 1)
        return self._out(o.reshape(bsz, -1), "xla" if mode == "xla" else "dist_ar"), (k_cache, v_cache)

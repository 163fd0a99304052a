"""Tensor-parallel layers at world 1: RMSNorm, RoPE, attention, MLP, MoE.

Counterpart of ``triton_dist_tpu/layers/tp.py`` (``RMSNorm``, ``apply_rope``,
``TP_Attn``, ``TP_MLP``, ``TP_MoE``). At world 1 the JAX package's collective
matmuls (``ag_gemm_shard``, ``ag_gemm_swiglu_shard``, ``gemm_rs_shard``,
``gemm_ar_shard``) all short-circuit to a plain fp32-accumulating dot, so
every mode (``xla``, ``dist``, ``dist_ar``) of the dense layers is the same
computation here: ``torch.matmul`` plus the two attention kernels.
``TP_MoE`` keeps the JAX branches by mode and token count; at world 1 they
all route every token with one capacity, and all but ``xla`` run the
grouped gate/up kernel. World > 1 needs the one-sided communication layer
and is not ported yet.

The caches are updated in place (JAX returns new arrays): ``decode`` and
``prefill_chunk`` write their new K/V rows into the tensors they are given
and return those same tensors.
"""

from __future__ import annotations

import torch
from torch import nn

from triton_dist_tpu_torch.kernels.flash_attn import flash_attention
from triton_dist_tpu_torch.kernels.flash_decode import flash_decode
from triton_dist_tpu_torch.kernels.group_gemm import group_gemm, group_gemm_swiglu, matmul_f32
from triton_dist_tpu_torch.kernels.moe_comm import tp_moe_ar_shard, tp_moe_one_chunk, tp_moe_rs_shard
from triton_dist_tpu_torch.kernels.moe_utils import CAPACITY_ALIGN

MODES = ("xla", "dist", "dist_ar")
_WORLD_GT_1 = (
    "tensor-parallel world > 1 is not ported yet: it needs the one-sided "
    "layer and the collective-matmul kernels (ROADMAP queue 1 item B)"
)


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


def _check_world(world: int) -> None:
    if world != 1:
        raise NotImplementedError(_WORLD_GT_1)


class RMSNorm(nn.Module):
    """Qwen3 RMSNorm: normalise in fp32, cast to the input dtype, then scale
    by the weight (the cast comes before the multiply, as in JAX)."""

    def __init__(self, weight: torch.Tensor, eps: float = 1e-6):
        super().__init__()
        self.register_buffer("weight", weight, persistent=False)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float = 1e6) -> torch.Tensor:
    """Rotary embedding on split halves (rotate-half, as the JAX code does).

    x: (B, H, S, D); pos: (B, S) absolute positions."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    angles = pos[:, None, :, None].float() * freqs  # (B, 1, S, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


class TP_MLP(nn.Module):
    """SwiGLU MLP: ``silu(x @ w_gate) * (x @ w_up)`` in fp32, cast, then
    ``@ w_down`` (``ag_gemm_swiglu_shard`` + ``gemm_rs_shard`` at world 1)."""

    def __init__(self, w_gate, w_up, w_down, *, world: int = 1):
        super().__init__()
        _check_world(world)
        self.register_buffer("w_gate", w_gate, persistent=False)
        self.register_buffer("w_up", w_up, persistent=False)
        self.register_buffer("w_down", w_down, persistent=False)

    def forward(self, x: torch.Tensor, mode: str = "dist") -> torch.Tensor:
        """x: (m, d) → (m, d)."""
        _check_mode(mode)
        g = matmul_f32(x, self.w_gate)
        u = matmul_f32(x, self.w_up)
        h = (torch.nn.functional.silu(g) * u).to(x.dtype)
        return h @ self.w_down


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

    Weights: ``w_router`` (d, E), ``w_gate`` and ``w_up`` (E, d, ff),
    ``w_down`` (E, ff, d)."""

    def __init__(self, w_router, w_gate, w_up, w_down, *, top_k: int = 8, world: int = 1):
        super().__init__()
        _check_world(world)
        self.register_buffer("w_router", w_router, persistent=False)
        self.register_buffer("w_gate", w_gate, persistent=False)
        self.register_buffer("w_up", w_up, persistent=False)
        self.register_buffer("w_down", w_down, persistent=False)
        self.top_k = top_k
        self.world = world

    def forward(self, x: torch.Tensor, mode: str = "dist_ar") -> torch.Tensor:
        """x (T, d) → (T, d), branch by branch as JAX's ``TP_MoE.__call__``:

        * ``dist`` (x seq-sharded): T < ``CAPACITY_ALIGN`` gathers the
          shards and takes the replicated path; otherwise the AG-MoE → MoE-RS
          ring pair, ``tp_moe_rs_shard``.
        * ``dist_ar`` (x replicated): T/world ≥ ``CAPACITY_ALIGN`` takes the
          chunked ring, ``tp_moe_ar_shard``; smaller T routes all of x at
          once, runs the grouped GEMMs and all-reduces.
        * ``xla``: the same unchunked routing with plain grouped GEMMs (no
          kernel), then a psum.

        At world 1 the gather, the rings and the reductions are identities,
        so every branch routes all T tokens with ``capacity_for(T, k, E,
        MOE_CAPACITY_FACTOR)`` and combines in fp32 before one cast."""
        _check_mode(mode)
        world = self.world
        t = x.shape[0]
        weights = (self.w_router, self.w_gate, self.w_up, self.w_down)
        kw = dict(top_k=self.top_k, capacity_factor=MOE_CAPACITY_FACTOR)
        if mode == "dist":
            if t < CAPACITY_ALIGN:
                # JAX gathers the seq shards (the identity at world 1), runs
                # the replicated path and slices its own chunk back (all of it).
                return self.forward(x, mode="dist_ar")
            return tp_moe_rs_shard(x, *weights, **kw)
        if mode == "dist_ar" and t % world == 0 and t // world >= CAPACITY_ALIGN:
            return tp_moe_ar_shard(x, *weights, **kw)
        # Unchunked: all of x routed at once; the fp32 partials' psum /
        # all-reduce over one rank is the identity.
        swiglu = _xla_swiglu if mode == "xla" else group_gemm_swiglu
        return tp_moe_one_chunk(x, *weights, swiglu=swiglu, **kw)


class TP_Attn(nn.Module):
    """QKV projection → per-head q/k RMSNorm → RoPE → flash attention or
    flash decode → O projection."""

    def __init__(self, wqkv, wo, q_norm: RMSNorm | None, k_norm: RMSNorm | None, *,
                 num_q_heads: int, num_kv_heads: int, head_dim: int = 128,
                 rope_theta: float = 1e6, world: int = 1):
        super().__init__()
        _check_world(world)
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

    def prefill(self, x: torch.Tensor, pos: torch.Tensor, mode: str = "dist", bsz: int = 1):
        """x: (bsz·seq, d); pos: (bsz, seq). Returns (out (bsz·seq, d),
        (k, v) each (B, Hkv, S, D))."""
        _check_mode(mode)
        seq = pos.shape[1]
        q, k, v = self._rope_qk(x @ self.wqkv, pos, bsz, seq)
        o = flash_attention(q, k, v, causal=True)
        o = o.transpose(1, 2).reshape(bsz * seq, -1)
        return o @ self.wo, (k, v)

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
        return o @ self.wo, (k_buf, v_buf)

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
        return o.reshape(bsz, -1) @ self.wo, (k_cache, v_cache)

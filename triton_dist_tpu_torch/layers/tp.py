"""Tensor-parallel layers at world 1: RMSNorm, RoPE, attention, MLP.

Counterpart of ``triton_dist_tpu/layers/tp.py`` (``RMSNorm``, ``apply_rope``,
``TP_Attn``, ``TP_MLP``). At world 1 the JAX package's collective matmuls
(``ag_gemm_shard``, ``ag_gemm_swiglu_shard``, ``gemm_rs_shard``,
``gemm_ar_shard``) all short-circuit to a plain fp32-accumulating dot, so
every mode (``xla``, ``dist``, ``dist_ar``) is the same computation here:
``torch.matmul`` plus the two attention kernels. World > 1 needs the
one-sided communication layer and is not ported yet.

The caches are updated in place (JAX returns new arrays): ``decode`` and
``prefill_chunk`` write their new K/V rows into the tensors they are given
and return those same tensors.
"""

from __future__ import annotations

import torch
from torch import nn

from triton_dist_tpu_torch.kernels.flash_attn import flash_attention
from triton_dist_tpu_torch.kernels.flash_decode import flash_decode

MODES = ("xla", "dist", "dist_ar")
_WORLD_GT_1 = (
    "tensor-parallel world > 1 is not ported yet: it needs the one-sided "
    "layer and the collective-matmul kernels (ROADMAP queue 1 item 2, queue 2 items 0-6)"
)


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


def _check_world(world: int) -> None:
    if world != 1:
        raise NotImplementedError(_WORLD_GT_1)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated and returned in fp32 (JAX's
    ``jnp.dot(..., preferred_element_type=float32)``) for 2-D ``x``."""
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


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

"""Plain Qwen3 RMSNorm and RoPE, shared by the layers and by the plain
versions of the fused decode kernels, so that both round at the same
points."""

from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Qwen3 RMSNorm over the last axis: normalise in fp32, cast to x's
    dtype, THEN scale by the weight (the JAX ``RMSNorm`` and
    ``_rmsnorm_rows`` order; the port keeps x and w in one dtype)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float = 1e6) -> torch.Tensor:
    """Rotary embedding on split halves (rotate-half, as the JAX code does),
    in fp32 and cast once.

    x: (B, H, S, D) with pos (B, S), or decode rows (B, H, D) with pos (B,);
    pos holds absolute positions."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    angles = pos.float().reshape(pos.shape[0], 1, *pos.shape[1:], 1) * freqs  # (B, 1, [S,] half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)

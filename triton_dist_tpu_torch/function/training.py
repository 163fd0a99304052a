"""One attention block as a training loss: the port's counterpart of the
loss in the JAX package's ``tests/test_function.py::test_model_training_step``
(at world 1), and of tutorial 11's packed-sequence step.

embed → RMSNorm → ``wqkv`` → RoPE → ``flash_attention_fn`` (or, packed,
``flash_attention_varlen_fn``) → ``wo``; the loss is mean(out²). The dense
products run in fp32 and are cast once, as JAX's
``jnp.dot(..., preferred_element_type=float32)``; the output projection
stays in fp32, as JAX's loss reads it.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.function.collectives import flash_attention_fn, flash_attention_varlen_fn
from triton_dist_tpu_torch.kernels.flash_attn import _varlen_segments
from triton_dist_tpu_torch.kernels.norm_rope import apply_rope, rmsnorm


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def packed_positions(cu_seqlens, t: int, device) -> torch.Tensor:
    """RoPE positions of a packed stream (1, t): each sequence counts from 0;
    the padding tail counts on from the last sequence's end."""
    cu = torch.as_tensor(cu_seqlens, dtype=torch.int64, device=device)
    seg = _varlen_segments(cu_seqlens, t, device=device)[0][0].long()
    pos = torch.arange(t, device=device)
    start = torch.where(seg >= 0, cu[seg.clamp(min=0)], cu[-1])
    return (pos - start)[None]


def attention_block_loss(embed, ln1, wqkv, wo, tokens, cfg, *, cu_seqlens=None) -> torch.Tensor:
    """mean(out²) of one attention block over ``tokens`` (B, S), with
    ``cfg``'s heads, RMSNorm epsilon and RoPE base. With ``cu_seqlens``
    (B = 1), the row is a packed stream and attention stays inside each
    sequence."""
    bsz, seq = tokens.shape
    hq, hkv, hd = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
    x = embed[tokens].reshape(bsz * seq, cfg.hidden_size)
    qkv = _dot(rmsnorm(x, ln1, cfg.rms_eps), wqkv).reshape(bsz, seq, hq + 2 * hkv, hd)
    if cu_seqlens is None:
        pos = torch.arange(seq, device=x.device).expand(bsz, seq)
    else:
        pos = packed_positions(cu_seqlens, seq, x.device)
    q = apply_rope(qkv[:, :, :hq].transpose(1, 2), pos, cfg.rope_theta)
    k = apply_rope(qkv[:, :, hq:hq + hkv].transpose(1, 2), pos, cfg.rope_theta)
    v = qkv[:, :, hq + hkv:].transpose(1, 2)
    if cu_seqlens is None:
        o = flash_attention_fn(q.contiguous(), k.contiguous(), v.contiguous(), True)
    else:
        o = flash_attention_varlen_fn(q[0].contiguous(), k[0].contiguous(), v[0].contiguous(), cu_seqlens)[None]
    out = torch.matmul(o.transpose(1, 2).reshape(bsz * seq, hq * hd).float(), wo.float())
    return (out ** 2).mean()

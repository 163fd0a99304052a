"""Contiguous KV cache: counterpart of ``KVCache`` in
``triton_dist_tpu/models/kv_cache.py``.

Stacked per-layer caches ``(L, B, Hkv, S, D)`` and an int32 ``lengths``
vector. The JAX handle is updated functionally and donated through jit; this
one is updated in place by the engine's steps.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # (L, B, Hkv, S, D)
    v: torch.Tensor
    lengths: torch.Tensor  # (B,) int32

    @staticmethod
    def create(num_layers, bsz, num_kv_heads, max_len, head_dim, *, dtype, device) -> "KVCache":
        shape = (num_layers, bsz, num_kv_heads, max_len, head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            lengths=torch.zeros((bsz,), dtype=torch.int32, device=device),
        )

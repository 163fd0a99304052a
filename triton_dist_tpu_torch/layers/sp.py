"""Sequence-parallel attention layers: counterpart of
``triton_dist_tpu/layers/sp.py`` (``RingSPAttn``, ``UlyssesSPAttn``,
``AGSPAttn``; ``Ring2DSPAttn``, over a two-axis mesh, is not ported yet and
raises).

Frozen dataclasses with JAX's fields and defaults, where the port's
``DistContext`` (``ctx``; None at world 1) takes the place of JAX's axis
name.
"""

from __future__ import annotations

import dataclasses

from triton_dist_tpu_torch.kernels.ag_attention import ag_attention_supported, ag_flash_attention_shard
from triton_dist_tpu_torch.kernels.sp import NEEDS_2D_MESH, ring_attention_shard, ulysses_attention_shard


@dataclasses.dataclass(frozen=True)
class RingSPAttn:
    """Ring sequence-parallel attention: q, k, v (B, H, S_local, D)
    sequence-sharded over ``ctx``'s ranks, exact attention over the whole
    sequence by rotating KV (``ring_attention_shard``). ``cu_seqlens``
    (global packed-document offsets; B > 1 folds into heads) runs every
    ring step through the varlen kernel; it is causal within a document by
    definition, so ``causal=False`` with ``cu_seqlens`` raises."""

    ctx: object = None
    causal: bool = True
    block_q: int = 256
    block_k: int = 256

    def __call__(self, q, k, v, cu_seqlens=None):
        if cu_seqlens is not None and not self.causal:
            raise ValueError("RingSPAttn(causal=False) cannot take cu_seqlens: the packed-document mask is "
                             "causal-within-document by definition")
        return ring_attention_shard(self.ctx, q, k, v, causal=self.causal, block_q=self.block_q,
                                    block_k=self.block_k, cu_seqlens=cu_seqlens)


@dataclasses.dataclass(frozen=True)
class Ring2DSPAttn:
    """The two-level ring layer (JAX ``Ring2DSPAttn``): not ported; raises."""

    axes: tuple = ("dcn", "ici")
    causal: bool = True
    block_q: int = 256
    block_k: int = 256

    def __call__(self, q, k, v, cu_seqlens=None):
        raise NotImplementedError(NEEDS_2D_MESH)


@dataclasses.dataclass(frozen=True)
class UlyssesSPAttn:
    """Ulysses attention: q, k, v (B, S_local, H, D) sequence-sharded, an
    all-to-all (row 25 with ``use_pallas_a2a``) to head sharding around
    whole-sequence flash attention (``ulysses_attention_shard``)."""

    ctx: object = None
    causal: bool = True
    use_pallas_a2a: bool = False

    def __call__(self, q, k, v):
        return ulysses_attention_shard(self.ctx, q, k, v, causal=self.causal, use_pallas_a2a=self.use_pallas_a2a)


@dataclasses.dataclass(frozen=True)
class AGSPAttn:
    """Fused all-gather attention (row 27, ``ag_flash_attention_shard``)
    where JAX's plan check (``ag_attention_supported`` at
    ``vmem_limit_mb``) admits the shape, else the ring
    (``ring_attention_shard``, the same function): JAX's routing, so both
    packages take the same path for a shape, and the launch counts show
    which."""

    ctx: object = None
    mesh_axes: tuple | None = None
    causal: bool = True
    vmem_limit_mb: int = 100
    block_q: int = 256  # the ring route's flash blocks
    block_k: int = 256

    def __call__(self, q, k, v):
        world = 1 if self.ctx is None else self.ctx.world
        b, hq, s_loc, d = q.shape
        if ag_attention_supported(world, b, hq, k.shape[1], s_loc, d, q.element_size(), self.vmem_limit_mb):
            return ag_flash_attention_shard(self.ctx, q, k, v, mesh_axes=self.mesh_axes, causal=self.causal,
                                            vmem_limit_mb=self.vmem_limit_mb)
        return ring_attention_shard(self.ctx, q, k, v, causal=self.causal, block_q=self.block_q,
                                    block_k=self.block_k)

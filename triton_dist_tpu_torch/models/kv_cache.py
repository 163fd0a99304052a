"""KV caches: counterpart of ``triton_dist_tpu/models/kv_cache.py``
(``KVCache``, ``NULL_BLOCK``, ``BlockAllocator``, ``PagedKVCache``).

``KVCache`` holds stacked per-layer caches ``(L, B, Hkv, S, D)`` and an
int32 ``lengths`` vector. ``PagedKVCache`` splits the slot cache into one
global block pool ``(L, num_blocks, Hkv, block_size, D)`` shared by every
slot, with per-slot int32 block tables. ``BlockAllocator`` is the host-side
bookkeeping of that pool, a copy of the JAX one (which imports no JAX
itself, but sits in a package that does). The JAX handles are updated
functionally and donated through jit; these are updated in place by the
engine's steps.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.kernels.flash_decode import NULL_BLOCK  # noqa: F401

_QUANT_POOLS = "quantized KV pools (int8/fp8 with row scales) are ROADMAP queue 1 item E"


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


class BlockAllocator:
    """Host-side free-list + refcount bookkeeping for a paged KV pool.

    The device never sees this object — it only sees the int32 block
    tables the serving layer builds from the chains handed out here.
    Block 0 is the NULL block: it is never allocated, so table rows can
    point masked or out-of-range writes at it without corrupting a
    tenant (the paged analog of the slot cache's harmless-garbage row).

    Refcounts make prefix sharing safe: a block chain owned by the radix
    index and referenced by N running slots has refcount N+1; ``free``
    only returns a block to the free list when the count hits zero, and
    ``ensure_exclusive`` is the copy-on-write primitive (returns a fresh
    block when the caller does not hold the only reference).
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved null)")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))  # pop() yields 1,2,…
        self._ref = {}  # block -> refcount (absent = free)

    # -- queries ----------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    @property
    def num_shared(self) -> int:
        """Blocks held by more than one reference."""
        return sum(1 for c in self._ref.values() if c > 1)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    # -- lifecycle --------------------------------------------------------
    def alloc(self, n: int) -> list[int] | None:
        """Allocate ``n`` blocks at refcount 1, or None (all-or-nothing)."""
        if n < 0 or n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._ref[b] = 1
        return blocks

    def incref(self, blocks: list[int]) -> None:
        for b in blocks:
            if b == NULL_BLOCK or b not in self._ref:
                raise ValueError(f"incref of unallocated block {b}")
            self._ref[b] += 1

    def free(self, blocks: list[int]) -> None:
        """Drop one reference per block; recycle those that hit zero."""
        for b in blocks:
            if b == NULL_BLOCK:
                continue
            c = self._ref.get(b, 0)
            if c <= 0:
                raise ValueError(f"double free of block {b}")
            if c == 1:
                del self._ref[b]
                self._free.append(b)
            else:
                self._ref[b] = c - 1

    def ensure_exclusive(self, block: int) -> tuple[int, bool]:
        """Copy-on-write: return ``(block, False)`` when the caller holds
        the only reference, else drop the shared ref and hand back a fresh
        block as ``(new_block, True)`` — the caller must copy the pool
        contents before writing. Raises when the pool is dry (the caller's
        eviction policy runs *before* divergent writes, so this is a
        can't-happen guard, not a control path)."""
        if self._ref.get(block, 0) <= 1:
            return block, False
        fresh = self.alloc(1)
        if fresh is None:
            raise RuntimeError("KV pool exhausted during copy-on-write")
        self.free([block])
        return fresh[0], True


@dataclasses.dataclass
class PagedKVCache:
    """Paged pool handle: per-layer KV blocks + per-slot block tables.

    ``k``/``v`` are (L, num_blocks, Hkv, block_size, D), a global pool
    shared by every slot; ``tables`` is (B, max_blocks) int32 mapping each
    slot's logical block index to a physical pool block (NULL_BLOCK where
    unmapped); ``lengths`` is the same (B,) valid-length vector the
    contiguous cache carries. Batch composition and chain layout change
    the tables' data, never a shape. The serving layer owns ``tables`` and
    ``lengths`` and sets them on the handle; the engine's steps write the
    pools in place and return the handle with new ``lengths``."""

    k: torch.Tensor
    v: torch.Tensor
    tables: torch.Tensor  # (B, max_blocks) int32
    lengths: torch.Tensor  # (B,) int32
    block_size: int

    @staticmethod
    def create(num_layers, num_slots, num_kv_heads, head_dim, *, block_size, num_blocks, max_len,
               dtype, device, quant: str | None = None) -> "PagedKVCache":
        """A zeroed pool (so NULL-block reads are finite) and all-NULL tables
        sized for ``max_len``."""
        if quant is not None:
            raise NotImplementedError(_QUANT_POOLS)
        shape = (num_layers, num_blocks, num_kv_heads, block_size, head_dim)
        max_blocks = -(-max_len // block_size)
        return PagedKVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            tables=torch.zeros((num_slots, max_blocks), dtype=torch.int32, device=device),
            lengths=torch.zeros((num_slots,), dtype=torch.int32, device=device),
            block_size=block_size,
        )

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def max_blocks(self) -> int:
        return self.tables.shape[1]

    @property
    def max_len(self) -> int:
        return self.max_blocks * self.block_size

    @property
    def bytes_per_block(self) -> int:
        """Device bytes one pool block costs across the k and v pools."""
        nl, _, hkv, bs, hd = self.k.shape
        return 2 * nl * hkv * bs * hd * self.k.element_size()

"""All-gather over the ranks: counterpart of ``triton_dist_tpu/kernels/allgather.py``
(``AllGatherMethod``, ``get_auto_all_gather_method``, ``all_gather_shard``,
``full_mesh_ag_call``, the host op ``all_gather``, ``all_gather_2d_shard``).

``all_gather_shard(ctx, shard)`` returns (world, *shard.shape): every rank's
shard in rank order, bit for bit. ``XLA`` (and world 1) is ``all_gather`` of
``runtime/mesh.py``; ``RING_1D`` and ``FULL_MESH_PUSH`` run row 20's two
kernels of ``csrc/collectives.cu`` (``ring_ag_call``, ``full_mesh_ag_call``)
on CUDA tensors (the source's header says what bounds them on the H100 and
how the design answers it) and their plain version, the gather, on CPU
tensors. AUTO keeps JAX's shape-only rule: a shard of 128 KiB or less takes
the full mesh, a larger one the ring, so every rank routes alike.

The helpers here (the library, the piece sizes, the operand checks) serve
the other collectives too (``reduce_scatter.py``, ``allreduce.py``).
"""

from __future__ import annotations

import ctypes
import enum

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.ep_a2a import SHMEM_ARGTYPES
from triton_dist_tpu_torch.runtime import mesh
from triton_dist_tpu_torch.shmem.symm import ALIGN, MAX_SLOTS, WS_BYTES

_U64, _SZ, _P, _I = ctypes.c_uint64, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "tdt_all_gather": SHMEM_ARGTYPES + [_P, _P, _SZ, _SZ, _SZ, _I, _U64, _SZ, _U64, _P],
    "tdt_ring_reduce_scatter": SHMEM_ARGTYPES + [_P, _SZ, _P, _SZ, _SZ, _I, _U64, _SZ, _U64, _P],
    "tdt_one_shot_all_reduce": SHMEM_ARGTYPES + [_P, _P, _SZ, _SZ, _I, _U64, _SZ, _U64, _P],
}
#: Bytes a block moves at least (a piece); a ring launch has at most
#: ``RING_BLOCKS`` blocks, so that all of them are resident at once.
MIN_PIECE_BYTES = 16 << 10
RING_BLOCKS = 128
#: A shard at or below this many bytes takes the full mesh under AUTO
#: (``allgather.py:65``).
FULL_MESH_MAX_BYTES = 128 * 1024


class AllGatherMethod(enum.Enum):
    AUTO = "auto"
    RING_1D = "ring_1d"
    FULL_MESH_PUSH = "full_mesh_push"
    XLA = "xla"


def get_auto_all_gather_method(shard_bytes: int, world: int) -> AllGatherMethod:
    """Small shards take the full mesh (one hop), larger ones the ring (JAX
    ``get_auto_all_gather_method``)."""
    return AllGatherMethod.FULL_MESH_PUSH if shard_bytes <= FULL_MESH_MAX_BYTES else AllGatherMethod.RING_1D


def collectives_library():
    """The loaded ``csrc/collectives.cu`` (rows 20-22)."""
    return _build.load("collectives", _SIGNATURES)


def round_up(n: int, to: int) -> int:
    return -(-n // to) * to


def piece_bytes(nbytes: int, max_pieces: int) -> int:
    """Bytes of one block's piece of ``nbytes``: at least ``MIN_PIECE_BYTES``
    (a multiple of 16), at most ``max_pieces`` pieces."""
    pieces = min(max_pieces, max(1, -(-nbytes // MIN_PIECE_BYTES)))
    return round_up(-(-nbytes // pieces), 16)


def spans(total: int, per_call: int):
    """[lo, hi) ranges of at most ``per_call`` covering ``total``."""
    for lo in range(0, total, per_call):
        yield lo, min(total, lo + per_call)


def check_operand(ctx, x: torch.Tensor, what: str, dtypes=None) -> None:
    """What a CUDA collective takes: a contiguous, non-empty tensor on
    ``ctx``'s card, of one of ``dtypes`` (any when None). Any address will
    do: the kernels move 16-byte words where the addresses allow, else
    narrower ones."""
    if x.device != ctx.device:
        raise ValueError(f"{what}: tensor on {x.device}, context on {ctx.device}")
    if dtypes is not None and x.dtype not in dtypes:
        raise ValueError(f"{what} takes {', '.join(str(d) for d in dtypes)}, got {x.dtype}")
    if not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"{what} needs a contiguous, non-empty tensor")


def all_gather_reference(ctx, shard: torch.Tensor) -> torch.Tensor:
    """Plain version of row 20's kernels: the gather of ``runtime/mesh.py``,
    (world, *shard.shape) in rank order."""
    return mesh.all_gather(ctx, shard.reshape(1, *shard.shape), 0)


def _gather_kernel(ctx, shard: torch.Tensor, ring: bool, what: str) -> torch.Tensor:
    check_operand(ctx, shard, what)
    heap, w = ctx.heap, ctx.world
    out = torch.empty((w, *shard.shape), dtype=shard.dtype, device=shard.device)
    nbytes = shard.numel() * shard.element_size()
    per_call = (WS_BYTES // w) // ALIGN * ALIGN
    lib = collectives_library()
    for lo, hi in spans(nbytes, per_call):
        piece = piece_bytes(hi - lo, RING_BLOCKS if ring else MAX_SLOTS)
        epoch = heap.next_epoch()
        code = lib.tdt_all_gather(*heap.args(epoch), _P(shard.data_ptr() + lo), _P(out.data_ptr() + lo), nbytes,
                                  hi - lo, piece, int(ring), _U64(heap.ws_off[epoch % 2]), round_up(hi - lo, ALIGN),
                                  _U64(heap.flags_off[epoch % 2]), _build.stream_ptr(shard.device))
        _build.check(lib, code, what)
    return out


def ring_ag_call(ctx, shard: torch.Tensor) -> torch.Tensor:
    """Row 20, ring: (world, *shard.shape), every rank's shard forwarded
    around the ring in world - 1 steps. CUDA tensors launch the kernel (a
    shard larger than the workspace allows goes in several calls); CPU
    tensors run ``all_gather_reference``."""
    if shard.device.type == "cpu":
        return all_gather_reference(ctx, shard)
    out = _gather_kernel(ctx, shard, True, "ring_ag_call")
    ring_ag_call.launches += 1
    return out


#: Kernel launches so far (CUDA calls only).
ring_ag_call.launches = 0


def full_mesh_ag_call(ctx, shard: torch.Tensor) -> torch.Tensor:
    """Row 20, full mesh: (world, *shard.shape), every rank pushing its shard
    to every peer; the direct entry to the kernel, as JAX's (no AUTO, no
    world-1 shortcut). CUDA tensors launch it; CPU tensors run
    ``all_gather_reference``."""
    if shard.device.type == "cpu":
        return all_gather_reference(ctx, shard)
    out = _gather_kernel(ctx, shard, False, "full_mesh_ag_call")
    full_mesh_ag_call.launches += 1
    return out


#: Kernel launches so far (CUDA calls only).
full_mesh_ag_call.launches = 0


def all_gather_shard(ctx, shard: torch.Tensor, *,
                     method: AllGatherMethod = AllGatherMethod.AUTO) -> torch.Tensor:
    """All-gather this rank's ``shard`` → (world, *shard.shape), rank order."""
    world = 1 if ctx is None else ctx.world
    if world == 1:
        return shard.reshape(1, *shard.shape)
    if method is AllGatherMethod.AUTO:
        method = get_auto_all_gather_method(shard.numel() * shard.element_size(), world)
    if method is AllGatherMethod.RING_1D:
        return ring_ag_call(ctx, shard)
    if method is AllGatherMethod.FULL_MESH_PUSH:
        return full_mesh_ag_call(ctx, shard)
    return all_gather_reference(ctx, shard)


def all_gather(ctx, x: torch.Tensor, method: AllGatherMethod = AllGatherMethod.AUTO) -> torch.Tensor:
    """Host op: this rank's rows x (m, ...) → every rank's rows concatenated
    (world·m, ...), the same on every rank (JAX ``all_gather``: x sharded on
    dim 0 in, replicated out)."""
    out = all_gather_shard(ctx, x, method=method)
    return out.reshape(-1, *x.shape[1:])


def all_gather_2d_shard(ctx, x: torch.Tensor, *, axes, method: AllGatherMethod = AllGatherMethod.AUTO):
    """The hierarchical gather over a two-axis mesh: not ported yet."""
    raise NotImplementedError("all_gather_2d_shard over a two-axis mesh is not ported yet (ROADMAP queue 1, "
                              "item D1's second half)")


def all_gather_cost(shard_bytes: int, world: int) -> tuple[int, int, int]:
    """(FLOPs, HBM bytes, NVLink bytes) of one rank's call: the shard read
    once, the (world, ...) output written once; the other ranks' shards
    cross NVLink once."""
    return 0, shard_bytes * (1 + world), shard_bytes * (world - 1)

"""Reduce-scatter over the ranks: counterpart of
``triton_dist_tpu/kernels/reduce_scatter.py`` (``reduce_scatter_shard``, the
host op ``reduce_scatter``).

``reduce_scatter_shard(ctx, x)`` takes this rank's partials x (world·c, ...)
and returns its chunk (c, ...) of the sum over the ranks. ``use_xla`` runs
``psum_scatter`` of ``runtime/mesh.py`` (rank order); otherwise row 21,
``ring_rs_call``: on CUDA tensors the ring kernel of ``csrc/collectives.cu``,
on CPU tensors its plain version. Both reproduce the TPU kernel's order:
chunk c starts at rank c + 1 and ends at rank c, every hop adding in fp32
and rounding to x's dtype (``reduce_scatter.py:140-141``), so a bf16 result
is not ``psum_scatter``'s.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.allgather import (
    _P,
    _U64,
    RING_BLOCKS,
    check_operand,
    collectives_library,
    piece_bytes,
    round_up,
    spans,
)
from triton_dist_tpu_torch.runtime import mesh
from triton_dist_tpu_torch.shmem.symm import ALIGN, WS_BYTES

DTYPES = (torch.float32, torch.bfloat16)


def _chunks(ctx, x: torch.Tensor) -> int:
    if x.dim() == 0 or x.shape[0] % ctx.world:
        raise ValueError(f"reduce-scatter splits dim 0 of {tuple(x.shape)} over {ctx.world} ranks: not divisible")
    return x.shape[0] // ctx.world


def ring_rs_reference(ctx, x: torch.Tensor) -> torch.Tensor:
    """Plain version of row 21: every rank's partials gathered, then this
    rank's chunk summed in the ring's order (ranks me + 1, me + 2, ..., me),
    in fp32 and rounded to x's dtype after every hop."""
    w, me = ctx.world, ctx.rank
    c = _chunks(ctx, x)
    parts = mesh.all_gather(ctx, x.reshape(1, *x.shape), 0)
    mine = [p[me * c:(me + 1) * c] for p in parts]
    acc = mine[(me + 1) % w]
    for k in range(2, w + 1):
        acc = (acc.float() + mine[(me + k) % w].float()).to(x.dtype)
    return acc.clone()


def ring_rs_call(ctx, x: torch.Tensor) -> torch.Tensor:
    """Row 21: this rank's chunk (c, ...) of the sum of every rank's x
    (world·c, ...), fp32 or bf16, in the ring's order with a rounding after
    every hop. CUDA tensors launch the kernel (a chunk larger than the
    workspace allows goes in several calls, the same order in each); CPU
    tensors run ``ring_rs_reference``."""
    if x.device.type == "cpu":
        return ring_rs_reference(ctx, x)
    check_operand(ctx, x, "ring_rs_call", DTYPES)
    c = _chunks(ctx, x)
    heap, w = ctx.heap, ctx.world
    out = torch.empty((c, *x.shape[1:]), dtype=x.dtype, device=x.device)
    count, elem = out.numel(), x.element_size()
    per_call = (WS_BYTES // (w - 1)) // ALIGN * ALIGN // elem
    lib = collectives_library()
    for lo, hi in spans(count, per_call):
        piece = piece_bytes((hi - lo) * elem, RING_BLOCKS) // elem
        epoch = heap.next_epoch()
        code = lib.tdt_ring_reduce_scatter(
            *heap.args(epoch), _P(x.data_ptr() + lo * elem), count, _P(out.data_ptr() + lo * elem), hi - lo, piece,
            int(x.dtype == torch.bfloat16), _U64(heap.ws_off[epoch % 2]), round_up((hi - lo) * elem, ALIGN),
            _U64(heap.flags_off[epoch % 2]), _build.stream_ptr(x.device))
        _build.check(lib, code, "ring_rs_call")
    ring_rs_call.launches += 1
    return out


#: Kernel launches so far (CUDA calls only).
ring_rs_call.launches = 0


def reduce_scatter_shard(ctx, x: torch.Tensor, *, use_xla: bool = False) -> torch.Tensor:
    """This rank's chunk of the sum of every rank's partials x (world·c, ...)."""
    if ctx is None or ctx.world == 1:
        return x
    if use_xla:
        return mesh.psum_scatter(ctx, x)
    return ring_rs_call(ctx, x)


def reduce_scatter(ctx, x: torch.Tensor, *, use_xla: bool = False) -> torch.Tensor:
    """Host op: this rank's partial sums x (world·c, ...) → its chunk (c, ...)
    of the sum (JAX ``reduce_scatter``, whose result is the chunks
    concatenated over the ranks)."""
    return reduce_scatter_shard(ctx, x, use_xla=use_xla)


def reduce_scatter_cost(nbytes: int, world: int, itemsize: int) -> tuple[int, int, int]:
    """(FLOPs, HBM bytes, NVLink bytes) of one rank's call on ``nbytes`` of
    partials: world - 1 adds an element of the chunk, every partial read
    once, the chunk written once; world - 1 chunk-sized running sums cross
    NVLink."""
    chunk = nbytes // world
    return (world - 1) * chunk // itemsize, nbytes + chunk, (world - 1) * chunk

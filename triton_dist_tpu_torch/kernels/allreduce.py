"""All-reduce over the ranks: counterpart of ``triton_dist_tpu/kernels/allreduce.py``
(``AllReduceMethod``, ``get_auto_all_reduce_method``, ``all_reduce_shard``,
``one_shot_ar_call``, the host op ``all_reduce``).

``all_reduce_shard(ctx, x)`` returns the sum of every rank's x on every
rank. ``XLA`` (and world 1) is ``psum`` of ``runtime/mesh.py`` (rank order);
``ONE_SHOT`` is row 22, ``one_shot_ar_call``: on CUDA tensors the kernel of
``csrc/collectives.cu``, on CPU tensors its plain version, both adding the
ranks' x in fp32 from zero in rank order and casting once, so every rank
holds the same bits; ``TWO_SHOT`` is the ring reduce-scatter (row 21) then
the ring all-gather (row 20), and a leading dimension that does not split
over the ranks falls back to one-shot (``allreduce.py:203-205``). Two-shot
rounds after every hop, so its bits are not one-shot's.

AUTO keeps JAX's shape-only default: a message of at most
``DEFAULT_AR_CROSSOVER_BYTES`` takes one-shot, a larger one two-shot. The
tune cache (``agreed_cfg_value``) is not ported, so every rank routes alike
by construction.
"""

from __future__ import annotations

import enum

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.allgather import (
    _P,
    _U64,
    AllGatherMethod,
    all_gather_shard,
    check_operand,
    collectives_library,
    piece_bytes,
    round_up,
    spans,
)
from triton_dist_tpu_torch.kernels.reduce_scatter import DTYPES, reduce_scatter_shard
from triton_dist_tpu_torch.runtime import mesh
from triton_dist_tpu_torch.shmem.symm import ALIGN, MAX_SLOTS, WS_BYTES


class AllReduceMethod(enum.Enum):
    AUTO = "auto"
    ONE_SHOT = "one_shot"
    TWO_SHOT = "two_shot"
    XLA = "xla"


#: Bytes at or below which AUTO takes one-shot (``allreduce.py:52``).
DEFAULT_AR_CROSSOVER_BYTES = 256 * 1024


def get_auto_all_reduce_method(nbytes: int, world: int) -> AllReduceMethod:
    """Latency-bound small messages take one-shot, larger ones two-shot
    (JAX ``get_auto_all_reduce_method`` with its static crossover)."""
    return AllReduceMethod.ONE_SHOT if nbytes <= DEFAULT_AR_CROSSOVER_BYTES else AllReduceMethod.TWO_SHOT


def one_shot_ar_reference(ctx, x: torch.Tensor) -> torch.Tensor:
    """Plain version of row 22: every rank's x gathered, added in fp32 from
    zero in rank order, cast once."""
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for part in mesh.all_gather(ctx, x.reshape(1, *x.shape), 0):
        acc += part.float()
    return acc.to(x.dtype)


def one_shot_ar_call(ctx, x: torch.Tensor) -> torch.Tensor:
    """Row 22: the sum of every rank's x (fp32 or bf16, any shape), the same
    bits on every rank; the direct entry to the kernel, as JAX's (no AUTO,
    no world-1 shortcut). CUDA tensors launch it (a message whose landing
    slots exceed the workspace goes in several calls); CPU tensors run
    ``one_shot_ar_reference``."""
    if x.device.type == "cpu":
        return one_shot_ar_reference(ctx, x)
    check_operand(ctx, x, "one_shot_ar_call", DTYPES)
    heap, w = ctx.heap, ctx.world
    out = torch.empty_like(x)
    count, elem = x.numel(), x.element_size()
    per_call = (WS_BYTES // w) // ALIGN * ALIGN // elem
    lib = collectives_library()
    for lo, hi in spans(count, per_call):
        piece = piece_bytes((hi - lo) * elem, MAX_SLOTS) // elem
        epoch = heap.next_epoch()
        code = lib.tdt_one_shot_all_reduce(
            *heap.args(epoch), _P(x.data_ptr() + lo * elem), _P(out.data_ptr() + lo * elem), hi - lo, piece,
            int(x.dtype == torch.bfloat16), _U64(heap.ws_off[epoch % 2]), round_up((hi - lo) * elem, ALIGN),
            _U64(heap.flags_off[epoch % 2]), _build.stream_ptr(x.device))
        _build.check(lib, code, "one_shot_ar_call")
    one_shot_ar_call.launches += 1
    return out


#: Kernel launches so far (CUDA calls only).
one_shot_ar_call.launches = 0


def all_reduce_shard(ctx, x: torch.Tensor, *, method: AllReduceMethod = AllReduceMethod.AUTO) -> torch.Tensor:
    """The sum of every rank's x, on every rank."""
    world = 1 if ctx is None else ctx.world
    if method is AllReduceMethod.AUTO:
        method = get_auto_all_reduce_method(x.numel() * x.element_size(), world)
    if method is AllReduceMethod.XLA or world == 1:
        return x if world == 1 else mesh.psum(ctx, x)
    if method is AllReduceMethod.TWO_SHOT and x.shape[0] % world == 0:
        scattered = reduce_scatter_shard(ctx, x)
        return all_gather_shard(ctx, scattered, method=AllGatherMethod.RING_1D).reshape(x.shape)
    return one_shot_ar_call(ctx, x)


def all_reduce(ctx, x: torch.Tensor, method: AllReduceMethod = AllReduceMethod.AUTO) -> torch.Tensor:
    """Host op: the sum of every rank's x, replicated (JAX ``all_reduce``)."""
    return all_reduce_shard(ctx, x, method=method)


def one_shot_ar_cost(nbytes: int, world: int, itemsize: int) -> tuple[int, int, int]:
    """(FLOPs, HBM bytes, NVLink bytes) of one rank's call: world adds an
    element, x read once and the sum written once; x crosses NVLink to each
    of the world - 1 peers."""
    return world * nbytes // itemsize, 2 * nbytes, (world - 1) * nbytes

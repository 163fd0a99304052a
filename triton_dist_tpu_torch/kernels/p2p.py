"""Point-to-point one-sided transfers, the pipeline-parallel transport:
counterpart of ``triton_dist_tpu/kernels/p2p.py`` (``p2p_put_shard`` with
its gradient, ``p2p_send_recv``).

``p2p_put_shard(ctx, x, axis, offset)`` gives rank r of ``axis`` the ``x``
of rank ``(r - offset) mod S``: a ring shift, the stage handoff. Its
transport, as in JAX: row 23, ``p2p_kernel`` (on CUDA tensors the
hand-written kernel of ``csrc/p2p.cu``, on the heap of the axis's group; its
header says what bounds it and how the design answers it; on CPU tensors
its plain version), or with ``use_xla`` the plain collective
``mesh.ppermute`` (JAX's collective-permute route) on any device. The shift
is differentiable: the gradient of a shift by ``offset`` is the shift by
``-offset`` (JAX's custom VJP, ``p2p.py:54-76``), so gradients ride the
reverse ring on the same transport.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.allgather import check_operand, piece_bytes, spans
from triton_dist_tpu_torch.kernels.common_ops import barrier_all_on_device
from triton_dist_tpu_torch.kernels.ep_a2a import SHMEM_ARGTYPES
from triton_dist_tpu_torch.runtime import mesh
from triton_dist_tpu_torch.shmem.symm import WS_BYTES

_U64, _SZ, _P, _I = ctypes.c_uint64, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"tdt_p2p": SHMEM_ARGTYPES + [_P, _P, _SZ, _SZ, _I, _I, _U64, _U64, _P]}
#: Most blocks of a launch (each moves a piece of at least 16 KiB): few
#: enough that every block of every rank is resident at once.
BLOCKS = 128


def _library():
    return _build.load("p2p", _SIGNATURES)


def p2p_reference(ctx, x: torch.Tensor, offset: int = 1) -> torch.Tensor:
    """Plain version of row 23 on the one-axis context ``ctx``: the x of
    rank ``(rank - offset) mod world``, through ``mesh.ppermute``."""
    return mesh.ppermute(ctx, x, offset)


def p2p_kernel(ctx, x: torch.Tensor, offset: int = 1) -> torch.Tensor:
    """Row 23 on the one-axis context ``ctx`` (an axis of a mesh, or a whole
    group): the x of rank ``(rank - offset) mod world``, bit for bit. A CUDA
    tensor (contiguous, non-empty, any dtype) launches the kernel once for
    each ``WS_BYTES`` of it (one workspace half, with an epoch of its own),
    and above two ranks a device barrier after each launch (``csrc/p2p.cu``
    says why); CPU tensors run ``p2p_reference``."""
    if x.device.type == "cpu":
        return p2p_reference(ctx, x, offset)
    check_operand(ctx, x, "p2p_kernel")
    heap, w, me = ctx.heap, ctx.world, ctx.rank
    nbytes = x.numel() * x.element_size()
    out = torch.empty_like(x)
    lib = _library()
    for lo, hi in spans(nbytes, WS_BYTES):
        epoch = heap.next_epoch()
        code = lib.tdt_p2p(*heap.args(epoch), _P(x.data_ptr() + lo), _P(out.data_ptr() + lo), hi - lo,
                           piece_bytes(hi - lo, BLOCKS), (me + offset) % w, (me - offset) % w,
                           _U64(heap.ws_off[epoch % 2]), _U64(heap.flags_off[epoch % 2]),
                           _build.stream_ptr(x.device))
        _build.check(lib, code, "p2p_kernel")
        p2p_kernel.launches += 1
        if w > 2:
            barrier_all_on_device(ctx)
    return out


#: Kernel launches so far (CUDA calls only; one a ``WS_BYTES`` piece).
p2p_kernel.launches = 0


def _shift(ctx, x: torch.Tensor, offset: int, use_xla: bool) -> torch.Tensor:
    if use_xla or ctx.world == 1:
        return mesh.ppermute(ctx, x, offset)
    return p2p_kernel(ctx, x.contiguous(), offset)


class _Shift(torch.autograd.Function):
    """The ring shift with its transpose as the gradient."""

    @staticmethod
    def forward(fctx, x, ctx, offset, use_xla):
        fctx.ctx, fctx.offset, fctx.use_xla = ctx, offset, use_xla
        return _shift(ctx, x, offset, use_xla)

    @staticmethod
    def backward(fctx, g):
        return _shift(fctx.ctx, g.contiguous(), -fctx.offset, fctx.use_xla), None, None, None


def p2p_put_shard(ctx, x: torch.Tensor, axis: str = "pp", offset: int = 1, use_xla: bool = False) -> torch.Tensor:
    """Shift ``x`` by ``offset`` along the ring of ``axis`` of ``ctx``
    (``runtime.mesh.DistContext``): rank r's result is rank ``r - offset``'s
    input. Every rank of the axis calls it with one shape and dtype. The
    one-sided kernel (the plain collective with ``use_xla``, or on an axis
    of one rank); differentiable, the gradient riding the shift by
    ``-offset``."""
    return _Shift.apply(x, ctx.axis(axis), int(offset), bool(use_xla))


def p2p_send_recv(ctx, x: torch.Tensor, *, axis: str = "pp", offset: int = 1,
                  use_xla: bool | None = None) -> torch.Tensor:
    """Host op: shift this rank's ``x`` by ``offset`` stages along ``axis``
    (JAX's takes the array sharded over ``axis`` and returns it so; here
    every rank passes and gets its own shard). ``use_xla`` None routes by
    device, as JAX by platform: the kernel on CUDA tensors, the plain
    collective on CPU tensors."""
    return p2p_put_shard(ctx, x, axis, offset, bool(use_xla))


def p2p_cost(nbytes: int) -> tuple[int, int, int]:
    """(FLOPs, HBM bytes, NVLink bytes) of one rank's call: x read once and
    out written once on this card, x pushed across NVLink once."""
    return 0, 2 * nbytes, nbytes

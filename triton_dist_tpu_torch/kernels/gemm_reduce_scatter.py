"""GEMM-RS: the GEMM whose partial sums are reduce-scattered over the ranks.
Counterpart of ``triton_dist_tpu/kernels/gemm_reduce_scatter.py``
(``GemmRSMethod``, ``get_auto_gemm_rs_method``, ``gemm_rs_shard``).

``gemm_rs_shard(ctx, a, b)`` returns this rank's ``(m / world, n)`` row chunk
of ``sum over ranks of a_r @ b_r`` in a's dtype, with fp32 partials added in
rank order. At world 1 it is a plain product. ``XLA`` and ``XLA_RING`` run
``psum_scatter`` of ``runtime/mesh.py`` on the fp32 partial (the ring's sum
is taken in rank order here); ``PALLAS_FUSED`` runs ``gemm_rs_fused``: the
kernel of ``csrc/collective_gemm.cu`` on CUDA tensors, its plain version on
CPU tensors. ``PALLAS`` (a Pallas GEMM, then the ring reduce-scatter kernel
of row 21) needs the GEMM of row 7 and raises.

``a`` may be a ``QuantTensor`` (``models/quant.py``): the output is then in
``b``'s dtype. ``PALLAS_FUSED`` runs ``gemm_rs_fused_quant`` (row 17's
quant form: each A tile dequantized exactly, fp32 partials as before);
the plain routes dequantize A first, as JAX's do.
"""

from __future__ import annotations

import enum

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.allgather_gemm import (
    TILE,
    WIRE_CODES,
    _U64,
    check_operands,
    collective_library,
    dequant,
    dtype_code,
    is_quant,
    workspace_check,
)
from triton_dist_tpu_torch.kernels.group_gemm import matmul_f32
from triton_dist_tpu_torch.runtime import mesh
from triton_dist_tpu_torch.shmem.symm import MAX_SLOTS


class GemmRSMethod(enum.Enum):
    AUTO = "auto"
    XLA_RING = "xla_ring"
    PALLAS_FUSED = "pallas_fused"
    PALLAS = "pallas"
    XLA = "xla"


#: Rows of M at or below which AUTO takes the ring (``gemm_reduce_scatter.py:86``).
DEFAULT_GEMM_RS_CROSSOVER_M = 256
NEEDS_ROW_7 = "GemmRSMethod.PALLAS needs the tiled GEMM kernel (row 7, ROADMAP queue 1 item C4)"


def get_auto_gemm_rs_method(m: int, world: int) -> GemmRSMethod:
    """Ragged or small M take the ring, M above the crossover the fused
    kernel (JAX ``get_auto_gemm_rs_method``)."""
    if m % world != 0 or m <= DEFAULT_GEMM_RS_CROSSOVER_M:
        return GemmRSMethod.XLA_RING
    return GemmRSMethod.PALLAS_FUSED


def tiles_ok(rows: int, n: int) -> bool:
    """At most ``MAX_SLOTS`` signalled 64 x 64 tiles per source."""
    return -(-rows // TILE) * -(-n // TILE) <= MAX_SLOTS


def launch_rs_ar(ctx, a, b, out, bcast_off: int | None, what: str) -> None:
    """``tdt_gemm_rs_ar`` (``tdt_gemm_rs_ar_quant`` for a ``QuantTensor``
    a): the reduce-scatter, and with ``bcast_off`` (the broadcast region's
    offset in this call's workspace) the broadcast and gather of the fused
    GEMM-AR."""
    heap = ctx.heap
    m, k = a.shape
    n = b.shape[1]
    lib = collective_library()
    epoch = heap.next_epoch()
    ws = heap.ws_off[epoch % 2]
    tail = (m, k, n, int(bcast_off is not None), dtype_code(b))
    offs = (_U64(ws), _U64(ws + (bcast_off or 0)), _U64(heap.flags_off[epoch % 2]), _build.stream_ptr(b.device))
    if is_quant(a):
        code = lib.tdt_gemm_rs_ar_quant(*heap.args(epoch), _build.ptr(a.q), _build.ptr(a.scale), _build.ptr(b),
                                        _build.ptr(out), *tail, WIRE_CODES[a.q.dtype], *offs)
    else:
        code = lib.tdt_gemm_rs_ar(*heap.args(epoch), _build.ptr(a), _build.ptr(b), _build.ptr(out), *tail, *offs)
    _build.check(lib, code, what)


def gemm_rs_reference(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of ``gemm_rs_fused``: the fp32 partial, then
    ``psum_scatter`` (rank order), cast once."""
    return mesh.psum_scatter(ctx, matmul_f32(a, b)).to(a.dtype)


def _rs_kernel(ctx, a, b: torch.Tensor, what: str) -> torch.Tensor:
    """The launch of row 17 (a plain A) or 17q (a ``QuantTensor`` A)."""
    check_operands(ctx, a, (b,), what)
    m, n = a.shape[0], b.shape[1]
    if m % ctx.world or not tiles_ok(m // ctx.world, n):
        raise ValueError(f"{what} needs m % world == 0 and at most {MAX_SLOTS} tiles a chunk, got m={m}, n={n}")
    workspace_check(m * n * 4, what)
    out = torch.empty((m // ctx.world, n), dtype=b.dtype, device=b.device)
    launch_rs_ar(ctx, a, b, out, None, what)
    return out


def gemm_rs_fused(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row 17: a (m, k) this rank's columns of A, b (k, n) its rows of B →
    (m / world, n), this rank's rows of the sum. CUDA tensors launch the
    kernel; CPU tensors run ``gemm_rs_reference``."""
    if a.device.type == "cpu":
        return gemm_rs_reference(ctx, a, b)
    out = _rs_kernel(ctx, a, b, "gemm_rs_fused")
    gemm_rs_fused.launches += 1
    return out


#: Kernel launches so far (CUDA calls only).
gemm_rs_fused.launches = 0


def gemm_rs_quant_reference(ctx, a, b: torch.Tensor) -> torch.Tensor:
    """Plain version of ``gemm_rs_fused_quant``: A dequantized into b's
    dtype, then ``gemm_rs_reference``."""
    return gemm_rs_reference(ctx, dequant(a, b.dtype), b)


def gemm_rs_fused_quant(ctx, a, b: torch.Tensor) -> torch.Tensor:
    """Row 17q: ``gemm_rs_fused`` with a quantized A (a ``QuantTensor``),
    each A tile dequantized exactly; out in b's dtype. CUDA tensors launch
    the kernel; CPU tensors run ``gemm_rs_quant_reference``."""
    if a.device.type == "cpu":
        return gemm_rs_quant_reference(ctx, a, b)
    out = _rs_kernel(ctx, a, b, "gemm_rs_fused_quant")
    gemm_rs_fused_quant.launches += 1
    return out


gemm_rs_fused_quant.launches = 0


def gemm_rs_shard(ctx, a, b: torch.Tensor, *, method: GemmRSMethod = GemmRSMethod.AUTO) -> torch.Tensor:
    """``reduce_scatter(a @ b)`` over rows: a (m, k_shard), b (k_shard, n) →
    (m / world, n) in a's dtype (b's for a ``QuantTensor`` a)."""
    quant = is_quant(a)
    if ctx is None or ctx.world == 1:
        return matmul_f32(dequant(a, b.dtype), b).to(b.dtype) if quant else a @ b
    if method is GemmRSMethod.AUTO:
        method = get_auto_gemm_rs_method(a.shape[0], ctx.world)
    if method is GemmRSMethod.PALLAS_FUSED:
        return (gemm_rs_fused_quant if quant else gemm_rs_fused)(ctx, a, b)
    if method is GemmRSMethod.PALLAS:
        raise NotImplementedError(NEEDS_ROW_7)
    return gemm_rs_reference(ctx, dequant(a, b.dtype) if quant else a, b)


def gemm_rs_cost(m: int, k: int, n: int, world: int, itemsize: int,
                 a_row_bytes: int | None = None) -> tuple[int, int, int]:
    """(FLOPs, HBM bytes, NVLink bytes) of one rank's call: a (m, k) @ b
    (k, n); a and b read once, the (m / world, n) output written once; the
    fp32 partials of the other ranks' chunks cross NVLink once.
    ``a_row_bytes``: bytes of one A row when it is not k·itemsize (a
    quantized A: k payload bytes and a 4-byte scale)."""
    flops = 2 * m * k * n
    hbm = m * (k * itemsize if a_row_bytes is None else a_row_bytes) + itemsize * (k * n + m // world * n)
    return flops, hbm, 4 * (world - 1) * (m // world) * n

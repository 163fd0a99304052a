"""GEMM-AR: the GEMM whose partial sums are all-reduced, every rank getting
the whole product. Counterpart of ``triton_dist_tpu/kernels/gemm_allreduce.py``
(``GemmARMethod``, ``get_auto_gemm_ar_method``, ``gemm_ar_shard``).

``gemm_ar_shard(ctx, a, b)`` returns ``sum over ranks of a_r @ b_r`` (m, n) in
a's dtype, the fp32 partials added in rank order, so every rank holds the
same bits. At world 1 it is a plain product. ``XLA`` is ``psum`` of
``runtime/mesh.py`` on the fp32 partial; ``LL_ONE_SHOT`` runs ``gemm_ar_ll``
(row 19: tiny or ragged m, decode) and ``PALLAS_FUSED`` ``gemm_ar_fused``
(row 18: m % world == 0 above the crossover), each the kernel of
``csrc/collective_gemm.cu`` on CUDA tensors and its plain version on CPU
tensors. ``ONE_SHOT`` casts the fp32 partial to a's dtype and all-reduces it
with row 22 (``allreduce.one_shot_ar_call``); ``RS_AG`` reduce-scatters the
fp32 partial in rank order (the ``XLA_RING`` route of ``gemm_rs_shard``) and
gathers the chunks with row 20's ring (``allgather.ring_ag_call``), as JAX
does (``gemm_allreduce.py:771-784``).

``a`` may be a ``QuantTensor`` (``models/quant.py``): the output is then in
``b``'s dtype. ``PALLAS_FUSED`` and ``LL_ONE_SHOT`` run
``gemm_ar_fused_quant`` and ``gemm_ar_ll_quant`` (rows 18 and 19's quant
forms: each A tile dequantized exactly, fp32 partials as before); the other
routes dequantize A first, as JAX's do.
"""

from __future__ import annotations

import enum

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.allgather import AllGatherMethod, all_gather_shard
from triton_dist_tpu_torch.kernels.allgather_gemm import (
    WIRE_CODES,
    _U64,
    check_operands,
    collective_library,
    dequant,
    dtype_code,
    is_quant,
    workspace_check,
)
from triton_dist_tpu_torch.kernels.allreduce import AllReduceMethod, all_reduce_shard
from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import (
    GemmRSMethod,
    gemm_rs_shard,
    launch_rs_ar,
    tiles_ok,
)
from triton_dist_tpu_torch.kernels.group_gemm import matmul_f32
from triton_dist_tpu_torch.runtime import mesh
from triton_dist_tpu_torch.shmem.symm import ALIGN, MAX_SLOTS, WS_BYTES


class GemmARMethod(enum.Enum):
    AUTO = "auto"
    PALLAS_FUSED = "pallas_fused"
    LL_ONE_SHOT = "ll_one_shot"
    RS_AG = "rs_ag"
    ONE_SHOT = "one_shot"
    XLA = "xla"


#: Rows of M at or below which AUTO takes the low-latency kernel
#: (``gemm_allreduce.py:78``).
DEFAULT_GEMM_AR_CROSSOVER_M = 64


def get_auto_gemm_ar_method(m: int, world: int) -> GemmARMethod:
    """Ragged or decode-sized M take the low-latency kernel, larger M the
    fused one (JAX ``get_auto_gemm_ar_method``)."""
    if m % world != 0 or m <= DEFAULT_GEMM_AR_CROSSOVER_M:
        return GemmARMethod.LL_ONE_SHOT
    return GemmARMethod.PALLAS_FUSED


def gemm_ar_reference(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of both kernels: the fp32 partial, ``psum`` (rank
    order), cast once."""
    return mesh.psum(ctx, matmul_f32(a, b)).to(a.dtype)


def _ar_kernel(ctx, a, b: torch.Tensor, what: str) -> torch.Tensor:
    """The launch of row 18 (a plain A) or 18q (a ``QuantTensor`` A)."""
    check_operands(ctx, a, (b,), what)
    m, n = a.shape[0], b.shape[1]
    if m % ctx.world or not tiles_ok(m // ctx.world, n):
        raise ValueError(f"{what} needs m % world == 0 and at most {MAX_SLOTS} tiles a chunk, got m={m}, n={n}")
    partials = -(-m * n * 4 // ALIGN) * ALIGN
    workspace_check(partials + m * n * b.element_size(), what)
    out = torch.empty((m, n), dtype=b.dtype, device=b.device)
    launch_rs_ar(ctx, a, b, out, partials, what)
    return out


def gemm_ar_fused(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row 18: a (m, k), b (k, n), m % world == 0 → (m, n), equal on every
    rank: each rank reduces its m / world rows (rank order) and broadcasts
    them. CUDA tensors launch the kernel; CPU tensors run
    ``gemm_ar_reference``."""
    if a.device.type == "cpu":
        return gemm_ar_reference(ctx, a, b)
    out = _ar_kernel(ctx, a, b, "gemm_ar_fused")
    gemm_ar_fused.launches += 1
    return out


#: Kernel launches so far (CUDA calls only).
gemm_ar_fused.launches = 0


def gemm_ar_quant_reference(ctx, a, b: torch.Tensor) -> torch.Tensor:
    """Plain version of both quant forms: A dequantized into b's dtype, then
    ``gemm_ar_reference``."""
    return gemm_ar_reference(ctx, dequant(a, b.dtype), b)


def gemm_ar_fused_quant(ctx, a, b: torch.Tensor) -> torch.Tensor:
    """Row 18q: ``gemm_ar_fused`` with a quantized A (a ``QuantTensor``),
    each A tile dequantized exactly; out in b's dtype, the same bits on
    every rank. CUDA tensors launch the kernel; CPU tensors run
    ``gemm_ar_quant_reference``."""
    if a.device.type == "cpu":
        return gemm_ar_quant_reference(ctx, a, b)
    out = _ar_kernel(ctx, a, b, "gemm_ar_fused_quant")
    gemm_ar_fused_quant.launches += 1
    return out


gemm_ar_fused_quant.launches = 0


def _ll_kernel(ctx, a, b: torch.Tensor, what: str) -> torch.Tensor:
    """The launches of row 19 (a plain A) or 19q (a ``QuantTensor`` A):
    rows past the workspace go in further calls."""
    check_operands(ctx, a, (b,), what)
    m, k = a.shape
    n = b.shape[1]
    heap = ctx.heap
    rows = min(WS_BYTES // (ctx.world * n * 4), (MAX_SLOTS // -(-n // 64)) * 64)
    if rows < 1:
        raise ValueError(f"{what}: one row of n={n} exceeds the workspace")
    out = torch.empty((m, n), dtype=b.dtype, device=b.device)
    lib = collective_library()
    for lo in range(0, m, rows):
        hi = min(m, lo + rows)
        epoch = heap.next_epoch()
        tail = (hi - lo, k, n, dtype_code(b))
        offs = (_U64(heap.ws_off[epoch % 2]), _U64(heap.flags_off[epoch % 2]), _build.stream_ptr(b.device))
        if is_quant(a):
            code = lib.tdt_gemm_ar_ll_quant(*heap.args(epoch), _build.ptr(a.q[lo:hi]), _build.ptr(a.scale[lo:hi]),
                                            _build.ptr(b), _build.ptr(out[lo:hi]), *tail, WIRE_CODES[a.q.dtype],
                                            *offs)
        else:
            code = lib.tdt_gemm_ar_ll(*heap.args(epoch), _build.ptr(a[lo:hi]), _build.ptr(b), _build.ptr(out[lo:hi]),
                                      *tail, *offs)
        _build.check(lib, code, what)
    return out


def gemm_ar_ll(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row 19: a (m, k), b (k, n), any m → (m, n), equal on every rank: each
    rank pushes its fp32 partial to every rank, and every rank adds the
    world partials in rank order. Rows past the workspace go in further
    calls. CUDA tensors launch the kernel; CPU tensors run
    ``gemm_ar_reference``."""
    if a.device.type == "cpu":
        return gemm_ar_reference(ctx, a, b)
    out = _ll_kernel(ctx, a, b, "gemm_ar_ll")
    gemm_ar_ll.launches += 1
    return out


#: Kernel launches so far (CUDA calls only).
gemm_ar_ll.launches = 0


def gemm_ar_ll_quant(ctx, a, b: torch.Tensor) -> torch.Tensor:
    """Row 19q: ``gemm_ar_ll`` with a quantized A (a ``QuantTensor``), each
    A tile dequantized exactly; out in b's dtype, the same bits on every
    rank. CUDA tensors launch the kernel; CPU tensors run
    ``gemm_ar_quant_reference``."""
    if a.device.type == "cpu":
        return gemm_ar_quant_reference(ctx, a, b)
    out = _ll_kernel(ctx, a, b, "gemm_ar_ll_quant")
    gemm_ar_ll_quant.launches += 1
    return out


gemm_ar_ll_quant.launches = 0


def gemm_ar_shard(ctx, a, b: torch.Tensor, *, method: GemmARMethod = GemmARMethod.AUTO) -> torch.Tensor:
    """``all_reduce(a @ b)``: a (m, k_shard), b (k_shard, n) → (m, n) in a's
    dtype (b's for a ``QuantTensor`` a), the same on every rank."""
    quant = is_quant(a)
    if ctx is None or ctx.world == 1:
        return matmul_f32(dequant(a, b.dtype), b).to(b.dtype) if quant else a @ b
    if method is GemmARMethod.AUTO:
        method = get_auto_gemm_ar_method(a.shape[0], ctx.world)
    if method is GemmARMethod.LL_ONE_SHOT:
        return (gemm_ar_ll_quant if quant else gemm_ar_ll)(ctx, a, b)
    if method is GemmARMethod.PALLAS_FUSED:
        return (gemm_ar_fused_quant if quant else gemm_ar_fused)(ctx, a, b)
    if quant:
        a = dequant(a, b.dtype)
    if method is GemmARMethod.ONE_SHOT:
        return all_reduce_shard(ctx, matmul_f32(a, b).to(a.dtype), method=AllReduceMethod.ONE_SHOT)
    if method is GemmARMethod.RS_AG:
        scattered = gemm_rs_shard(ctx, a, b, method=GemmRSMethod.XLA_RING)
        return all_gather_shard(ctx, scattered, method=AllGatherMethod.RING_1D).reshape(a.shape[0], b.shape[1])
    return gemm_ar_reference(ctx, a, b)


def gemm_ar_cost(m: int, k: int, n: int, world: int, itemsize: int, *, ll: bool,
                 a_row_bytes: int | None = None) -> tuple[int, int, int]:
    """(FLOPs, HBM bytes, NVLink bytes) of one rank's call: a (m, k) @ b
    (k, n); a and b read once, the (m, n) output written once. Over NVLink
    the low-latency kernel sends its whole fp32 partial to each peer; the
    fused one sends each owner its fp32 chunk and each owner broadcasts its
    rounded chunk. ``a_row_bytes``: bytes of one A row when it is not
    k·itemsize (a quantized A: k payload bytes and a 4-byte scale)."""
    flops = 2 * m * k * n
    hbm = m * (k * itemsize if a_row_bytes is None else a_row_bytes) + itemsize * (k * n + m * n)
    if ll:
        link = 4 * (world - 1) * m * n
    else:
        link = (world - 1) * (m // world) * n * (4 + itemsize)
    return flops, hbm, link

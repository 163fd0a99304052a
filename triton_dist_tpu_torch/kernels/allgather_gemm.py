"""AG-GEMM: all-gather of the A shards fused with the GEMM. Counterpart of
``triton_dist_tpu/kernels/allgather_gemm.py`` (``AGGemmMethod``,
``get_auto_ag_gemm_method``, ``ring_ag_chunks``, ``ag_gemm_shard``,
``ag_gemm_swiglu_shard``).

``ag_gemm_shard(ctx, a, b)`` returns ``all_gather(a) @ b`` (rows of every
rank's shard in rank order), ``ag_gemm_swiglu_shard`` the SwiGLU pair
``silu(AG(x) @ w_gate) * (AG(x) @ w_up)``; both in a's dtype, accumulated in
fp32. At world 1 they are a plain product. ``XLA_RING`` and
``XLA_AG_THEN_GEMM`` run the plain collectives of ``runtime/mesh.py``;
``PALLAS_FUSED`` runs ``ag_gemm_fused``: on CUDA tensors the hand-written
kernel of ``csrc/collective_gemm.cu`` (its header says what bounds it on the
H100 and how the design answers it), on CPU tensors its plain version. The
gathered A is not returned (JAX's ``TP_Attn.prefill`` drops it).

AUTO routing keeps JAX's shape-only rule and its default crossover (the
tune cache is not ported, so every rank agrees by construction). JAX's VMEM
fit (``_fused_tiles``) becomes the kernel's own shape condition
(``fused_shape_ok``).

``a`` (``x``) may be a ``QuantTensor`` (``models/quant.py``): the output is
then in ``b``'s dtype. ``XLA_AG_THEN_GEMM`` gathers payload and scales and
dequantizes; ``XLA_RING`` dequantizes each chunk before its product;
``PALLAS_FUSED`` runs ``ag_gemm_fused_quant`` (row 16's quant form: the
1-byte payload and the scales on the wire, each tile dequantized exactly).
AUTO routes a quantized operand as an unquantized one of ``b``'s dtype
(JAX's ``|wire=`` tune entries default to the same crossover).
"""

from __future__ import annotations

import ctypes
import enum

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.group_gemm import matmul_f32
from triton_dist_tpu_torch.runtime import mesh
from triton_dist_tpu_torch.shmem.symm import ALIGN, MAX_SLOTS, WS_BYTES


class AGGemmMethod(enum.Enum):
    AUTO = "auto"
    XLA_RING = "xla_ring"
    PALLAS_FUSED = "pallas_fused"
    XLA_AG_THEN_GEMM = "xla_ag_then_gemm"


#: Rows of the local M shard at or below which AUTO takes the ring
#: (``allgather_gemm.py:196``).
DEFAULT_AG_GEMM_CROSSOVER_M = 32

_U64 = ctypes.c_uint64
_SHMEM_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, _U64, _U64]
_SIGNATURES = {
    "tdt_ag_gemm": _SHMEM_ARGS + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [_U64, _U64, ctypes.c_void_p],
    "tdt_ag_gemm_quant": _SHMEM_ARGS + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [_U64, _U64, _U64,
                                                                                   ctypes.c_void_p],
    "tdt_gemm_rs_ar_quant": _SHMEM_ARGS + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [_U64, _U64, _U64,
                                                                                      ctypes.c_void_p],
    "tdt_gemm_ar_ll_quant": _SHMEM_ARGS + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [_U64, _U64,
                                                                                      ctypes.c_void_p],
    "tdt_gemm_rs_ar": _SHMEM_ARGS + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [_U64, _U64, _U64,
                                                                                 ctypes.c_void_p],
    "tdt_gemm_ar_ll": _SHMEM_ARGS + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [_U64, _U64, ctypes.c_void_p],
}
TILE = 64


def collective_library():
    """The loaded ``csrc/collective_gemm.cu`` (rows 16-19)."""
    return _build.load("collective_gemm", _SIGNATURES)


def fused_shape_ok(k: int, n: int, dtype: torch.dtype) -> bool:
    """Shapes the collective-matmul kernels take: fp32 or bf16, k and n
    multiples of 8 (their tiles move 16-byte rows)."""
    return dtype in (torch.float32, torch.bfloat16) and k % 8 == 0 and n % 8 == 0


def get_auto_ag_gemm_method(m_shard: int, k: int, n: int, dtype, world: int) -> AGGemmMethod:
    """Decode-sized shards take the ring, prefill-sized ones above the
    crossover the fused kernel; shapes the kernel does not take, the ring
    (JAX ``get_auto_ag_gemm_method``)."""
    if not fused_shape_ok(k, n, dtype) or m_shard <= DEFAULT_AG_GEMM_CROSSOVER_M:
        return AGGemmMethod.XLA_RING
    return AGGemmMethod.PALLAS_FUSED


def check_operands(ctx, a, bs: tuple, what: str) -> None:
    """What a CUDA collective-matmul kernel takes: tensors on ``ctx``'s card,
    one dtype (fp32 or bf16), contiguous, 16-byte aligned, 2-D shapes that
    fit (a (m, k), each b (k, n)), k and n multiples of 8. A quantized A
    (a ``QuantTensor``) holds an int8 or float8_e4m3fn payload with
    contiguous (m, 1) f32 scales; the weights' dtype is then the one."""
    quant = is_quant(a)
    ts = (a.q, *bs) if quant else (a, *bs)
    dt = bs[0].dtype if quant else a.dtype
    for t in ts:
        if t.device != ctx.device:
            raise ValueError(f"{what}: tensor on {t.device}, context on {ctx.device}")
        if t.dtype != dt and not (quant and t is a.q):
            raise ValueError(f"{what}: operands of dtypes {dt} and {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} needs contiguous, 16-byte aligned 2-D operands")
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} takes fp32 or bf16, got {dt}")
    if quant and (a.q.dtype not in WIRE_CODES or a.scale.dtype != torch.float32 or a.scale.device != ctx.device
                  or a.scale.shape != (a.shape[0], 1) or not a.scale.is_contiguous()):
        raise ValueError(f"{what}: a quantized A holds int8 or float8_e4m3fn with contiguous (m, 1) f32 scales, "
                         f"got {a.q.dtype} with {a.scale.dtype} {tuple(a.scale.shape)} on {a.scale.device}")
    k, n = bs[0].shape
    if a.shape[1] != k or any(b.shape != bs[0].shape for b in bs):
        raise ValueError(f"{what}: shapes a {tuple(a.shape)}, b {[tuple(b.shape) for b in bs]} do not fit")
    if k % 8 or n % 8:
        raise ValueError(f"{what} needs k and n multiples of 8, got k={k}, n={n}")


def workspace_check(nbytes: int, what: str) -> None:
    if nbytes > WS_BYTES:
        raise ValueError(f"{what} needs {nbytes} workspace bytes; the symmetric heap has {WS_BYTES} "
                         "(shmem/symm.py WS_BYTES)")


def dtype_code(t: torch.Tensor) -> int:
    return 1 if t.dtype == torch.bfloat16 else 0


# ------------------------------------------------------------ quantized A

#: The kernels' wire codes of a quantized A's payload dtype.
WIRE_CODES = {torch.int8: 0, torch.float8_e4m3fn: 1}


def is_quant(a) -> bool:
    """True when ``a`` is a ``models.quant.QuantTensor``."""
    from triton_dist_tpu_torch.models.quant import QuantTensor

    return isinstance(a, QuantTensor)


def dequant(a, dtype: torch.dtype) -> torch.Tensor:
    """A quantized operand dequantized into ``dtype`` (exact: power-of-two
    row scales), JAX's ``_dequant_chunk``."""
    from triton_dist_tpu_torch.models.quant import dequantize_tensor

    return dequantize_tensor(a, dtype)


def gather_quant(ctx, a):
    """``all_gather`` of a quantized shard: (payload (world·m, k), scales
    (world·m, 1)); the payload moves as bytes."""
    from triton_dist_tpu_torch.models.quant import QuantTensor

    q = mesh.all_gather(ctx, a.q.view(torch.uint8), 0).view(a.q.dtype)
    return QuantTensor(q, mesh.all_gather(ctx, a.scale, 0), a.wire)


def _swiglu(g: torch.Tensor, u: torch.Tensor, dtype) -> torch.Tensor:
    return (torch.nn.functional.silu(g) * u).to(dtype)


def _products(g: torch.Tensor, bs: tuple) -> torch.Tensor:
    """The gathered A's fp32 product with ``bs = (b,)``, or the SwiGLU pair,
    cast once to g's dtype."""
    if len(bs) == 1:
        return matmul_f32(g, bs[0]).to(g.dtype)
    return _swiglu(matmul_f32(g, bs[0]), matmul_f32(g, bs[1]), g.dtype)


def ag_gemm_reference(ctx, a: torch.Tensor, bs: tuple) -> torch.Tensor:
    """Plain version of ``ag_gemm_fused``: ``all_gather`` then the fp32
    product(s), cast once."""
    return _products(mesh.all_gather(ctx, a, 0), bs)


def ag_gemm_quant_reference(ctx, a, bs: tuple) -> torch.Tensor:
    """Plain version of ``ag_gemm_fused_quant``: ``all_gather`` of payload
    and scales, dequantize into the weights' dtype, then as
    ``ag_gemm_reference``."""
    return _products(dequant(gather_quant(ctx, a), bs[0].dtype), bs)


def _ag_kernel(ctx, a, bs: tuple, what: str) -> torch.Tensor:
    """The launches of row 16 (a plain A) or 16q (a ``QuantTensor`` A: its
    payload and scales ride to every rank, the scales in a region of their
    own after the payload's)."""
    check_operands(ctx, a, bs, what)
    m, k = a.shape
    n = bs[0].shape[1]
    if -(-m // TILE) > MAX_SLOTS:
        raise ValueError(f"{what} takes at most {MAX_SLOTS * TILE} rows a shard, got {m}")
    heap = ctx.heap
    quant = is_quant(a)
    payload = ctx.world * m * k * (1 if quant else a.element_size())
    payload_end = -(-payload // ALIGN) * ALIGN
    workspace_check(payload_end + ctx.world * m * 4 if quant else payload, what)
    out = torch.empty((ctx.world * m, n), dtype=bs[0].dtype, device=bs[0].device)
    lib = collective_library()
    epoch = heap.next_epoch()
    ws = heap.ws_off[epoch % 2]
    b1 = bs[1] if len(bs) == 2 else bs[0]
    args = (_build.ptr(bs[0]), _build.ptr(b1), _build.ptr(out), m, k, n, len(bs) - 1, dtype_code(bs[0]))
    tail = (_U64(heap.flags_off[epoch % 2]), _build.stream_ptr(out.device))
    if quant:
        code = lib.tdt_ag_gemm_quant(*heap.args(epoch), _build.ptr(a.q), _build.ptr(a.scale), *args,
                                     WIRE_CODES[a.q.dtype], _U64(ws), _U64(ws + payload_end), *tail)
    else:
        code = lib.tdt_ag_gemm(*heap.args(epoch), _build.ptr(a), *args, _U64(ws), *tail)
    _build.check(lib, code, what)
    return out


def ag_gemm_fused(ctx, a: torch.Tensor, bs: tuple) -> torch.Tensor:
    """Row 16: ``AG(a) @ b`` for ``bs = (b,)``, or the SwiGLU pair for ``bs =
    (w_gate, w_up)``; a (m, k) this rank's shard, out (world·m, n). CUDA
    tensors launch the kernel; CPU tensors run ``ag_gemm_reference``."""
    if a.device.type == "cpu":
        return ag_gemm_reference(ctx, a, bs)
    out = _ag_kernel(ctx, a, bs, "ag_gemm_fused")
    ag_gemm_fused.launches += 1
    return out


#: Kernel launches so far (CUDA calls only).
ag_gemm_fused.launches = 0


def ag_gemm_fused_quant(ctx, a, bs: tuple) -> torch.Tensor:
    """Row 16q: ``ag_gemm_fused`` with a quantized A (a ``QuantTensor``, k a
    multiple of 8): the payload and scales ride to every rank, each tile
    dequantizes exactly; out (world·m, n) in the weights' dtype. CUDA
    tensors launch the kernel; CPU tensors run ``ag_gemm_quant_reference``."""
    if a.device.type == "cpu":
        return ag_gemm_quant_reference(ctx, a, bs)
    out = _ag_kernel(ctx, a, bs, "ag_gemm_fused_quant")
    ag_gemm_fused_quant.launches += 1
    return out


ag_gemm_fused_quant.launches = 0


def _ring(ctx, a: torch.Tensor, chunk_fn) -> torch.Tensor:
    return mesh.ring_ag_concat(ctx, [chunk_fn(c) for c in mesh.ring_ag_chunks(ctx, a)])


def _ring_quant(ctx, a, dtype, chunk_fn) -> torch.Tensor:
    """The ring over a quantized shard: (payload, scale) chunks, each
    dequantized into ``dtype`` right before ``chunk_fn`` (JAX
    ``_ag_gemm_xla_ring_quant``)."""
    from triton_dist_tpu_torch.models.quant import dequantize_rows

    chunks = zip(mesh.ring_ag_chunks(ctx, a.q.view(torch.uint8)), mesh.ring_ag_chunks(ctx, a.scale))
    return mesh.ring_ag_concat(ctx, [chunk_fn(dequantize_rows(q.view(a.q.dtype), sc, dtype)) for q, sc in chunks])


def _route(ctx, a, n, dtype, method):
    if method is AGGemmMethod.AUTO:
        method = get_auto_ag_gemm_method(a.shape[0], a.shape[1], n, dtype, ctx.world)
    return method


def ag_gemm_shard(ctx, a, b: torch.Tensor, *, method: AGGemmMethod = AGGemmMethod.AUTO) -> torch.Tensor:
    """``all_gather(a) @ b``: a (m_shard, k) this rank's rows, b (k, n_shard)
    its columns → (world·m_shard, n_shard) in a's dtype (fp32 sums); a
    ``QuantTensor`` a gives b's dtype."""
    quant = is_quant(a)
    dt = b.dtype if quant else a.dtype
    if ctx is None or ctx.world == 1:
        return matmul_f32(dequant(a, dt), b).to(dt) if quant else a @ b
    method = _route(ctx, a, b.shape[1], dt, method)
    if method is AGGemmMethod.PALLAS_FUSED:
        return (ag_gemm_fused_quant if quant else ag_gemm_fused)(ctx, a, (b,))
    if method is AGGemmMethod.XLA_AG_THEN_GEMM:
        g = dequant(gather_quant(ctx, a), dt) if quant else mesh.all_gather(ctx, a, 0)
        return matmul_f32(g, b).to(dt)
    if quant:
        return _ring_quant(ctx, a, dt, lambda c: matmul_f32(c, b).to(dt))
    return _ring(ctx, a, lambda c: matmul_f32(c, b).to(dt))


def ag_gemm_swiglu_shard(ctx, x, w_gate: torch.Tensor, w_up: torch.Tensor, *,
                         method: AGGemmMethod = AGGemmMethod.AUTO) -> torch.Tensor:
    """``silu(AG(x) @ w_gate) * (AG(x) @ w_up)`` → (world·m_shard, n_shard),
    the two products in fp32 and the result cast once (to x's dtype, or the
    weights' for a ``QuantTensor`` x)."""
    quant = is_quant(x)
    dt = w_gate.dtype if quant else x.dtype

    def chunk_swiglu(c):
        return _swiglu(matmul_f32(c, w_gate), matmul_f32(c, w_up), dt)

    if ctx is None or ctx.world == 1:
        return chunk_swiglu(dequant(x, dt) if quant else x)
    method = _route(ctx, x, w_gate.shape[1], dt, method)
    if method is AGGemmMethod.PALLAS_FUSED:
        return (ag_gemm_fused_quant if quant else ag_gemm_fused)(ctx, x, (w_gate, w_up))
    if method is AGGemmMethod.XLA_AG_THEN_GEMM:
        return chunk_swiglu(dequant(gather_quant(ctx, x), dt) if quant else mesh.all_gather(ctx, x, 0))
    if quant:
        return _ring_quant(ctx, x, dt, chunk_swiglu)
    return _ring(ctx, x, chunk_swiglu)


def ag_gemm_cost(m: int, k: int, n: int, world: int, n_mats: int, itemsize: int,
                 a_row_bytes: int | None = None) -> tuple[int, int, int]:
    """(FLOPs, HBM bytes, NVLink bytes) of one rank's call: the products of
    the gathered (world·m, k) A with n_mats (k, n) weights; every input read
    once and the output written once; the other ranks' shards cross NVLink
    once. ``a_row_bytes``: bytes of one A row when it is not k·itemsize (a
    quantized A: k payload bytes and a 4-byte scale)."""
    row = k * itemsize if a_row_bytes is None else a_row_bytes
    flops = 2 * world * m * k * n * n_mats
    hbm = world * m * row + itemsize * (n_mats * k * n + world * m * n)
    return flops, hbm, (world - 1) * m * row

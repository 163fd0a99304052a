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
"""

from __future__ import annotations

import ctypes
import enum

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.group_gemm import matmul_f32
from triton_dist_tpu_torch.runtime import mesh
from triton_dist_tpu_torch.shmem.symm import MAX_SLOTS, WS_BYTES


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


def check_operands(ctx, a: torch.Tensor, bs: tuple, what: str) -> None:
    """What a CUDA collective-matmul kernel takes: tensors on ``ctx``'s card,
    one dtype (fp32 or bf16), contiguous, 16-byte aligned, 2-D shapes that
    fit (a (m, k), each b (k, n)), k and n multiples of 8."""
    for t in (a, *bs):
        if t.device != ctx.device:
            raise ValueError(f"{what}: tensor on {t.device}, context on {ctx.device}")
        if t.dtype != a.dtype:
            raise ValueError(f"{what}: operands of dtypes {a.dtype} and {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} needs contiguous, 16-byte aligned 2-D operands")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} takes fp32 or bf16, got {a.dtype}")
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


def _swiglu(g: torch.Tensor, u: torch.Tensor, dtype) -> torch.Tensor:
    return (torch.nn.functional.silu(g) * u).to(dtype)


def ag_gemm_reference(ctx, a: torch.Tensor, bs: tuple) -> torch.Tensor:
    """Plain version of ``ag_gemm_fused``: ``all_gather`` then the fp32
    product(s), cast once."""
    g = mesh.all_gather(ctx, a, 0)
    if len(bs) == 1:
        return matmul_f32(g, bs[0]).to(a.dtype)
    return _swiglu(matmul_f32(g, bs[0]), matmul_f32(g, bs[1]), a.dtype)


def ag_gemm_fused(ctx, a: torch.Tensor, bs: tuple) -> torch.Tensor:
    """Row 16: ``AG(a) @ b`` for ``bs = (b,)``, or the SwiGLU pair for ``bs =
    (w_gate, w_up)``; a (m, k) this rank's shard, out (world·m, n). CUDA
    tensors launch the kernel; CPU tensors run ``ag_gemm_reference``."""
    if a.device.type == "cpu":
        return ag_gemm_reference(ctx, a, bs)
    check_operands(ctx, a, bs, "ag_gemm_fused")
    m, k = a.shape
    n = bs[0].shape[1]
    if -(-m // TILE) > MAX_SLOTS:
        raise ValueError(f"ag_gemm_fused takes at most {MAX_SLOTS * TILE} rows a shard, got {m}")
    heap = ctx.heap
    workspace_check(ctx.world * a.numel() * a.element_size(), "ag_gemm_fused")
    out = torch.empty((ctx.world * m, n), dtype=a.dtype, device=a.device)
    lib = collective_library()
    epoch = heap.next_epoch()
    b1 = bs[1] if len(bs) == 2 else bs[0]
    code = lib.tdt_ag_gemm(*heap.args(epoch), _build.ptr(a), _build.ptr(bs[0]), _build.ptr(b1), _build.ptr(out),
                           m, k, n, len(bs) - 1, dtype_code(a), _U64(heap.ws_off[epoch % 2]),
                           _U64(heap.flags_off[epoch % 2]), _build.stream_ptr(a.device))
    _build.check(lib, code, "ag_gemm_fused")
    ag_gemm_fused.launches += 1
    return out


#: Kernel launches so far (CUDA calls only).
ag_gemm_fused.launches = 0


def _ring(ctx, a: torch.Tensor, chunk_fn) -> torch.Tensor:
    return mesh.ring_ag_concat(ctx, [chunk_fn(c) for c in mesh.ring_ag_chunks(ctx, a)])


def _route(ctx, a, n, method):
    if method is AGGemmMethod.AUTO:
        method = get_auto_ag_gemm_method(a.shape[0], a.shape[1], n, a.dtype, ctx.world)
    return method


def ag_gemm_shard(ctx, a: torch.Tensor, b: torch.Tensor, *,
                  method: AGGemmMethod = AGGemmMethod.AUTO) -> torch.Tensor:
    """``all_gather(a) @ b``: a (m_shard, k) this rank's rows, b (k, n_shard)
    its columns → (world·m_shard, n_shard) in a's dtype (fp32 sums)."""
    if ctx is None or ctx.world == 1:
        return a @ b
    method = _route(ctx, a, b.shape[1], method)
    if method is AGGemmMethod.PALLAS_FUSED:
        return ag_gemm_fused(ctx, a, (b,))
    if method is AGGemmMethod.XLA_AG_THEN_GEMM:
        return matmul_f32(mesh.all_gather(ctx, a, 0), b).to(a.dtype)
    return _ring(ctx, a, lambda c: matmul_f32(c, b).to(a.dtype))


def ag_gemm_swiglu_shard(ctx, x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, *,
                         method: AGGemmMethod = AGGemmMethod.AUTO) -> torch.Tensor:
    """``silu(AG(x) @ w_gate) * (AG(x) @ w_up)`` → (world·m_shard, n_shard),
    the two products in fp32 and the result cast once."""
    def chunk_swiglu(c):
        return _swiglu(matmul_f32(c, w_gate), matmul_f32(c, w_up), x.dtype)

    if ctx is None or ctx.world == 1:
        return chunk_swiglu(x)
    method = _route(ctx, x, w_gate.shape[1], method)
    if method is AGGemmMethod.PALLAS_FUSED:
        return ag_gemm_fused(ctx, x, (w_gate, w_up))
    if method is AGGemmMethod.XLA_AG_THEN_GEMM:
        return chunk_swiglu(mesh.all_gather(ctx, x, 0))
    return _ring(ctx, x, chunk_swiglu)


def ag_gemm_cost(m: int, k: int, n: int, world: int, n_mats: int, itemsize: int) -> tuple[int, int, int]:
    """(FLOPs, HBM bytes, NVLink bytes) of one rank's call: the products of
    the gathered (world·m, k) A with n_mats (k, n) weights; every input read
    once and the output written once; the other ranks' shards cross NVLink
    once."""
    flops = 2 * world * m * k * n * n_mats
    hbm = itemsize * (world * m * k + n_mats * k * n + world * m * n)
    return flops, hbm, itemsize * (world - 1) * m * k

"""One-token GQA flash decode over a padded KV cache or a paged block pool.

Counterpart of ``triton_dist_tpu/kernels/flash_decode.py``: ``flash_decode``
(the TPU kernel ``_decode_kernel``), ``paged_flash_decode`` (its block-table
walk ``_paged_decode_kernel``) and ``gather_paged_kv``. On a CUDA tensor
each wrapper launches its hand-written kernel in ``csrc/flash_decode.cu``
(one sweep, templated on how it finds a key; the header says what bounds it
on the H100 and how its design answers that); on a CPU tensor it runs its
plain PyTorch version (``decode_reference``, ``paged_decode_reference``),
and nothing else. ``paged_flash_decode`` with ``k_scale``/``v_scale`` (or
``QuantPool`` operands, ``models/quant.py``) walks a quantized pool: row
3b, ``_paged_decode_quant_kernel``, through ``paged_flash_decode_quant``
(plain version ``paged_decode_quant_reference``). Its payload and scales
dequantize exactly into q's dtype, so it is row 3 on the dequantized pool.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.kernels import _build

NEG_INF = -1e30
#: The pool block that is never allocated: a table's tail past a slot's
#: blocks points here, and masked or inactive writes land here. Its rows are
#: never read as data.
NULL_BLOCK = 0
SUPPORTED_HEAD_DIMS = (32, 64, 128)
SUPPORTED_GROUPS = (1, 2, 4, 8)

_SIGNATURES = {
    "tdt_flash_decode": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "tdt_paged_flash_decode": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "tdt_paged_flash_decode_quant": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}
#: The payload dtypes of a quantized pool, by the kernel's wire code.
_WIRE_CODES = {torch.int8: 0, torch.float8_e4m3fn: 1}


def decode_reference(
    q: torch.Tensor,  # (B, Hq, D)
    k_cache: torch.Tensor,  # (B, Hkv, S, D)
    v_cache: torch.Tensor,  # (B, Hkv, S, D)
    lengths: torch.Tensor,  # (B,) int32
    *,
    scale: float | None = None,
    return_lse: bool = False,
):
    """Plain masked-softmax decode with ``flash_decode``'s conventions: keys
    ``< lengths[b]`` are valid, fp32 scores, P cast to V's dtype before PV,
    o = 0 and lse = -1e30 for a row with no key."""
    b, hq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    kf = k_cache.float().repeat_interleave(group, dim=1)
    vf = v_cache.repeat_interleave(group, dim=1)
    sc = torch.einsum("bhd,bhkd->bhk", q.float(), kf) * scale
    valid = torch.arange(s, device=q.device)[None, :] < lengths.to(q.device).long()[:, None]
    sc = torch.where(valid[:, None, :], sc, torch.full_like(sc, NEG_INF))
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(valid[:, None, :], torch.exp(sc - m), torch.zeros_like(sc))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhk,bhkd->bhd", p.to(v_cache.dtype).float(), vf.float())
    o = (o / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(l == 0, torch.full_like(l, NEG_INF), m + torch.log(torch.clamp(l, min=1e-30)))
    return o, lse[..., 0]


def flash_decode(
    q: torch.Tensor,  # (B, Hq, D) — one decode step
    k_cache: torch.Tensor,  # (B, Hkv, S, D)
    v_cache: torch.Tensor,  # (B, Hkv, S, D)
    lengths: torch.Tensor,  # (B,) int32 — valid cache length per sequence
    *,
    scale: float | None = None,
    return_lse: bool = False,
):
    """One-token GQA decode against a padded KV cache. Returns ``o``
    (B, Hq, D), plus ``lse`` (B, Hq) fp32 when ``return_lse``. CUDA tensors
    (fp32 or bf16, contiguous, D in 32/64/128, Hq/Hkv in 1/2/4/8, int32
    lengths) launch the kernel; CPU tensors run ``decode_reference``."""
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    b, hq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != d or hq % hkv != 0:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, cache {tuple(k_cache.shape)}")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},), got {tuple(lengths.shape)}")
    if not (q.device == k_cache.device == v_cache.device == lengths.device):
        raise ValueError("q, caches and lengths must be on one device")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise ValueError("q and the caches must share a dtype")
    if q.device.type == "cpu":
        return decode_reference(q, k_cache, v_cache, lengths, scale=scale, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on CUDA or CPU tensors, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_decode takes fp32 or bf16, got {q.dtype}")
    if lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32, got {lengths.dtype}")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, lengths)):
        raise ValueError("flash_decode needs contiguous q, caches and lengths")
    if d not in SUPPORTED_HEAD_DIMS or hq // hkv not in SUPPORTED_GROUPS:
        raise ValueError(f"unsupported head dim {d} or group {hq // hkv}")
    scale = d ** -0.5 if scale is None else scale
    o = torch.empty_like(q)
    lse = torch.empty((b, hq), device=q.device, dtype=torch.float32) if return_lse else None
    lib = _build.load("flash_decode", _SIGNATURES)
    with torch.cuda.device(q.device):
        code = lib.tdt_flash_decode(
            _build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache), _build.ptr(lengths),
            _build.ptr(o), _build.ptr(lse), b, hq, hkv, s, d, ctypes.c_float(scale),
            1 if q.dtype == torch.bfloat16 else 0, _build.stream_ptr(q.device),
        )
    _build.check(lib, code, "flash_decode")
    flash_decode.launches += 1
    return (o, lse) if return_lse else o


#: Kernel launches so far (CUDA calls only; the CPU path launches nothing).
flash_decode.launches = 0


def gather_paged_kv(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """The contiguous (..., B, Hkv, max_blocks·bs, D) copy of a (...,
    num_blocks, Hkv, bs, D) pool (leading dims such as layers kept) along
    (B, max_blocks) block tables: a plain gather (unmapped entries point at
    the NULL block and sit past the lengths)."""
    if pool.dtype in (torch.int8, torch.float8_e4m3fn):  # a quantized payload moves as bytes
        return gather_paged_kv(pool.view(torch.uint8), tables).view(pool.dtype)
    b, mb = tables.shape
    *lead, _, hkv, bs, d = pool.shape
    g = pool[..., tables.reshape(-1).long(), :, :, :].reshape(*lead, b, mb, hkv, bs, d)
    return g.transpose(-4, -3).reshape(*lead, b, hkv, mb * bs, d)


def paged_decode_reference(q, k_pool, v_pool, tables, lengths, *, scale: float | None = None,
                           return_lse: bool = False):
    """Plain ``paged_flash_decode``: gather the pool along the tables, then
    ``decode_reference`` (the JAX ``impl="gather"`` oracle)."""
    return decode_reference(q, gather_paged_kv(k_pool, tables), gather_paged_kv(v_pool, tables),
                            lengths, scale=scale, return_lse=return_lse)


def _check_paged(q, k_pool, v_pool, tables, lengths) -> None:
    """Shapes and devices every paged walk needs."""
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape or tables.dim() != 2:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, pools {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}, tables {tuple(tables.shape)}")
    b, hq, d = q.shape
    hkv = k_pool.shape[1]
    if k_pool.shape[3] != d or hq % hkv or tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"bad shapes q {tuple(q.shape)}, pool {tuple(k_pool.shape)}, "
                         f"tables {tuple(tables.shape)}, lengths {tuple(lengths.shape)}")
    if not (q.device == k_pool.device == v_pool.device == tables.device == lengths.device):
        raise ValueError("q, pools, tables and lengths must be on one device")


def _check_cuda_paged(q, tables, lengths, tensors, what: str) -> None:
    """What the CUDA walks take beyond ``_check_paged``."""
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} takes fp32 or bf16, got {q.dtype}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"tables and lengths must be int32, got {tables.dtype}, {lengths.dtype}")
    if not all(t.is_contiguous() for t in (q, tables, lengths, *tensors)):
        raise ValueError(f"{what} needs contiguous q, pools, tables and lengths")
    b, hq, d = q.shape
    group = hq // tensors[0].shape[1]
    if d not in SUPPORTED_HEAD_DIMS or group not in SUPPORTED_GROUPS or tables.shape[1] > 16384:
        raise ValueError(f"unsupported head dim {d}, group {group} or {tables.shape[1]} table columns")


def paged_flash_decode(
    q: torch.Tensor,  # (B, Hq, D) — one decode step
    k_pool,  # (num_blocks, Hkv, bs, D) — the global block pool, or a QuantPool
    v_pool,
    tables: torch.Tensor,  # (B, max_blocks) int32 physical block ids
    lengths: torch.Tensor,  # (B,) int32 valid length per sequence
    *,
    scale: float | None = None,
    return_lse: bool = False,
    k_scale: torch.Tensor | None = None,  # (num_blocks, Hkv, bs, 1) f32: a quantized pool
    v_scale: torch.Tensor | None = None,
):
    """One-token GQA decode against a paged cache: key t of sequence b is
    ``pool[tables[b, t // bs], :, t % bs]``; keys past ``max_blocks·bs``
    are never read. Returns ``o`` (B, Hq, D), plus ``lse`` (B, Hq) fp32
    when ``return_lse``. CUDA tensors (as ``flash_decode``, int32 tables)
    launch the kernel; CPU tensors run ``paged_decode_reference``. With
    ``k_scale``/``v_scale``, or ``QuantPool`` pools, the pool is quantized
    and ``paged_flash_decode_quant`` walks it."""
    from triton_dist_tpu_torch.models.quant import QuantPool

    if isinstance(k_pool, QuantPool):
        k_pool, k_scale = k_pool.q, k_pool.scale
    if isinstance(v_pool, QuantPool):
        v_pool, v_scale = v_pool.q, v_pool.scale
    if (k_scale is None) != (v_scale is None):
        raise ValueError("a quantized pool needs both k_scale and v_scale")
    if k_scale is not None:
        return paged_flash_decode_quant(q, k_pool, v_pool, tables, lengths, k_scale=k_scale, v_scale=v_scale,
                                        scale=scale, return_lse=return_lse)
    _check_paged(q, k_pool, v_pool, tables, lengths)
    b, hq, d = q.shape
    _, hkv, bs, _ = k_pool.shape
    mb = tables.shape[1]
    if not (q.dtype == k_pool.dtype == v_pool.dtype):
        raise ValueError("q and the pools must share a dtype")
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pool, v_pool, tables, lengths, scale=scale,
                                      return_lse=return_lse)
    _check_cuda_paged(q, tables, lengths, (k_pool, v_pool), "paged_flash_decode")
    scale = d ** -0.5 if scale is None else scale
    o = torch.empty_like(q)
    lse = torch.empty((b, hq), device=q.device, dtype=torch.float32) if return_lse else None
    lib = _build.load("flash_decode", _SIGNATURES)
    with torch.cuda.device(q.device):
        code = lib.tdt_paged_flash_decode(
            _build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool), _build.ptr(tables),
            _build.ptr(lengths), _build.ptr(o), _build.ptr(lse), b, hq, hkv, bs, mb, d,
            ctypes.c_float(scale), 1 if q.dtype == torch.bfloat16 else 0, _build.stream_ptr(q.device),
        )
    _build.check(lib, code, "paged_flash_decode")
    paged_flash_decode.launches += 1
    return (o, lse) if return_lse else o


paged_flash_decode.launches = 0


def paged_decode_quant_reference(q, k_pool, v_pool, tables, lengths, *, k_scale, v_scale,
                                 scale: float | None = None, return_lse: bool = False):
    """Plain row 3b: gather payload and scales along the tables, dequantize
    them into q's dtype (exact: power-of-two scales; JAX's ``impl="gather"``
    oracle), then ``decode_reference``: row 3's plain version on the
    dequantized pool."""
    from triton_dist_tpu_torch.models.quant import dequantize_kv

    kc = dequantize_kv(gather_paged_kv(k_pool, tables), gather_paged_kv(k_scale, tables), q.dtype)
    vc = dequantize_kv(gather_paged_kv(v_pool, tables), gather_paged_kv(v_scale, tables), q.dtype)
    return decode_reference(q, kc, vc, lengths, scale=scale, return_lse=return_lse)


def paged_flash_decode_quant(
    q: torch.Tensor,  # (B, Hq, D) — one decode step
    k_pool: torch.Tensor,  # (num_blocks, Hkv, bs, D) int8 or float8_e4m3fn payload
    v_pool: torch.Tensor,
    tables: torch.Tensor,  # (B, max_blocks) int32
    lengths: torch.Tensor,  # (B,) int32
    *,
    k_scale: torch.Tensor,  # (num_blocks, Hkv, bs, 1) f32 row scales
    v_scale: torch.Tensor,
    scale: float | None = None,
    return_lse: bool = False,
):
    """Row 3b: ``paged_flash_decode`` over a quantized pool, each row
    dequantized with its scale (found through the same table entry) into
    q's dtype. Returns ``o`` (B, Hq, D) in q's dtype (and ``lse``). CUDA
    tensors (q fp32 or bf16, as ``paged_flash_decode``) launch the kernel;
    CPU tensors run ``paged_decode_quant_reference``."""
    _check_paged(q, k_pool, v_pool, tables, lengths)
    b, hq, d = q.shape
    nb, hkv, bs, _ = k_pool.shape
    mb = tables.shape[1]
    if k_pool.dtype not in _WIRE_CODES or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"a quantized pool holds int8 or float8_e4m3fn, got {k_pool.dtype}, {v_pool.dtype}")
    for s_ in (k_scale, v_scale):
        if s_.shape != (nb, hkv, bs, 1) or s_.dtype != torch.float32 or s_.device != q.device:
            raise ValueError(f"scale pools must be ({nb}, {hkv}, {bs}, 1) f32 on {q.device}, got "
                             f"{tuple(s_.shape)} {s_.dtype} on {s_.device}")
    if q.device.type == "cpu":
        return paged_decode_quant_reference(q, k_pool, v_pool, tables, lengths, k_scale=k_scale, v_scale=v_scale,
                                            scale=scale, return_lse=return_lse)
    _check_cuda_paged(q, tables, lengths, (k_pool, v_pool, k_scale, v_scale), "paged_flash_decode_quant")
    scale = d ** -0.5 if scale is None else scale
    o = torch.empty_like(q)
    lse = torch.empty((b, hq), device=q.device, dtype=torch.float32) if return_lse else None
    lib = _build.load("flash_decode", _SIGNATURES)
    with torch.cuda.device(q.device):
        code = lib.tdt_paged_flash_decode_quant(
            _build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool), _build.ptr(k_scale), _build.ptr(v_scale),
            _build.ptr(tables), _build.ptr(lengths), _build.ptr(o), _build.ptr(lse), b, hq, hkv, bs, mb, d,
            ctypes.c_float(scale), 1 if q.dtype == torch.bfloat16 else 0, _WIRE_CODES[k_pool.dtype],
            _build.stream_ptr(q.device),
        )
    _build.check(lib, code, "paged_flash_decode_quant")
    paged_flash_decode_quant.launches += 1
    return (o, lse) if return_lse else o


paged_flash_decode_quant.launches = 0


def decode_bytes(q: torch.Tensor, k_cache: torch.Tensor, lengths: torch.Tensor, *,
                 return_lse: bool = False) -> int:
    """Bytes the function must move for these inputs: each valid K and V row
    read once, q and lengths read, o (and lse) written."""
    b, hq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    rows = int(torch.clamp(lengths.long(), 0, s).sum())
    n = 2 * rows * hkv * d * k_cache.element_size() + 2 * q.numel() * q.element_size()
    n += lengths.numel() * 4 + (b * hq * 4 if return_lse else 0)
    return n


def decode_flops(q: torch.Tensor, k_cache: torch.Tensor, lengths: torch.Tensor) -> int:
    """FLOPs for these inputs: 4·D per (query head, valid key) pair."""
    b, hq, d = q.shape
    rows = int(torch.clamp(lengths.long(), 0, k_cache.shape[2]).sum())
    return 4 * d * hq * rows


def paged_decode_cost(q: torch.Tensor, k_pool: torch.Tensor, tables: torch.Tensor,
                      lengths: torch.Tensor, *, quantized: bool = False) -> tuple[int, int]:
    """(FLOPs, bytes) of ``paged_flash_decode`` for these inputs: as
    ``flash_decode`` over the valid keys (capped at max_blocks·bs), plus the
    block tables read once. ``quantized``: ``k_pool`` is a quantized
    payload, and each valid row also reads its 4-byte f32 scale."""
    b, hq, d = q.shape
    hkv, bs = k_pool.shape[1], k_pool.shape[2]
    rows = int(torch.clamp(lengths.long(), 0, tables.shape[1] * bs).sum())
    row_bytes = d * k_pool.element_size() + (4 if quantized else 0)
    nbytes = 2 * rows * hkv * row_bytes + 2 * q.numel() * q.element_size()
    return 4 * d * hq * rows, nbytes + 4 * (lengths.numel() + tables.numel())

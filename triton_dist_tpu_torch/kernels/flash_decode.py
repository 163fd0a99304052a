"""One-token GQA flash decode over a padded KV cache.

Counterpart of ``triton_dist_tpu/kernels/flash_decode.py`` (``flash_decode``
and the TPU kernel ``_decode_kernel``). On a CUDA tensor ``flash_decode``
launches the hand-written kernel in ``csrc/flash_decode.cu`` (its header
says what bounds it on the H100 and how its design answers that); on a CPU
tensor it runs ``decode_reference``, the plain PyTorch version of the same
function, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.kernels import _build

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (32, 64, 128)
SUPPORTED_GROUPS = (1, 2, 4, 8)

_SIGNATURES = {
    "tdt_flash_decode": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}


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

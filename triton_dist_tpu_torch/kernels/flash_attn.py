"""Flash attention forward (prefill and chunked prefill).

Counterpart of ``triton_dist_tpu/kernels/flash_attn.py`` (``flash_attention``
and the TPU kernel ``_flash_kernel``). On a CUDA tensor ``flash_attention``
launches the hand-written kernel in ``csrc/flash_attn.cu`` (its header
says what bounds it on the H100 and how its design answers that); on a CPU
tensor it runs ``attention_reference``, the plain PyTorch version of the
same function, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.kernels import _build

NEG_INF = -1e30
#: log2(e): folds nat-domain scores into the exp2-domain softmax.
LOG2E = 1.4426950408889634
SUPPORTED_HEAD_DIMS = (32, 64, 128)

_SIGNATURES = {
    "tdt_flash_attn_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}


def _q_off(sq: int, sk: int, q_offset, kv_offset) -> int:
    """Causal mask offset: key ``ki`` is visible to query row ``qi`` when
    ``q_off + qi >= ki``. End-aligned (``sk - sq``) without offsets."""
    if q_offset is None and kv_offset is None:
        return sk - sq
    return int(q_offset or 0) - int(kv_offset or 0)


def attention_reference(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    *,
    causal: bool = True,
    scale: float | None = None,
    return_lse: bool = False,
    q_offset: int | None = None,
    kv_offset: int | None = None,
):
    """Plain masked-softmax attention with ``flash_attention``'s conventions:
    fp32 scores in the exp2 domain, P cast to V's dtype before PV, zeros for
    rows with no valid key, LSE (B, Hq, Sq) fp32 in nats."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * (scale * LOG2E)
    if causal:
        q_off = _q_off(sq, sk, q_offset, kv_offset)
        qi = torch.arange(sq, device=q.device)[:, None] + q_off
        ki = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qi >= ki, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    p = torch.where(m <= NEG_INF * 0.5, torch.zeros_like(p), p)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vf.float())
    o = (o / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)
    if not return_lse:
        return o
    lse = (m + torch.log2(torch.clamp(l, min=1e-30))) / LOG2E
    return o, lse[..., 0]


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D (B, H, S, D)")
    b, hq, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hq % k.shape[1] != 0:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[1]}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share a dtype")


def flash_attention(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, D)
    *,
    causal: bool = True,
    scale: float | None = None,
    return_lse: bool = False,
    q_offset: int | None = None,
    kv_offset: int | None = None,
):
    """Flash attention forward. Returns ``o`` (B, Hq, Sq, D), plus the
    log-sum-exp (B, Hq, Sq) fp32 when ``return_lse``.

    ``q_offset``/``kv_offset`` place the query rows and key columns in one
    coordinate system for the causal mask (chunked prefill passes the
    chunk's start as ``q_offset``); without them the mask is end-aligned.
    CUDA tensors (fp32 or bf16, contiguous, D in 32/64/128) launch the
    kernel; CPU tensors run ``attention_reference``."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_reference(
            q, k, v, causal=causal, scale=scale, return_lse=return_lse,
            q_offset=q_offset, kv_offset=kv_offset,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention takes fp32 or bf16, got {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k, v")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if b * hq > 65535 or sq == 0:
        raise ValueError(f"unsupported launch shape B*Hq={b * hq}, Sq={sq}")
    scale = d ** -0.5 if scale is None else scale
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), device=q.device, dtype=torch.float32) if return_lse else None
    lib = _build.load("flash_attn", _SIGNATURES)
    with torch.cuda.device(q.device):
        code = lib.tdt_flash_attn_fwd(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o), _build.ptr(lse),
            b, hq, hkv, sq, sk, d, int(causal), _q_off(sq, sk, q_offset, kv_offset),
            ctypes.c_float(scale * LOG2E), 1 if q.dtype == torch.bfloat16 else 0,
            _build.stream_ptr(q.device),
        )
    _build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


#: Kernel launches so far (CUDA calls only; the CPU path launches nothing).
flash_attention.launches = 0


def attention_flops(b: int, hq: int, sq: int, sk: int, d: int, *, causal: bool,
                    q_off: int | None = None) -> int:
    """FLOPs the attention needs for these shapes: 4·D per visible
    (query, key) pair (QK^T and PV), counting only unmasked pairs."""
    if not causal:
        pairs = sq * sk
    else:
        q_off = sk - sq if q_off is None else q_off
        pairs = sum(max(0, min(sk, q_off + i + 1)) for i in range(sq))
    return 4 * d * b * hq * pairs


def attention_bytes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    return_lse: bool = False) -> int:
    """Bytes the function must move: q, k, v read once, o (and lse) written once."""
    n = 2 * q.numel() * q.element_size() + (k.numel() + v.numel()) * k.element_size()
    if return_lse:
        n += q.shape[0] * q.shape[1] * q.shape[2] * 4
    return n


"""Flash attention: forward (prefill, chunked prefill, packed sequences)
and backward.

Counterpart of ``triton_dist_tpu/kernels/flash_attn.py``:

* ``flash_attention`` (TPU kernel ``_flash_kernel``) and
  ``flash_attention_varlen`` (``_flash_varlen_kernel``, packed sequences
  under ``cu_seqlens``) launch ``csrc/flash_attn.cu``;
* ``flash_attention_bwd`` and ``flash_attention_varlen_bwd`` (the TPU dq and
  dk/dv kernel pairs) launch ``csrc/flash_attn_bwd.cu``, two kernels a call.

Each source's header says what bounds it on the H100 and how its design
answers that. On a CPU tensor each function runs its plain PyTorch version
(``attention_reference``, ``varlen_reference``, ``attention_bwd_reference``,
``varlen_bwd_reference``) and nothing else; a CUDA tensor launches the
kernel or raises. Offsets are Python ints. The backward's δ = rowsum(do·o)
− dlse is plain tensor code on either device, as in JAX.
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
    "tdt_flash_attn_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}
_BWD_SIGNATURES = {
    "tdt_flash_attn_bwd": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}


def _q_off(sq: int, sk: int, q_offset, kv_offset) -> int:
    """Causal mask offset: key ``ki`` is visible to query row ``qi`` when
    ``q_off + qi >= ki``. End-aligned (``sk - sq``) without offsets."""
    if q_offset is None and kv_offset is None:
        return sk - sq
    return int(q_offset or 0) - int(kv_offset or 0)


def _masked_attention(q, k, v, mask, scale):
    """Masked softmax attention on (B, H, S, D) operands with the kernels'
    conventions: fp32 scores in the exp2 domain, P cast to V's dtype before
    PV, zeros for rows with no visible key. Returns o, the LSE (B, Hq, Sq)
    fp32 in nats, and which rows had no visible key."""
    hq, d = q.shape[1], q.shape[3]
    group = hq // k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * (scale * LOG2E)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    p = torch.where(m <= NEG_INF * 0.5, torch.zeros_like(p), p)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vf.float())
    o = (o / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)
    lse = (m + torch.log2(torch.clamp(l, min=1e-30))) / LOG2E
    return o, lse[..., 0], (l == 0)[..., 0]


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
    sq, sk = q.shape[2], k.shape[2]
    mask = None
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + _q_off(sq, sk, q_offset, kv_offset)
        mask = qi >= torch.arange(sk, device=q.device)[None, :]
    o, lse, _ = _masked_attention(q, k, v, mask, scale)
    return (o, lse) if return_lse else o


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


def _cuda_check(what: str, *ts: torch.Tensor) -> int:
    """What the kernels take: CUDA tensors, fp32 or bf16, contiguous, D in
    32/64/128. Returns D."""
    q = ts[0]
    if q.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} takes fp32 or bf16, got {q.dtype}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what} needs contiguous operands")
    d = q.shape[-1]
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    return d


def _dtype_code(t: torch.Tensor) -> int:
    return 1 if t.dtype == torch.bfloat16 else 0


def _launch_fwd(q, k, v, *, causal, scale, return_lse, q_off, segs, what):
    """The forward kernel on (B, H, S, D) operands; ``segs`` the packed
    mode's (seg_q, seg_k) int32, or None."""
    d = _cuda_check(what, q, k, v)
    b, hq, sq, _ = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if b * hq > 65535 or sq == 0:
        raise ValueError(f"{what}: unsupported launch shape B*Hq={b * hq}, Sq={sq}")
    scale = d ** -0.5 if scale is None else scale
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), device=q.device, dtype=torch.float32) if return_lse else None
    seg_q, seg_k = segs if segs is not None else (None, None)
    lib = _build.load("flash_attn", _SIGNATURES)
    with torch.cuda.device(q.device):
        code = lib.tdt_flash_attn_fwd(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o), _build.ptr(lse),
            _build.ptr(seg_q), _build.ptr(seg_k), b, hq, hkv, sq, sk, d, int(causal), q_off,
            ctypes.c_float(scale * LOG2E), _dtype_code(q), _build.stream_ptr(q.device),
        )
    _build.check(lib, code, what)
    return o, lse


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
    o, lse = _launch_fwd(q, k, v, causal=causal, scale=scale, return_lse=return_lse,
                         q_off=_q_off(q.shape[2], k.shape[2], q_offset, kv_offset), segs=None,
                         what="flash_attention")
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


#: Kernel launches so far (CUDA calls only; the CPU path launches nothing).
flash_attention.launches = 0


# ------------------------------------------------------ packed sequences


def _varlen_segments(cu_seqlens, t: int, q_offset: int | None = None, kv_offset: int | None = None,
                     device=None):
    """Per-position segment ids (1, t) int32 of the q rows and the keys: the
    segment of global position ``offset + i`` under ``cu_seqlens``; Q
    padding (at or past ``cu_seqlens[-1]``) −1, K padding −2, so padding
    never matches. The offsets shift the positions into the global packed
    stream (ring shards); ``cu_seqlens`` itself is always global."""
    cu = torch.as_tensor(cu_seqlens, dtype=torch.int32, device=device)

    def seg_at(offset, sentinel):
        pos = torch.arange(t, dtype=torch.int32, device=cu.device) + int(offset or 0)
        seg = torch.searchsorted(cu[1:].contiguous(), pos, right=True).to(torch.int32)
        return torch.where(pos < cu[-1], seg, torch.full_like(seg, sentinel)).reshape(1, t)

    return seg_at(q_offset, -1), seg_at(kv_offset, -2)


def _varlen_mask(cu_seqlens, t: int, q_offset, kv_offset, device) -> torch.Tensor:
    """(t, t) bool: query row i sees key j when ``q_off + i >= j`` (q_off =
    q_offset − kv_offset) and both are in the same segment."""
    seg_q, seg_k = _varlen_segments(cu_seqlens, t, q_offset, kv_offset, device)
    q_off = int(q_offset or 0) - int(kv_offset or 0)
    i = torch.arange(t, device=device)
    return (i[:, None] + q_off >= i[None, :]) & (seg_q.reshape(t, 1) == seg_k.reshape(1, t))


def _check_varlen(q, k, v):
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"q, k, v must be 3-D (H, T, D): q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if k.shape[1] != q.shape[1] or k.shape[2] != q.shape[2]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}")
    _check(q[None], k[None], v[None])


def varlen_reference(q, k, v, cu_seqlens, *, scale=None, return_lse=False, q_offset=None,
                     kv_offset=None):
    """Plain version of ``flash_attention_varlen``: masked softmax in fp32
    (exp2 domain), P cast to V's dtype before PV; rows with no visible key
    (padding) get o = 0 and lse = ``NEG_INF``."""
    mask = _varlen_mask(cu_seqlens, q.shape[1], q_offset, kv_offset, q.device)
    o, lse, empty = _masked_attention(q[None], k[None], v[None], mask, scale)
    lse = torch.where(empty, torch.full_like(lse, NEG_INF), lse)
    return (o[0], lse[0]) if return_lse else o[0]


def flash_attention_varlen(
    q: torch.Tensor,  # (Hq, T, D) packed sequences, total length T
    k: torch.Tensor,  # (Hkv, T, D)
    v: torch.Tensor,  # (Hkv, T, D)
    cu_seqlens,  # (N + 1,) int32 increasing offsets (a tensor or a list)
    *,
    scale: float | None = None,
    return_lse: bool = False,
    q_offset: int | None = None,
    kv_offset: int | None = None,
):
    """Varlen (``cu_seqlens``) causal flash attention over packed sequences:
    a token sees the tokens before it in its own segment; rows past
    ``cu_seqlens[-1]`` (padding) get zero output and lse ``NEG_INF``.
    ``q_offset``/``kv_offset`` place this call's rows and keys in the global
    packed stream (a ring step's shards). Returns ``o`` (Hq, T, D), plus the
    LSE (Hq, T) fp32 when ``return_lse``. CUDA tensors launch the kernel
    (row 4); CPU tensors run ``varlen_reference``."""
    _check_varlen(q, k, v)
    if q.device.type == "cpu":
        return varlen_reference(q, k, v, cu_seqlens, scale=scale, return_lse=return_lse,
                                q_offset=q_offset, kv_offset=kv_offset)
    segs = _varlen_segments(cu_seqlens, q.shape[1], q_offset, kv_offset, q.device)
    o, lse = _launch_fwd(q[None], k[None], v[None], causal=True, scale=scale, return_lse=return_lse,
                         q_off=int(q_offset or 0) - int(kv_offset or 0), segs=segs,
                         what="flash_attention_varlen")
    flash_attention_varlen.launches += 1
    return (o[0], lse[0]) if return_lse else o[0]


#: Kernel launches so far (CUDA calls only).
flash_attention_varlen.launches = 0


# ------------------------------------------------------------- backward


def _bwd_rows(o, lse, do, dlse):
    """lse2 = lse·log2(e) and δ = rowsum(do·o) − dlse, fp32, shaped like lse."""
    lse2 = lse.float() * LOG2E
    delta = (do.float() * o.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float().reshape(delta.shape)
    return lse2.contiguous(), delta.contiguous()


def _bwd_masked(q, k, v, do, lse2, delta, mask, scale):
    """Plain backward on (B, H, S, D) operands from the saved LSE, the
    arithmetic of JAX's ``_bwd_p_ds``: p = exp2(s·scale·log2(e) − lse2),
    zero where masked or where the row's lse2 is NEG_INF-like; ds = p∘(dp −
    δ)·scale; p and ds cast to the input dtype before dv = pᵀdo, dk = dsᵀq,
    dq = ds·k; GQA heads summed into their kv head."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s2 = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * (scale * LOG2E)
    if mask is not None:
        s2 = torch.where(mask, s2, torch.full_like(s2, NEG_INF))
    l2 = lse2[..., None]
    p = torch.where(l2 > NEG_INF * 0.5, torch.exp2(s2 - l2), torch.zeros_like(s2))
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), vf)
    ds = p * (dp - delta[..., None]) * scale
    p = p.to(do.dtype).float()
    ds = ds.to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()).reshape(b, hkv, group, sk, d).sum(2)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float()).reshape(b, hkv, group, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_reference(q, k, v, o, lse, do, *, causal=True, scale=None, q_offset=None,
                            kv_offset=None, dlse=None):
    """Plain version of ``flash_attention_bwd``."""
    sq, sk = q.shape[2], k.shape[2]
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    mask = None
    if causal:
        i = torch.arange(sq, device=q.device)[:, None] + _q_off(sq, sk, q_offset, kv_offset)
        mask = i >= torch.arange(sk, device=q.device)[None, :]
    return _bwd_masked(q, k, v, do, *_bwd_rows(o, lse, do, dlse), mask, scale)


def varlen_bwd_reference(q, k, v, o, lse, do, cu_seqlens, *, scale=None, q_offset=None,
                         kv_offset=None, dlse=None):
    """Plain version of ``flash_attention_varlen_bwd``."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    mask = _varlen_mask(cu_seqlens, q.shape[1], q_offset, kv_offset, q.device)
    lse2, delta = _bwd_rows(o, lse, do, dlse)
    dq, dk, dv = _bwd_masked(q[None], k[None], v[None], do[None], lse2[None], delta[None], mask, scale)
    return dq[0], dk[0], dv[0]


def _launch_bwd(q, k, v, do, lse2, delta, *, causal, scale, q_off, segs, what):
    d = _cuda_check(what, q, k, v, do)
    if not (q.dtype == do.dtype and q.device == do.device == lse2.device):
        raise ValueError(f"{what}: do must match q's dtype and device")
    b, hq, sq, _ = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if b * hq > 65535 or sq == 0 or sk == 0:
        raise ValueError(f"{what}: unsupported launch shape B*Hq={b * hq}, Sq={sq}, Sk={sk}")
    scale = d ** -0.5 if scale is None else scale
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    seg_q, seg_k = segs if segs is not None else (None, None)
    lib = _build.load("flash_attn_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(q.device):
        code = lib.tdt_flash_attn_bwd(
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(do), _build.ptr(lse2),
            _build.ptr(delta), _build.ptr(seg_q), _build.ptr(seg_k), _build.ptr(dq), _build.ptr(dk),
            _build.ptr(dv), b, hq, hkv, sq, sk, d, int(causal), q_off, ctypes.c_float(scale),
            ctypes.c_float(scale * LOG2E), _dtype_code(q), _build.stream_ptr(q.device),
        )
    _build.check(lib, code, what)
    return dq, dk, dv


def flash_attention_bwd(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,
    o: torch.Tensor,  # (B, Hq, Sq, D) saved forward output
    lse: torch.Tensor,  # (B, Hq, Sq) saved log-sum-exp (nats)
    do: torch.Tensor,  # (B, Hq, Sq, D) output cotangent
    *,
    causal: bool = True,
    scale: float | None = None,
    q_offset: int | None = None,
    kv_offset: int | None = None,
    dlse: torch.Tensor | None = None,  # (B, Hq, Sq) LSE cotangent (ring merges)
):
    """Flash-attention backward from the saved LSE (row 5). Returns (dq, dk,
    dv) in the inputs' dtypes. ``q_offset``/``kv_offset`` are the forward's;
    ``dlse``, the LSE output's cotangent, folds into δ. CUDA tensors launch
    the dq and dk/dv kernels (two launches); CPU tensors run
    ``attention_bwd_reference``."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, o, lse, do, causal=causal, scale=scale,
                                       q_offset=q_offset, kv_offset=kv_offset, dlse=dlse)
    lse2, delta = _bwd_rows(o, lse, do, dlse)
    out = _launch_bwd(q, k, v, do.contiguous(), lse2, delta, causal=causal, scale=scale,
                      q_off=_q_off(q.shape[2], k.shape[2], q_offset, kv_offset), segs=None,
                      what="flash_attention_bwd")
    flash_attention_bwd.launches += 2
    return out


#: Kernel launches so far (two a CUDA call: dq, then dk/dv).
flash_attention_bwd.launches = 0


def flash_attention_varlen_bwd(
    q: torch.Tensor,  # (Hq, T, D) packed
    k: torch.Tensor,  # (Hkv, T, D)
    v: torch.Tensor,
    o: torch.Tensor,  # (Hq, T, D) saved forward output
    lse: torch.Tensor,  # (Hq, T) saved log-sum-exp (nats; NEG_INF on padding)
    do: torch.Tensor,  # (Hq, T, D) output cotangent
    cu_seqlens,
    *,
    scale: float | None = None,
    q_offset: int | None = None,
    kv_offset: int | None = None,
    dlse: torch.Tensor | None = None,  # (Hq, T)
):
    """Varlen backward (row 6): the dense backward under the packed-segment
    mask. Padding rows carry lse ``NEG_INF`` and o = 0, so they contribute
    nothing. Returns (dq, dk, dv). CUDA tensors launch the dq and dk/dv
    kernels in the packed mode (two launches); CPU tensors run
    ``varlen_bwd_reference``."""
    _check_varlen(q, k, v)
    if q.device.type == "cpu":
        return varlen_bwd_reference(q, k, v, o, lse, do, cu_seqlens, scale=scale, q_offset=q_offset,
                                    kv_offset=kv_offset, dlse=dlse)
    lse2, delta = _bwd_rows(o, lse, do, dlse)
    segs = _varlen_segments(cu_seqlens, q.shape[1], q_offset, kv_offset, q.device)
    dq, dk, dv = _launch_bwd(q[None], k[None], v[None], do.contiguous()[None], lse2[None], delta[None],
                             causal=True, scale=scale, q_off=int(q_offset or 0) - int(kv_offset or 0),
                             segs=segs, what="flash_attention_varlen_bwd")
    flash_attention_varlen_bwd.launches += 2
    return dq[0], dk[0], dv[0]


#: Kernel launches so far (two a CUDA call: dq, then dk/dv).
flash_attention_varlen_bwd.launches = 0


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



def varlen_flops(cu_seqlens, t: int, hq: int, d: int, *, q_offset: int | None = None,
                 kv_offset: int | None = None) -> int:
    """FLOPs the packed attention needs: 4·D per visible (query, key) pair
    under these segments, for every q head."""
    pairs = int(_varlen_mask(cu_seqlens, t, q_offset, kv_offset, "cpu").sum())
    return 4 * d * hq * pairs


def attention_bwd_flops(fwd_flops: int) -> int:
    """FLOPs a backward needs: 2.5 times the forward's (dv = pᵀdo, dp =
    do·vᵀ, dq = ds·k, dk = dsᵀq and the recomputed s, counting each visible
    pair's products once, against the forward's two)."""
    return fwd_flops * 5 // 2


def attention_bwd_bytes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """Bytes the backward must move: q, o, do and k, v read once, the LSE
    and δ rows (fp32) read once, dq, dk, dv written once."""
    rows = q.numel() // q.shape[-1]
    return q.element_size() * (4 * q.numel() + 2 * (k.numel() + v.numel())) + 8 * rows

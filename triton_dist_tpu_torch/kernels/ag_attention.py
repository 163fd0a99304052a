"""Fused all-gather flash attention (sequence parallelism, row 27):
counterpart of ``triton_dist_tpu/kernels/ag_attention.py``
(``ag_attention_supported``, ``ag_flash_attention_shard``).

Every rank holds one sequence shard of q, k, v (B, H, S_local, D), shard j
at global positions [j·S_local, (j + 1)·S_local). ``ag_flash_attention_shard``
returns this rank's rows of exact attention over the whole world·S_local
sequence: the KV shards are gathered one-sided and consumed shard by
shard, the local one first, by one online softmax, with the blockwise-causal
mask on global positions (shard j < rank unmasked, j == rank causal, j >
rank contributes nothing). On CUDA tensors it launches the hand-written
kernel of ``csrc/ag_attention.cu`` (``ag_attn_kernel``; the source's header
says what bounds it on the H100 and how its design answers that), on CPU
tensors its plain version ``ag_attention_reference``. At world 1 it is
``flash_attention`` (row 1), as JAX's is.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.ep_a2a import PIECE_BYTES, SHMEM_ARGTYPES
from triton_dist_tpu_torch.kernels.flash_attn import (
    LOG2E,
    NEG_INF,
    SUPPORTED_HEAD_DIMS,
    attention_flops,
    flash_attention,
)
from triton_dist_tpu_torch.kernels.sp import NEEDS_2D_MESH
from triton_dist_tpu_torch.runtime import mesh
from triton_dist_tpu_torch.shmem.symm import MAX_SLOTS, WS_BYTES

_U64, _SZ, _P, _I = ctypes.c_uint64, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "tdt_ag_attention": SHMEM_ARGTYPES + [_P] * 7 + [_I] * 6 + [ctypes.c_float, _I, _U64, _P, _SZ, _U64, _P],
}
#: The lane width of the TPU kernel's m/l/lse scratch (JAX ``flash_attn.LANES``),
#: a term of its VMEM plan.
LANES = 128
NEEDS_GLOBALTIMER = ("trace= records the TPU kernel's (arrive, compute) events; its Hopper form, globaltimer "
                     "records, is not ported (ROADMAP queue 1 item H)")


def ag_attention_supported(world: int, b: int, hq: int, hkv: int, s_loc: int, d: int, itemsize: int,
                           vmem_limit_mb: int = 100, with_residuals: bool = False) -> bool:
    """JAX's static VMEM-plan check of the TPU kernel, arithmetic unchanged:
    resident q and o, one visiting KV shard, the fp32 accumulator, the m/l
    lanes, the (gS, S_local) fp32 score/p/mask temporaries of its unblocked
    whole-shard product, and the LSE output with residuals, against
    ``vmem_limit_mb``. The port routes on it as JAX does (``AGSPAttn`` takes
    the ring where it is False; ``ag_attention_fn`` raises), so both packages
    choose the same path for a shape. The card's own limit is another one:
    the landing zones (2·world·B·Hkv·S_local·D·itemsize bytes) must fit the
    symmetric heap's workspace (``WS_BYTES``); ``ag_flash_attention_shard``
    raises where they do not."""
    bhkv = b * hkv
    gs = (hq // hkv) * s_loc
    q_o = 2 * bhkv * gs * d * itemsize
    kv = 2 * bhkv * s_loc * d * itemsize
    accs = bhkv * gs * d * 4
    ml = 2 * bhkv * gs * LANES * 4
    tmps = 3 * bhkv * gs * s_loc * 4
    lse_out = bhkv * gs * LANES * 4 if with_residuals else 0
    return q_o + kv + accs + ml + tmps + lse_out <= vmem_limit_mb * 1024 * 1024


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D (B, H, S_local, D)")
    b, hq, s_loc, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != s_loc or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[1]}")
    # One flash loop streams both landing zones: a mixed K/V pair would be
    # cast mid-attention (JAX asserts the same).
    if k.dtype != v.dtype:
        raise ValueError(f"k and v must share a dtype, got {k.dtype} and {v.dtype}")


def ag_attention_reference(ctx, q, k, v, *, causal: bool = True, scale: float | None = None,
                           return_residuals: bool = False):
    """Plain version of row 27: K and V all-gathered (``mesh.all_gather``),
    then the shards merged by one online softmax in the kernel's order (src
    = (rank - s) mod world, the local shard first; fp32 scores in the exp2
    domain, P cast to V's dtype before PV) under the blockwise-causal rule on
    global positions. Returns o, or o and (lse in nats, NEG_INF where a row
    saw no key; k_full; v_full)."""
    world, me = (1, 0) if ctx is None else (ctx.world, ctx.rank)
    b, hq, s_loc, d = q.shape
    group = hq // k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    k_full = k if world == 1 else mesh.all_gather(ctx, k.contiguous(), dim=2)
    v_full = v if world == 1 else mesh.all_gather(ctx, v.contiguous(), dim=2)
    rows = me * s_loc + torch.arange(s_loc, device=q.device)
    m = torch.full((b, hq, s_loc, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, hq, s_loc, 1), device=q.device)
    acc = torch.zeros((b, hq, s_loc, d), device=q.device)
    qf = q.float()
    for step in range(world):
        src = (me - step) % world
        cols = slice(src * s_loc, (src + 1) * s_loc)
        ks = k_full[:, :, cols].float().repeat_interleave(group, dim=1)
        vs = v_full[:, :, cols].repeat_interleave(group, dim=1).float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, ks) * (scale * LOG2E)
        if causal:
            keys = src * s_loc + torch.arange(s_loc, device=q.device)
            s = torch.where(rows[:, None] >= keys[None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(m_new <= NEG_INF * 0.5, torch.zeros_like(s), torch.exp2(s - m_new))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vs)
        m = m_new
    o = (acc / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)
    if not return_residuals:
        return o
    lse = torch.where(l == 0, torch.full_like(l, NEG_INF), (m + torch.log2(torch.clamp(l, min=1e-30))) / LOG2E)
    return o, (lse[..., 0], k_full, v_full)


def _launch(ctx, q, k, v, *, causal, scale, return_residuals):
    what = "ag_attn_kernel"
    if not (q.device == k.device == v.device == ctx.device):
        raise ValueError(f"{what}: q, k, v must lie on the context's device {ctx.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype:
        raise ValueError(f"{what} takes fp32 or bf16 q, k, v of one dtype, got {q.dtype}, {k.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what} needs contiguous operands")
    b, hq, s_loc, d = q.shape
    hkv, w = k.shape[1], ctx.world
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if b * hq > 65535 or s_loc == 0:
        raise ValueError(f"{what}: unsupported launch shape B*Hq={b * hq}, S_local={s_loc}")
    shard = k.numel() * k.element_size()
    if 2 * w * shard > WS_BYTES:
        raise ValueError(f"{what}: landing zones of 2 x {w} x {shard} bytes exceed the heap's workspace "
                         f"({WS_BYTES} bytes); use ring_attention_shard")
    piece = max(PIECE_BYTES, -(-shard // (MAX_SLOTS * 16)) * 16)
    scale = d ** -0.5 if scale is None else scale
    o = torch.empty_like(q)
    lse = k_full = v_full = None
    if return_residuals:
        lse = torch.empty((b, hq, s_loc), dtype=torch.float32, device=q.device)
        k_full = torch.empty((b, hkv, w * s_loc, d), dtype=k.dtype, device=k.device)
        v_full = torch.empty_like(k_full)
    heap, lib = ctx.heap, _build.load("ag_attention", _SIGNATURES)
    epoch = heap.next_epoch()
    land = heap.ws_off[epoch % 2]
    code = lib.tdt_ag_attention(*heap.args(epoch), _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
                                _build.ptr(lse), _build.ptr(k_full), _build.ptr(v_full), b, hq, hkv, s_loc, d,
                                int(causal), ctypes.c_float(scale * LOG2E), int(q.dtype == torch.bfloat16),
                                _U64(land), _P(heap.ptr(land)), piece, _U64(heap.flags_off[epoch % 2]),
                                _build.stream_ptr(q.device))
    _build.check(lib, code, what)
    return o, lse, k_full, v_full


def ag_attn_kernel(ctx, q, k, v, *, causal: bool = True, scale: float | None = None,
                   return_residuals: bool = False):
    """Row 27 at world > 1: ``ag_flash_attention_shard``'s multi-rank body.
    CUDA tensors launch the kernel (a push and the sweep on the current
    stream; with residuals, the gathered K and V copied out of the heap);
    CPU tensors run ``ag_attention_reference``."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return ag_attention_reference(ctx, q, k, v, causal=causal, scale=scale, return_residuals=return_residuals)
    o, lse, k_full, v_full = _launch(ctx, q, k, v, causal=causal, scale=scale, return_residuals=return_residuals)
    ag_attn_kernel.launches += 1
    return (o, (lse, k_full, v_full)) if return_residuals else o


#: Kernel launches so far (CUDA calls only).
ag_attn_kernel.launches = 0


def ag_flash_attention_shard(ctx, q, k, v, *, mesh_axes=None, causal: bool = True, scale: float | None = None,
                             vmem_limit_mb: int = 100, return_residuals: bool = False, trace=None):
    """Exact attention of this rank's q (B, Hq, S_local, D) over the whole
    world·S_local sequence, whose K and V (B, Hkv, S_local, D) shards lie one
    on each rank of ``ctx``. Returns o (B, Hq, S_local, D), or with
    ``return_residuals`` o and (lse (B, Hq, S_local) fp32 in nats, k_full,
    v_full (B, Hkv, world·S_local, D) in rank order): what
    ``function.ag_attention_fn``'s backward needs. World 1 (or no context)
    is ``flash_attention`` (row 1), residuals (lse, k, v).

    ``vmem_limit_mb`` is the TPU plan's budget, read only by
    ``ag_attention_supported`` where the callers route; the card's limit is
    the heap's workspace (see there). ``mesh_axes`` may be None or one axis;
    ``trace`` is not ported (both raise ``NotImplementedError``)."""
    if trace is not None:
        raise NotImplementedError(NEEDS_GLOBALTIMER)
    if mesh_axes is not None and not isinstance(mesh_axes, str) and len(tuple(mesh_axes)) != 1:
        raise NotImplementedError(NEEDS_2D_MESH)
    _check(q, k, v)
    if ctx is None or ctx.world == 1:
        if return_residuals:
            o, lse = flash_attention(q, k, v, causal=causal, scale=scale, return_lse=True)
            return o, (lse, k, v)
        return flash_attention(q, k, v, causal=causal, scale=scale)
    return ag_attn_kernel(ctx, q, k, v, causal=causal, scale=scale, return_residuals=return_residuals)


def ag_attention_cost(q: torch.Tensor, k: torch.Tensor, world: int, rank: int, *, causal: bool = True,
                      return_residuals: bool = False) -> tuple[int, int, int]:
    """(FLOPs, HBM bytes, NVLink bytes) of one rank's call: 4·D a visible
    (query, key) pair over the rank's global rows (the shards above the
    diagonal need none); q read and o written once, the world KV shards
    read once (the local one from its tensors, the others from the landing
    zones) and the world - 1 arriving ones written once, plus the LSE and
    the k_full, v_full copies with residuals; this rank's K and V shards
    cross NVLink once to each peer."""
    b, hq, s_loc, d = q.shape
    s_full = world * s_loc
    flops = attention_flops(b, hq, s_loc, s_full, d, causal=causal, q_off=rank * s_loc)
    shard = k.numel() * k.element_size()
    nbytes = 2 * q.numel() * q.element_size() + 2 * world * shard + 2 * (world - 1) * shard
    if return_residuals:
        nbytes += b * hq * s_loc * 4 + 2 * world * shard
    return flops, nbytes, 2 * (world - 1) * shard

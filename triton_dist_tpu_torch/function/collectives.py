"""``torch.autograd.Function``s over the port's kernels and collective
matmuls: counterpart of ``triton_dist_tpu/function/collectives.py``.

Each function's forward is the port's kernel or collective matmul; its
backward is the kernel or collective JAX's ``custom_vjp`` picks:

* ``ag_gemm_fn``  out = AG(x) @ B  ⇒  dx = RS(g @ Bᵀ) (``gemm_rs_shard``),
  dB = AG(x)ᵀ @ g on the ring (``_ring_weight_grad``);
* ``gemm_rs_fn``  out = RS(A @ B)  ⇒  dA = AG(g) @ Bᵀ (``ag_gemm_shard``,
  ``XLA_RING`` as in JAX), dB = Aᵀ @ AG(g) on the ring;
* ``gemm_ar_fn``  out = AR(A @ B)  ⇒  g summed over ranks, then local;
* ``all_to_all_single_fn``: its own transpose (row 25 both ways);
* ``group_gemm_swiglu_fn``: row 8 forward, the projections recomputed in
  the backward;
* the attention functions: rows 1 and 4 forward, rows 5 and 6 backward
  from the saved LSE; ``ring_attention_fn`` and
  ``ring_attention_varlen_fn`` rotate KV with ``ppermute_fn``, whose
  backward is the reverse rotation; ``ag_attention_fn`` runs row 27
  forward and row 5 over the gathered KV backward, then a reduce-scatter
  of dk and dv.

The collective functions take the port's ``DistContext`` first (None or
world 1: plain products), where JAX takes an axis name.

**Gradient convention.** JAX differentiates one program over the mesh;
here every rank runs its own ``backward`` on its own loss L_r. The port's
functions return the gradients of the total loss L = Σ_r L_r: a backward
that the forward's communication makes depend on other ranks' losses
reaches them with the collective JAX uses (a reduce-scatter, an
all-gather, an all-to-all, a ring rotation, or ``gemm_ar_fn``'s sum of the
cotangents). So the gradient of a tensor sharded over the ranks is complete
on its rank, and equals JAX's. A tensor that every rank holds whole (a
replicated weight fed to local code) gets this rank's contribution only;
``mesh.psum`` of the contributions is JAX's gradient. A loss that is the
same replicated value on every rank enters each L_r divided by the world
size (JAX's ``check_vma=False`` cotangent, split 1/world a rank).
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels import sp
from triton_dist_tpu_torch.kernels.ag_attention import ag_attention_supported, ag_flash_attention_shard
from triton_dist_tpu_torch.kernels.allgather_gemm import AGGemmMethod, ag_gemm_shard
from triton_dist_tpu_torch.kernels.ep_a2a import all_to_all_single_shard
from triton_dist_tpu_torch.kernels.flash_attn import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_varlen,
    flash_attention_varlen_bwd,
)
from triton_dist_tpu_torch.kernels.gemm_allreduce import gemm_ar_shard
from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import gemm_rs_shard
from triton_dist_tpu_torch.kernels.group_gemm import bmm_f32, group_gemm_swiglu, matmul_f32
from triton_dist_tpu_torch.kernels.sp import NEEDS_2D_MESH
from triton_dist_tpu_torch.runtime import mesh



def _world(ctx) -> int:
    return 1 if ctx is None else ctx.world


def _ring_weight_grad(ctx, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dB = AG(x)ᵀ @ g (fp32), chunk by chunk on the ring: step s holds rank
    ``(rank - s) % world``'s x chunk and multiplies it against that rank's
    row block of g (JAX ``_ring_weight_grad``)."""
    if _world(ctx) == 1:
        return matmul_f32(x.t(), g)
    m = x.shape[0]
    db = None
    for s, xc in enumerate(mesh.ring_ag_chunks(ctx, x)):
        j = (ctx.rank - s) % ctx.world
        part = matmul_f32(xc.t(), g[j * m:(j + 1) * m])
        db = part if db is None else db + part
    return db


# ------------------------------------------------------------------ ag_gemm


class _AGGemm(torch.autograd.Function):
    @staticmethod
    def forward(fctx, ctx, x, b):
        fctx.dist = ctx
        fctx.save_for_backward(x, b)
        return ag_gemm_shard(ctx, x, b)

    @staticmethod
    def backward(fctx, g):
        ctx = fctx.dist
        x, b = fctx.saved_tensors
        g = g.contiguous()
        dx = gemm_rs_shard(ctx, g, b.t().contiguous()).to(x.dtype)
        db = _ring_weight_grad(ctx, x, g).to(b.dtype)
        return None, dx, db


def ag_gemm_fn(ctx, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Differentiable ``all_gather(x) @ b``: x (m, k) this rank's rows, b (k,
    n_local) its columns → (world·m, n_local) (``ag_gemm_shard``; row 16
    above its crossover). Backward: dx = RS(g @ bᵀ) (``gemm_rs_shard``, row
    17 above its crossover), the sum over every rank's loss; db = AG(x)ᵀ @ g
    on the ring, complete on this rank."""
    return _AGGemm.apply(ctx, x, b)


# ------------------------------------------------------------------ gemm_rs


class _GemmRS(torch.autograd.Function):
    @staticmethod
    def forward(fctx, ctx, a, b):
        fctx.dist = ctx
        fctx.save_for_backward(a, b)
        return gemm_rs_shard(ctx, a, b)

    @staticmethod
    def backward(fctx, g):
        ctx = fctx.dist
        a, b = fctx.saved_tensors
        g = g.contiguous()
        da = ag_gemm_shard(ctx, g, b.t().contiguous(), method=AGGemmMethod.XLA_RING).to(a.dtype)
        db = _ring_weight_grad(ctx, g, a).t().to(b.dtype)
        return None, da, db


def gemm_rs_fn(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Differentiable ``reduce_scatter(a @ b)``: a (m, k_local), b (k_local,
    n) → (m / world, n) this rank's rows (``gemm_rs_shard``; row 17 above its
    crossover). Backward: da = AG(g) @ bᵀ on the plain ring (JAX's
    ``XLA_RING``) and db = aᵀ @ AG(g), both complete on this rank."""
    return _GemmRS.apply(ctx, a, b)


# ------------------------------------------------------------------ gemm_ar


class _GemmAR(torch.autograd.Function):
    @staticmethod
    def forward(fctx, ctx, a, b):
        fctx.dist = ctx
        fctx.save_for_backward(a, b)
        return gemm_ar_shard(ctx, a, b)

    @staticmethod
    def backward(fctx, g):
        ctx = fctx.dist
        a, b = fctx.saved_tensors
        if _world(ctx) > 1:
            g = mesh.psum(ctx, g.contiguous())
        da = matmul_f32(g, b.t()).to(a.dtype)
        db = matmul_f32(a.t(), g).to(b.dtype)
        return None, da, db


def gemm_ar_fn(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Differentiable ``all_reduce(a @ b)``: a (m, k_local), b (k_local, n) →
    (m, n), the same on every rank (``gemm_ar_shard``: row 19 for small or
    ragged m, row 18 above). Backward: the output is replicated, so the
    total loss's cotangent is the sum of the ranks' cotangents, which
    ``mesh.psum`` forms (JAX's ``psum(g)``); then da = g @ bᵀ and db = aᵀ @
    g are local and complete. A replicated loss counted once enters each
    rank's loss divided by the world size."""
    return _GemmAR.apply(ctx, a, b)


# ------------------------------------------------------------- all_to_all


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(fctx, ctx, x, use_pallas):
        fctx.dist, fctx.use_pallas = ctx, use_pallas
        return all_to_all_single_shard(ctx, x.contiguous(), use_pallas=use_pallas)

    @staticmethod
    def backward(fctx, g):
        return None, all_to_all_single_shard(fctx.dist, g.contiguous(), use_pallas=fctx.use_pallas), None


def all_to_all_single_fn(ctx, x: torch.Tensor, use_pallas: bool = True) -> torch.Tensor:
    """Differentiable expert-parallel all-to-all: x (world, chunk, d), ``x[p]``
    bound for rank p. An all-to-all is a permutation, so its transpose is
    the same all-to-all: the backward sends each rank its rows' cotangents
    (row 25 both ways with ``use_pallas``)."""
    return _AllToAll.apply(ctx, x, use_pallas)


# ----------------------------------------------------------- fused swiglu


class _GroupSwiGLU(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, w_gate, w_up):
        fctx.save_for_backward(x, w_gate, w_up)
        return group_gemm_swiglu(x.contiguous(), w_gate.contiguous(), w_up.contiguous())

    @staticmethod
    def backward(fctx, dh):
        x, w_gate, w_up = fctx.saved_tensors
        g = bmm_f32(x, w_gate)
        u = bmm_f32(x, w_up)
        sg = torch.sigmoid(g)
        dh32 = dh.float()
        du = dh32 * (g * sg)  # d/du silu(g)·u
        dg = dh32 * u * (sg * (1.0 + g * (1.0 - sg)))  # silu'(g)
        dx = bmm_f32(dg, w_gate.float().transpose(1, 2)) + bmm_f32(du, w_up.float().transpose(1, 2))
        xf = x.float().transpose(1, 2)
        return dx.to(x.dtype), bmm_f32(xf, dg).to(w_gate.dtype), bmm_f32(xf, du).to(w_up.dtype)


def group_gemm_swiglu_fn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor) -> torch.Tensor:
    """Differentiable fused per-expert gate/up + SwiGLU: x (E, C, d), w_gate
    and w_up (E, d, f) → (E, C, f) (``group_gemm_swiglu``, row 8). The
    backward recomputes the two projections (nothing (E, C, f)-sized is
    saved) and runs its products in fp32, as JAX's ``dot_general``s."""
    return _GroupSwiGLU.apply(x, w_gate, w_up)


# ------------------------------------------------------ flash attention


class _FlashLSE(torch.autograd.Function):
    @staticmethod
    def forward(fctx, q, k, v, q_offset, kv_offset, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention(q, k, v, causal=causal, scale=scale, return_lse=True,
                                 q_offset=q_offset, kv_offset=kv_offset)
        fctx.save_for_backward(q, k, v, o, lse)
        fctx.args = dict(causal=causal, scale=scale, q_offset=q_offset, kv_offset=kv_offset)
        return o, lse

    @staticmethod
    def backward(fctx, do, dlse):
        q, k, v, o, lse = fctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, dlse=dlse, **fctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention_fn(q, k, v, causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """Differentiable flash attention: q (B, Hq, S, D), k, v (B, Hkv, S_k, D)
    → o. Forward ``flash_attention`` (row 1), backward
    ``flash_attention_bwd`` (row 5) from the saved LSE: O(S) memory."""
    return _FlashLSE.apply(q, k, v, None, None, causal, scale)[0]


def flash_attention_lse_fn(q, k, v, q_offset, kv_offset, causal: bool = True,
                           scale: float | None = None):
    """Differentiable flash attention returning (o, lse), the ring step:
    ``q_offset``/``kv_offset`` (ints, no gradient) place the shards in global
    positions. Both outputs are differentiable: the LSE's cotangent folds
    into the backward's δ, which is how the ring's merge gradients reach
    each step."""
    return _FlashLSE.apply(q, k, v, q_offset, kv_offset, causal, scale)


class _FlashVarlenLSE(torch.autograd.Function):
    @staticmethod
    def forward(fctx, q, k, v, cu_seqlens, q_offset, kv_offset, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention_varlen(q, k, v, cu_seqlens, scale=scale, return_lse=True,
                                        q_offset=q_offset, kv_offset=kv_offset)
        fctx.save_for_backward(q, k, v, o, lse)
        fctx.args = dict(scale=scale, q_offset=q_offset, kv_offset=kv_offset)
        fctx.cu_seqlens = cu_seqlens
        return o, lse

    @staticmethod
    def backward(fctx, do, dlse):
        q, k, v, o, lse = fctx.saved_tensors
        dq, dk, dv = flash_attention_varlen_bwd(q, k, v, o, lse, do, fctx.cu_seqlens, dlse=dlse, **fctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention_varlen_fn(q, k, v, cu_seqlens, scale: float | None = None) -> torch.Tensor:
    """Differentiable varlen (packed-sequence) flash attention: q (Hq, T, D),
    k, v (Hkv, T, D), ``cu_seqlens`` data (no gradient). Forward
    ``flash_attention_varlen`` (row 4), backward
    ``flash_attention_varlen_bwd`` (row 6)."""
    return _FlashVarlenLSE.apply(q, k, v, cu_seqlens, None, None, scale)[0]


def flash_attention_varlen_lse_fn(q, k, v, cu_seqlens, q_offset, kv_offset, scale: float | None = None):
    """Differentiable varlen flash attention returning (o, lse), the varlen
    ring step: ``cu_seqlens`` is global, the offsets place this call's rows
    and keys in the packed stream; the LSE's cotangent folds into δ."""
    return _FlashVarlenLSE.apply(q, k, v, cu_seqlens, q_offset, kv_offset, scale)


# ------------------------------------------------------------------ rings


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(fctx, ctx, x, shift):
        fctx.dist, fctx.shift = ctx, shift
        return mesh.ppermute(ctx, x, shift)

    @staticmethod
    def backward(fctx, g):
        return None, mesh.ppermute(fctx.dist, g.contiguous(), -fctx.shift), None


def ppermute_fn(ctx, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """Differentiable ring shift (``mesh.ppermute``): the backward shifts the
    cotangent back the other way."""
    return _PPermute.apply(ctx, x, shift)


def ring_attention_fn(ctx, q, k, v, *, causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """Differentiable ring attention (long-context training): q, k, v (B,
    Hq|Hkv, S_local, D) this rank's sequence shard. The KV shard rotates
    around the ring (``ppermute_fn``); each step is one
    ``flash_attention_lse_fn`` at the step's global offsets and the
    partials merge by LSE (``kernels.sp.ring_schedule``). dq is complete on
    this rank; dk and dv ride the reverse rotation back to their owner, so
    they sum every rank's contribution."""
    if _world(ctx) == 1:
        return flash_attention_lse_fn(q, k, v, 0, 0, causal, scale)[0]

    def attend(q_, k_, v_, q_off, kv_off, causal_step):
        return flash_attention_lse_fn(q_, k_, v_, q_off, kv_off, causal_step, scale)

    return sp.ring_schedule(ctx, q, k, v, causal=causal, attend=attend, permute=ppermute_fn)


def ring_attention_varlen_fn(ctx, q, k, v, cu_seqlens, *, scale: float | None = None) -> torch.Tensor:
    """Differentiable varlen ring attention (packed-sequence training at
    ring scale): q, k, v (Hq|Hkv, S_local, D) shards of one packed stream;
    ``cu_seqlens`` holds global document offsets. Each step is one
    ``flash_attention_varlen_lse_fn`` at the step's global offsets."""
    def attend(q_, k_, v_, q_off, kv_off, causal_step):
        b, hq, s_loc, d = q_.shape
        o, lse = flash_attention_varlen_lse_fn(q_.reshape(b * hq, s_loc, d), k_.reshape(-1, s_loc, d),
                                               v_.reshape(-1, s_loc, d), cu_seqlens, q_off, kv_off, scale)
        return o.reshape(b, hq, s_loc, d), lse.reshape(b, hq, s_loc)

    if _world(ctx) == 1:
        return attend(q[None], k[None], v[None], 0, 0, True)[0][0]
    return sp.ring_schedule(ctx, q[None], k[None], v[None], causal=True, attend=attend,
                            permute=ppermute_fn)[0]


def ring_attention_2d_fn(*args, **kwargs):
    """The two-level ring (JAX ``ring_attention_2d_fn``): not ported; raises."""
    raise NotImplementedError(NEEDS_2D_MESH)


def ring_attention_2d_varlen_fn(*args, **kwargs):
    """The two-level varlen ring (JAX ``ring_attention_2d_varlen_fn``): not
    ported; raises."""
    raise NotImplementedError(NEEDS_2D_MESH)


# ------------------------------------------------------------ AG attention


def _ag_attn_check(ctx, q, k, vmem_limit_mb):
    """Raise where JAX's ``ag_attention_fn`` raises: the TPU plan with the
    LSE residuals does not fit (world 1 takes row 1 and is never refused)."""
    if _world(ctx) == 1:
        return
    b, hq, s_loc, d = q.shape
    if not ag_attention_supported(ctx.world, b, hq, k.shape[1], s_loc, d, q.element_size(), vmem_limit_mb,
                                  with_residuals=True):
        raise ValueError("ag_attention_fn: the fused kernel's VMEM plan (with LSE residuals) does not fit this "
                         "shape — use ring_attention_fn (O(S_local) residency) for long-context training")


class _AGAttention(torch.autograd.Function):
    @staticmethod
    def forward(fctx, ctx, q, k, v, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, (lse, k_full, v_full) = ag_flash_attention_shard(ctx, q, k, v, causal=True, scale=scale,
                                                            return_residuals=True)
        fctx.save_for_backward(q, k_full, v_full, o, lse)
        fctx.dist, fctx.scale = ctx, scale
        return o

    @staticmethod
    def backward(fctx, do):
        ctx = fctx.dist
        q, k_full, v_full, o, lse = fctx.saved_tensors
        world = _world(ctx)
        q_off = 0 if world == 1 else ctx.rank * q.shape[2]
        dq, dk_full, dv_full = flash_attention_bwd(q, k_full, v_full, o, lse, do.contiguous(), causal=True,
                                                   scale=fctx.scale, q_offset=q_off, kv_offset=0)
        if world == 1:
            return None, dq, dk_full, dv_full, None

        def scatter(g):
            # Shard j's gradient is the sum over the ranks of block j of
            # theirs: summed in fp32, cast once (JAX's psum_scatter of the
            # fp32 gradients); the sequence dimension goes first for the
            # row split.
            part = mesh.psum_scatter(ctx, g.float().permute(2, 0, 1, 3).contiguous())
            return part.permute(1, 2, 0, 3).to(g.dtype).contiguous()

        return None, dq, scatter(dk_full), scatter(dv_full), None


def ag_attention_fn(ctx, q, k, v, *, scale: float | None = None, vmem_limit_mb: int = 100) -> torch.Tensor:
    """Differentiable fused all-gather attention (causal): q (B, Hq, S_local,
    D), k, v (B, Hkv, S_local, D) this rank's sequence shard. Forward: row 27
    with its residuals (the LSE and the gathered K and V, which its landing
    zones hold anyway), so the backward gathers nothing: row 5 over the
    gathered K and V at this rank's global offset, then a reduce-scatter
    (``mesh.psum_scatter``, in fp32, cast once) returns each KV shard's
    gradient, summed over every rank's loss, to its owner. dq is complete on
    this rank. Raises where JAX's does (``ag_attention_supported`` with the
    residuals, at ``vmem_limit_mb``); at world 1 it is row 1 and row 5.
    Memory: each rank keeps the whole gathered K and V until the backward;
    ``ring_attention_fn`` keeps O(S_local)."""
    _ag_attn_check(ctx, q, k, vmem_limit_mb)
    return _AGAttention.apply(ctx, q, k, v, scale)

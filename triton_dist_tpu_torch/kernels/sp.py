"""Sequence parallelism: the blockwise-causal ring, Ulysses' head-scatter
all-to-all, and the fused Ulysses GEMM↔all-to-all functions. Counterpart of
``triton_dist_tpu/kernels/sp.py``.

* **The ring** (``ring_schedule``, ``ring_attention_shard``): Q stays put
  and the KV shard rotates ``world`` times around the ranks; each step is one
  offset-masked attention call (row 1, or row 4 over packed documents)
  whose partial (o, lse) merges into the running one by log-sum-exp. Every
  rank runs the same steps: the mask is data (the offsets), so a step above
  the diagonal is an attention call that sees no key and returns lse
  ``NEG_INF``, whose merge weight is 0.
* **Ulysses** (``ulysses_attention_shard``): one all-to-all turns
  (sequence-sharded, all heads) into (head-sharded, whole sequence),
  attention runs over the whole sequence (row 1), and a second all-to-all
  turns it back. The all-to-all is row 25 (``use_pallas``) or the plain one
  of ``runtime/mesh.py``.
* **The fused Ulysses GEMM↔all-to-all** (``gemm_a2a_shard``,
  ``a2a_gemm_shard`` and the QKV / O projections over them): JAX writes them
  with ``jnp.dot`` and ``lax.ppermute`` outside any Pallas kernel, so here
  they are fp32-accumulating products and ``mesh.ppermute``.

Every function takes the port's ``DistContext`` first (None or world 1: one
rank), where JAX takes an axis name. The two-level ring
(``ring_attention_2d_shard``, ``ring_2d_schedule``) needs a two-axis mesh
and raises.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels.ep_a2a import all_to_all_single_shard
from triton_dist_tpu_torch.kernels.flash_attn import NEG_INF, flash_attention, flash_attention_varlen
from triton_dist_tpu_torch.kernels.group_gemm import matmul_f32
from triton_dist_tpu_torch.runtime import mesh

NEEDS_2D_MESH = ("the two-level (DCN x ICI) rings need a two-axis mesh; the port's DistContext is one "
                 "ring of ranks (ROADMAP queue 1 item D1)")


def _world_rank(ctx) -> tuple[int, int]:
    return (1, 0) if ctx is None else (ctx.world, ctx.rank)


def _merge_partials(o1, lse1, o2, lse2):
    """Merge two normalised attention partials by their LSEs (fp32).

    An LSE below the finite ``NEG_INF`` (-1e30) is clamped to it, so a step
    that saw no key weighs 0 and ``lse - m`` never becomes inf - inf."""
    lse1 = torch.clamp(lse1.float(), min=NEG_INF)
    lse2 = torch.clamp(lse2.float(), min=NEG_INF)
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    denom = w1 + w2
    o = o1.float() * (w1 / denom)[..., None] + o2.float() * (w2 / denom)[..., None]
    return o.to(o1.dtype), m + torch.log(denom)


def ring_schedule(ctx, q, k, v, *, causal: bool, attend, permute) -> torch.Tensor:
    """The blockwise-causal ring over ``ctx``'s ranks. q, k, v: (B, H, S_local,
    D) this rank's sequence shard. KV shard j (global block j) against this
    rank's Q shard: j < rank unmasked, j == rank causal, j > rank masked
    whole. ``attend(q, k, v, q_off, kv_off, causal_step)`` returns the
    step's (o, lse); ``permute(ctx, x, shift)`` moves a tensor one rank on
    (``mesh.ppermute``, or the differentiable ``function.ppermute_fn``)."""
    world, me = ctx.world, ctx.rank
    s_loc = q.shape[2]
    o = lse = None
    k_cur, v_cur = k, v
    for step in range(world):
        j = (me - step) % world  # owner of the visiting KV shard
        if causal:
            o_step, lse_step = attend(q, k_cur, v_cur, me * s_loc, j * s_loc, True)
        else:
            o_step, lse_step = attend(q, k_cur, v_cur, 0, 0, False)
        if o is None:
            o, lse = o_step, lse_step
        else:
            o, lse = _merge_partials(o, lse, o_step, lse_step)
        if step + 1 < world:
            k_cur = permute(ctx, k_cur, 1)
            v_cur = permute(ctx, v_cur, 1)
    return o


def _flash_attend(scale):
    """The ring-step attend of ``ring_schedule`` over row 1."""

    def attend(q_, k_, v_, q_off, kv_off, causal_step):
        return flash_attention(q_, k_, v_, causal=causal_step, scale=scale, return_lse=True,
                               q_offset=q_off if causal_step else None, kv_offset=kv_off if causal_step else None)

    return attend


def fold_batch_into_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) → (B·H, S, D): the batch lift of the varlen kernel, which
    takes heads first and no batch. GQA grouping survives the fold: folded q
    head ``b·Hq + h`` divided by the group is ``b·Hkv + h // group``, its kv
    head's folded index. One ``cu_seqlens`` serves every batch element."""
    b, h, s, d = x.shape
    return x.reshape(b * h, s, d)


def _varlen_attend(cu_seqlens, scale):
    """The ring-step attend of ``ring_schedule`` over row 4 at the step's
    global offsets, batch folded into heads: the segment mask makes full,
    diagonal and cross-document steps the same call."""

    def attend(q_, k_, v_, q_off, kv_off, causal_step):
        b, hq, s_loc, d = q_.shape
        o, lse = flash_attention_varlen(fold_batch_into_heads(q_), fold_batch_into_heads(k_),
                                        fold_batch_into_heads(v_), cu_seqlens, scale=scale, return_lse=True,
                                        q_offset=q_off, kv_offset=kv_off)
        return o.reshape(b, hq, s_loc, d), lse.reshape(b, hq, s_loc)

    return attend


def ring_attention_shard(ctx, q, k, v, *, causal: bool = True, scale: float | None = None, block_q: int = 256,
                         block_k: int = 256, cu_seqlens=None) -> torch.Tensor:
    """Exact attention over the whole world·S_local sequence with q (B, Hq,
    S_local, D) and k, v (B, Hkv, S_local, D) sequence-sharded: the ring over
    row 1, the shards rotating on ``mesh.ppermute``. ``cu_seqlens`` (global
    offsets of the packed documents in the world·S_local stream) runs every
    step through row 4 and implies causal; B > 1 folds into heads (B
    streams with the same documents). ``block_q``/``block_k`` are the TPU
    kernel's blocks, kept for JAX's signature: the port's kernels have
    fixed tiles."""
    world, _ = _world_rank(ctx)
    if cu_seqlens is not None:
        if not causal:
            raise ValueError("cu_seqlens implies causal packed attention; causal=False is not supported on the "
                             "varlen ring")
        attend = _varlen_attend(cu_seqlens, scale)
        if world == 1:
            return attend(q, k, v, 0, 0, True)[0]
        return ring_schedule(ctx, q, k, v, causal=True, attend=attend, permute=mesh.ppermute)
    if world == 1:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    return ring_schedule(ctx, q, k, v, causal=causal, attend=_flash_attend(scale), permute=mesh.ppermute)


def ring_attention_2d_shard(*args, **kwargs):
    """The two-level ring (JAX ``ring_attention_2d_shard``): not ported; raises."""
    raise NotImplementedError(NEEDS_2D_MESH)


def ring_2d_schedule(*args, **kwargs):
    """The two-level ring driver (JAX ``ring_2d_schedule``): not ported; raises."""
    raise NotImplementedError(NEEDS_2D_MESH)


# ------------------------------------------------------------------ Ulysses


def ulysses_a2a_qkv(ctx, x: torch.Tensor, *, use_pallas: bool = False) -> torch.Tensor:
    """Sequence → head re-shard: x (B, S_local, H, D), all heads of this
    rank's sequence block, → (B, world·S_local, H / world, D), head group
    ``rank`` over the whole sequence. Chunk p of the all-to-all is head
    group p; what arrives from rank p is its sequence block."""
    world, _ = _world_rank(ctx)
    b, s_loc, h, d = x.shape
    if h % world:
        raise ValueError(f"{h} heads do not split over {world} ranks")
    h_loc = h // world
    send = x.reshape(b, s_loc, world, h_loc, d).permute(2, 0, 1, 3, 4).reshape(world, b * s_loc, h_loc * d)
    recv = all_to_all_single_shard(ctx, send.contiguous(), use_pallas=use_pallas)
    return recv.reshape(world, b, s_loc, h_loc, d).permute(1, 0, 2, 3, 4).reshape(b, world * s_loc, h_loc, d)


def ulysses_a2a_out(ctx, x: torch.Tensor, *, use_pallas: bool = False) -> torch.Tensor:
    """Head → sequence re-shard back: x (B, world·S_local, H_local, D) →
    (B, S_local, world·H_local, D). Chunk p is rank p's sequence block; what
    arrives from rank p is head group p of this rank's block."""
    world, _ = _world_rank(ctx)
    b, s_full, h_loc, d = x.shape
    if s_full % world:
        raise ValueError(f"a sequence of {s_full} does not split over {world} ranks")
    s_loc = s_full // world
    send = x.reshape(b, world, s_loc, h_loc, d).permute(1, 0, 2, 3, 4).reshape(world, b * s_loc, h_loc * d)
    recv = all_to_all_single_shard(ctx, send.contiguous(), use_pallas=use_pallas)
    return recv.reshape(world, b, s_loc, h_loc, d).permute(1, 2, 0, 3, 4).reshape(b, s_loc, world * h_loc, d)


def ulysses_attention_shard(ctx, q, k, v, *, causal: bool = True, scale: float | None = None,
                            use_pallas_a2a: bool = False) -> torch.Tensor:
    """Ulysses attention: q (B, S_local, Hq, D), k, v (B, S_local, Hkv, D),
    sequence-sharded; an all-to-all to head sharding, row 1 over the whole
    sequence, an all-to-all back. Hq and Hkv must split over the ranks."""
    qh = ulysses_a2a_qkv(ctx, q, use_pallas=use_pallas_a2a)
    kh = ulysses_a2a_qkv(ctx, k, use_pallas=use_pallas_a2a)
    vh = ulysses_a2a_qkv(ctx, v, use_pallas=use_pallas_a2a)
    o = flash_attention(qh.transpose(1, 2).contiguous(), kh.transpose(1, 2).contiguous(),
                        vh.transpose(1, 2).contiguous(), causal=causal, scale=scale)
    return ulysses_a2a_out(ctx, o.transpose(1, 2), use_pallas=use_pallas_a2a)


# ------------------------------------------------ fused Ulysses GEMM ↔ a2a


def gemm_a2a_shard(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Producer GEMM → all-to-all: ``w``'s columns split into ``world`` peer
    chunks; chunk p of ``x @ w`` (fp32 accumulate, cast to x's dtype) goes to
    peer p, step s sending to rank + s. Returns (world, m, n / world): row j
    holds the chunk rank j computed for this rank."""
    world, me = _world_rank(ctx)
    n = w.shape[1]
    if n % world:
        raise ValueError(f"{n} columns do not split over {world} ranks")
    nc = n // world
    parts = []
    for s in range(world):
        dst = (me + s) % world
        g = matmul_f32(x, w[:, dst * nc:(dst + 1) * nc]).to(x.dtype)
        parts.append(g if s == 0 else mesh.ppermute(ctx, g, s))
    # parts[s] came from rank (me - s) % world.
    return torch.stack([parts[(me - j) % world] for j in range(world)])


def a2a_gemm_shard(ctx, x_chunks: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """All-to-all → consumer GEMM: ``x_chunks[p]`` (m, k / world) is this
    rank's payload for peer p; each arriving chunk multiplies its row block
    of ``w`` into an fp32 sum, step s receiving from rank - s. Returns (m, n)
    = concat_k(all_to_all(x_chunks)) @ w in x's dtype."""
    world, me = _world_rank(ctx)
    n_chunks, m, kc = x_chunks.shape
    if n_chunks != world:
        raise ValueError(f"{n_chunks} chunks for {world} ranks")
    acc = torch.zeros((m, w.shape[1]), dtype=torch.float32, device=x_chunks.device)
    for s in range(world):
        sent = x_chunks[(me + s) % world]
        rec = sent if s == 0 else mesh.ppermute(ctx, sent.contiguous(), s)
        src = (me - s) % world
        acc = acc + matmul_f32(rec, w[src * kc:(src + 1) * kc])
    return acc.to(x_chunks.dtype)


def ulysses_qkv_gemm_a2a_shard(ctx, x: torch.Tensor, wqkv: torch.Tensor, *, num_q_heads: int, num_kv_heads: int,
                               head_dim: int):
    """QKV projection fused with the sequence → head re-shard: x (B, S_local,
    d_model), ``wqkv`` (d_model, (Hq + 2·Hkv)·D) with columns head-group-major
    (group p holds its [q_p | k_p | v_p] columns together). Returns q (B,
    world·S_local, Hq / world, D), k, v (B, world·S_local, Hkv / world, D)."""
    world, _ = _world_rank(ctx)
    b, s_loc, d = x.shape
    hq_l, hkv_l = num_q_heads // world, num_kv_heads // world
    recv = gemm_a2a_shard(ctx, x.reshape(b * s_loc, d), wqkv)
    recv = recv.reshape(world, b, s_loc, -1).transpose(0, 1).reshape(b, world * s_loc, hq_l + 2 * hkv_l, head_dim)
    return recv[:, :, :hq_l], recv[:, :, hq_l:hq_l + hkv_l], recv[:, :, hq_l + hkv_l:]


def ulysses_o_a2a_gemm_shard(ctx, o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """The head → sequence re-shard fused with the O projection: o (B,
    world·S_local, H_local, D) head-sharded, ``wo`` (H·D, d_model) with rows
    head-group-major. Returns (B, S_local, d_model)."""
    world, _ = _world_rank(ctx)
    b, s_full, h_loc, hd = o.shape
    s_loc = s_full // world
    chunks = o.reshape(b, world, s_loc, h_loc, hd).transpose(0, 1).reshape(world, b * s_loc, h_loc * hd)
    return a2a_gemm_shard(ctx, chunks, wo).reshape(b, s_loc, -1)

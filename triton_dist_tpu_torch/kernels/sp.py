"""Sequence parallelism: the blockwise-causal ring schedule and the LSE
merge of its partials.

Counterpart of the part of ``triton_dist_tpu/kernels/sp.py`` that the
training rings need (``_merge_partials``, ``ring_schedule``). Q stays put
and the KV shard rotates ``world`` times around the ring; each step is one
offset-masked attention call whose partial (o, lse) merges into the running
one by log-sum-exp. Every rank runs the same steps: the mask is data (the
offsets), so a step above the diagonal is an attention call that sees no key
and returns lse ``NEG_INF``, whose merge weight is 0. The rest of JAX's
module (the inference rings, Ulysses) is not ported.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels.flash_attn import NEG_INF


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

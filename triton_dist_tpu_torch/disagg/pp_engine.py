"""TP×PP engine programs: counterpart of
``triton_dist_tpu/disagg/pp_engine.py`` (``build_pp_programs``).

``Engine`` calls ``build_pp_programs`` when its model's context has a
``pp`` axis of more than one stage (``models/dense.py``). Two functions come
back, in place of the model's ``prefill`` and ``decode``:

* **prefill** ``(tokens (B, S)) -> (logits, (ks, vs))``: one microbatch per
  prompt row through ``gpipe_forward`` over ``PPCommLayer``; stage s runs
  its contiguous ``L / S`` layers (``gpipe_stage_params`` of the model's
  ``layers``) and records its KV through the schedule's aux channel.
  The last stage's last-token hidden states are broadcast over ``pp`` (an
  all-gather pick, bitwise), then the final norm and the lm_head run on
  every rank.
* **decode** ``(token, ks, vs, lengths) -> logits``: slot groups round-robin
  across the stages, ``B / S`` rows a group when ``S`` divides ``B`` (one
  group of all rows otherwise), so ``G + S - 1`` ticks, each stage updating
  its own layers' slice of the cache for every group. A masked tick skips
  the stage (the ranks of a stage share its mask, and its cache rows belong
  to the stage active on that group) and sends zeros, as JAX's does.

Where JAX gathers every stage's KV slab over ``pp`` after each call, every
rank here keeps its stage's layers only: a pipeline engine's caches are
``(L / S, B, Hkv / tp, T, D)``. That halves the cache and saves gathering
the whole cache at every step (at Qwen3-8B, tp 2, a stage's K slab of B 4
passes the 32 MiB plain slot of ``runtime/mesh.py`` at ``max_len`` ≈ 455).
Every KV row and every logit row is computed by exactly one stage with the
layer loops of ``DenseLLM.prefill`` and ``decode``
(``prefill_layers``, ``decode_layers``), so the streams are the
tensor-parallel engine's bits wherever the products give the same bits for
one row as for B rows.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.layers.pp import PPCommLayer
from triton_dist_tpu_torch.layers.pp_schedule import gpipe_forward, gpipe_stage_params
from triton_dist_tpu_torch.runtime.mesh import all_gather


def build_pp_programs(engine):
    """``(prefill, decode)`` for ``engine`` over its model's ``pp`` × ``tp``
    context; the caches they take and return hold this stage's layers."""
    model = engine.model
    pp = model.pp_ctx
    c = model.config
    S, L = pp.world, c.num_layers
    if L % S:
        raise ValueError(f"num_layers={L} must divide over pp={S} stages "
                         "(gpipe_stage_params assigns contiguous L/S blocks)")
    per, me = L // S, pp.rank
    hkv, hd, d = c.num_kv_heads // model.world, c.head_dim, c.hidden_size
    prefill_mode, decode_mode = engine.prefill_mode, engine.decode_mode
    layers = gpipe_stage_params(model.layers, L, ctx=pp)
    comm = PPCommLayer(pp, "pp")
    embed = model.params.embed

    def last_stage(h: torch.Tensor) -> torch.Tensor:
        """The last stage's ``h``, on every stage (an all-gather pick)."""
        return all_gather(pp, h[None], 0)[S - 1]

    @torch.no_grad()
    def prefill(tokens):
        tokens = model._tokens(tokens)
        bsz, seq = tokens.shape
        pos1 = torch.arange(seq, dtype=torch.int32, device=model.device)[None]

        def stage_fn(xm):  # (seq, d): one prompt row through this stage's layers
            ks = torch.empty((per, 1, hkv, seq, hd), dtype=xm.dtype, device=xm.device)
            vs = torch.empty_like(ks)
            return model.prefill_layers(xm, pos1, 1, prefill_mode, layers, ks, vs), (ks, vs)

        x = embed[tokens]  # (B, seq, d): stage 0 injects one row a microbatch
        aux0 = tuple(torch.zeros((bsz, per, 1, hkv, seq, hd), dtype=x.dtype, device=x.device) for _ in range(2))
        out, (k_aux, v_aux) = gpipe_forward(stage_fn, x, ctx=pp, comm=comm, aux_init=aux0)
        logits = model._logits(model.final_norm(last_stage(out[:, -1])))
        # (B, per, 1, Hkv, seq, D) → this stage's (per, B, Hkv, seq, D)
        return logits, (k_aux[:, :, 0].transpose(0, 1).contiguous(), v_aux[:, :, 0].transpose(0, 1).contiguous())

    @torch.no_grad()
    def decode(token, ks, vs, lengths):
        token = model._tokens(token)
        B = token.shape[0]
        gsz = B // S if (B % S == 0 and B >= S) else B
        G = B // gsz
        steps = G + S - 1
        recv = torch.zeros((gsz, d), dtype=embed.dtype, device=model.device)
        fin = torch.zeros((B, d), dtype=embed.dtype, device=model.device)
        for t in range(steps):
            g = t - me
            if 0 <= g < G:
                r = slice(g * gsz, (g + 1) * gsz)
                x = embed[token[r]] if me == 0 else recv
                y = model.decode_layers(x, lengths[r], ks[:, r], vs[:, r], decode_mode, layers)
                if me == S - 1:
                    fin[r] = y
            else:
                y = torch.zeros_like(recv)
            if t + 1 < steps:
                recv = comm.send_next(y)
        return model._logits(model.final_norm(last_stage(fin)))

    return prefill, decode

"""Pipeline-parallel microbatch scheduling (GPipe) over the stage handoff:
counterpart of ``triton_dist_tpu/layers/pp_schedule.py`` (``gpipe_forward``,
``gpipe_stage_params``).

At tick ``t`` stage ``s`` works on microbatch ``m = t - s``; the schedule
runs ``M + S - 1`` ticks and every rank runs every tick: a masked tick
(``m`` outside ``[0, M)``) computes its stage on zeros and throws the result
away, so the stage function, and any collective inside it, runs alike on
every rank, as JAX's uniform program does. The handoff is
``PPCommLayer.send_next``; it is differentiable (the gradient rides
``send_prev``), so ``backward`` through the schedule is the reversed
pipeline. With autograd on, the choices between the injected microbatch,
the wire and zeros go through ``torch.where``, so every rank's graph holds
every handoff and every rank runs each backward handoff, a collective, in
the same order.
"""

from __future__ import annotations

from typing import Callable

import torch

from triton_dist_tpu_torch.layers.pp import PPCommLayer


def _pick(flag: bool, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` if ``flag`` else ``b``, bit for bit; through ``torch.where``
    (the mask made on the card, no host copy) when autograd records."""
    if not torch.is_grad_enabled():
        return a if flag else b
    return torch.where(torch.full((), flag, dtype=torch.bool, device=a.device), a, b)


def _tick(stage_fn, x, recv, outs, aux, t, *, me, world, m_total):
    """One GPipe tick, shared by both schedule bodies: stage ``me`` handles
    microbatch ``t - me``. Returns the stage's output (zeros on a masked
    tick); ``outs`` (the last stage's finished microbatches) and the aux
    buffers are updated in place."""
    m = t - me
    active = 0 <= m < m_total
    m_idx = min(max(m, 0), m_total - 1)
    # Stage 0 injects fresh microbatches; later stages consume the wire.
    inp = _pick(me == 0, x[m_idx], recv)
    zeros = torch.zeros_like(inp)
    inp = _pick(active, inp, zeros)
    if aux is None:
        y, a = stage_fn(inp), None
    else:
        y, a = stage_fn(inp)
    y = _pick(active, y, torch.zeros_like(y))
    outs[m_idx] = _pick(active and me == world - 1, y, outs[m_idx])
    if aux is not None and active:
        # Every active stage records its microbatch's aux (stage-local KV in
        # the engine's prefill); masked ticks leave the buffers as they are.
        for buf, leaf in zip(aux, a):
            buf[m_idx] = leaf
    return y


def gpipe_forward(stage_fn: Callable, x: torch.Tensor, *, ctx, axis: str = "pp", comm: PPCommLayer | None = None,
                  unroll: bool = True, aux_init=None):
    """Run the GPipe forward schedule over ``ctx``'s ``axis``; returns the
    (M, mb, ...) pipeline output **on the last stage** (zeros elsewhere;
    callers broadcast it or keep outputs stage-local).

    ``stage_fn`` maps one microbatch ``x[m]`` to a tensor of the same shape
    (this rank's stage; it runs on every tick). ``unroll`` picks the body:
    True sends after every tick but the last, False issues one more,
    final send whose arrival nobody reads (JAX's ``lax.scan`` body, uniform
    across ticks); both give the same bits. ``aux_init`` opts into
    stage-local side outputs: a tuple of zeroed (M, ...) buffers;
    ``stage_fn`` then returns ``(y, leaves)``, a tuple of as many tensors,
    and every active stage writes microbatch m's leaves at index m (in
    place); the call returns ``(out, aux)``."""
    comm = comm or PPCommLayer(ctx, axis)
    actx = ctx.axis(axis)
    world, me = actx.world, actx.rank
    m_total = x.shape[0]
    steps = m_total + world - 1
    recv = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    outs = [torch.zeros_like(recv) for _ in range(m_total)]
    for t in range(steps):
        y = _tick(stage_fn, x, recv, outs, aux_init, t, me=me, world=world, m_total=m_total)
        if t + 1 < steps or not unroll:
            recv = comm.send_next(y)
    out = torch.stack(outs)
    return out if aux_init is None else (out, aux_init)


def gpipe_stage_params(params, num_layers: int, *, ctx, axis: str = "pp"):
    """This stage's contiguous block of ``num_layers / S`` layers of
    ``params``: a stacked (L, ...) tensor or a list of L per-layer entries
    (``DenseLLM.layers``)."""
    actx = ctx.axis(axis)
    world, me = actx.world, actx.rank
    if num_layers % world:
        raise ValueError(f"num_layers={num_layers} must divide over {world} pipeline stages "
                         "(trailing layers would silently be assigned to no stage)")
    per = num_layers // world
    return params[me * per:(me + 1) * per]

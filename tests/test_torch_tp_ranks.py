"""One rank of the port's tensor-parallel CPU tests (``tests/test_torch_tp.py``,
``tests/test_torch_ep.py``, ``tests/test_torch_function.py``,
``tests/test_torch_sp.py``, ``tests/test_torch_pp.py``).

Run as ``python test_torch_tp_ranks.py RANK WORLD STORE [DEVICE [AXES]]``: it
joins a ``gloo`` group through the file store STORE, on the CPU (the plain
versions; the default) or, with DEVICE ``cuda``, on card ``RANK %
device_count`` (the kernels; ``tests/test_torch_cuda.py``), its ranks laid
out over the mesh axes AXES when given (``pp=2,tp=2``: a ``pp`` × ``tp``
context, ``runtime.mesh.split_axes``), then serves
requests read from stdin until it reads end of file. A request is a
length-prefixed pickle of ``(task, kwargs)``; the answer, written to stdout
the same way, is ``("ok", result)`` or ``("err", "Type: message")``. It
imports only the port, never JAX. ``Ranks`` starts and drives the four.
"""

from __future__ import annotations

import os
import pathlib
import pickle
import struct
import subprocess
import sys

import numpy as np
import torch

from triton_dist_tpu_torch.kernels import ag_attention as aga
from triton_dist_tpu_torch.kernels import allgather as cag
from triton_dist_tpu_torch.kernels import allgather_gemm as ag
from triton_dist_tpu_torch.kernels import allreduce as car
from triton_dist_tpu_torch.kernels import ep_a2a, ep_fused
from triton_dist_tpu_torch.kernels import gemm_allreduce as ar
from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as rs
from triton_dist_tpu_torch.kernels import low_latency_a2a as ll
from triton_dist_tpu_torch.kernels import p2p
from triton_dist_tpu_torch.kernels import reduce_scatter as crs
from triton_dist_tpu_torch.kernels import sp as ksp
from triton_dist_tpu_torch.layers import sp as lsp
from triton_dist_tpu_torch.layers.pp import PPCommLayer
from triton_dist_tpu_torch.layers.pp_schedule import gpipe_forward, gpipe_stage_params
from triton_dist_tpu_torch.layers.tp import TP_MoE
from triton_dist_tpu_torch.models import (
    PRESETS,
    DenseLLM,
    Engine,
    EPMoELLM,
    Qwen3MoE,
    params_from_numpy,
    quant_tensor_from_numpy,
    quantize_tensor,
)
from triton_dist_tpu_torch.runtime import mesh
from triton_dist_tpu_torch.shmem.symm import WS_BYTES


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().copy()


def collectives(ctx, x):
    t = torch.from_numpy(x)
    return {
        "all_gather0": _np(mesh.all_gather(ctx, t, 0)),
        "all_gather1": _np(mesh.all_gather(ctx, t, 1)),
        "psum": _np(mesh.psum(ctx, t)),
        "psum_scatter": _np(mesh.psum_scatter(ctx, t)),
        "ring": [_np(c) for c in mesh.ring_ag_chunks(ctx, t)],
    }


def matmuls(ctx, op, method, a, bs):
    a = torch.from_numpy(a)
    bs = [torch.from_numpy(b) for b in bs]
    if op == "ag":
        return _np(ag.ag_gemm_shard(ctx, a, bs[0], method=ag.AGGemmMethod(method)))
    if op == "ag_swiglu":
        return _np(ag.ag_gemm_swiglu_shard(ctx, a, bs[0], bs[1], method=ag.AGGemmMethod(method)))
    if op == "rs":
        return _np(rs.gemm_rs_shard(ctx, a, bs[0], method=rs.GemmRSMethod(method)))
    return _np(ar.gemm_ar_shard(ctx, a, bs[0], method=ar.GemmARMethod(method)))


def quant_matmuls(ctx, op, methods, q, scale, wire, bs):
    """The collective matmul ``op`` with a quantized A (payload ``q`` as
    bytes, ``scale`` (rows, 1) or lane-replicated, from JAX through the
    bridge) on every route in ``methods``; returns each route's output."""
    a = quant_tensor_from_numpy(q, scale, wire, "cpu")
    bs = [torch.from_numpy(b) for b in bs]
    out = {}
    for method in methods:
        if op == "ag":
            out[method] = ag.ag_gemm_shard(ctx, a, bs[0], method=ag.AGGemmMethod(method))
        elif op == "ag_swiglu":
            out[method] = ag.ag_gemm_swiglu_shard(ctx, a, bs[0], bs[1], method=ag.AGGemmMethod(method))
        elif op == "rs":
            out[method] = rs.gemm_rs_shard(ctx, a, bs[0], method=rs.GemmRSMethod(method))
        else:
            out[method] = ar.gemm_ar_shard(ctx, a, bs[0], method=ar.GemmARMethod(method))
    return {k: _np(v) for k, v in out.items()}


def _bits_in(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a tensor; uint16 arrays carry bf16 bits."""
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits_out(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16).copy()
    return _np(t)


def collective_ops(ctx, x):
    """Every route of rows 20-22 and the three host ops on this rank's x
    (bf16 given as uint16 bits); the reduce-scatters only where dim 0
    splits over the ranks."""
    t = _bits_in(x)
    G, R = cag.AllGatherMethod, car.AllReduceMethod
    out = {"ring_ag": cag.ring_ag_call(ctx, t), "full_mesh_ag": cag.full_mesh_ag_call(ctx, t),
           "ag_auto": cag.all_gather_shard(ctx, t), "ag_xla": cag.all_gather_shard(ctx, t, method=G.XLA),
           "ag_host": cag.all_gather(ctx, t), "one_shot": car.one_shot_ar_call(ctx, t),
           "two_shot": car.all_reduce_shard(ctx, t, method=R.TWO_SHOT), "ar_auto": car.all_reduce_shard(ctx, t),
           "ar_xla": car.all_reduce_shard(ctx, t, method=R.XLA), "ar_host": car.all_reduce(ctx, t)}
    if t.shape[0] % ctx.world == 0:
        out.update(ring_rs=crs.ring_rs_call(ctx, t), rs_xla=crs.reduce_scatter_shard(ctx, t, use_xla=True),
                   rs_host=crs.reduce_scatter(ctx, t))
    return {k: _bits_out(v) for k, v in out.items()}


def tp_moe(ctx, x, w_router, w_gate, w_up, w_down, mode, top_k):
    """``TP_MoE`` in ``mode`` on this rank's x, with this rank's ff columns
    of the global expert slabs (gate, up (E, d, ff); down (E, ff, d))."""
    f = w_gate.shape[2] // ctx.world
    cols = slice(ctx.rank * f, (ctx.rank + 1) * f)
    moe = TP_MoE(*(torch.from_numpy(np.ascontiguousarray(w)) for w in
                   (w_router, w_gate[:, :, cols], w_up[:, :, cols], w_down[:, cols])), top_k=top_k, ctx=ctx)
    return _np(moe(torch.from_numpy(x), mode=mode))


def _model(ctx, arrays, ep=None, moe=False):
    """``test-dense`` as a ``DenseLLM``, with ``moe`` ``test-moe`` as a
    ``Qwen3MoE`` (ff columns a rank), or with ``ep`` set (the value of
    ``use_pallas_a2a``) ``test-moe`` as an ``EPMoELLM``, from the global
    arrays."""
    if ep is None:
        cfg = PRESETS["test-moe" if moe else "test-dense"]
        cls = Qwen3MoE if moe else DenseLLM
        return cls(cfg, params_from_numpy(arrays, cfg, "cpu", rank=ctx.rank, world=ctx.world), ctx=ctx)
    cfg = PRESETS["test-moe"]
    params = params_from_numpy(arrays, cfg, "cpu", rank=ctx.rank, world=ctx.world, expert_parallel=True)
    return EPMoELLM(cfg, params, ctx=ctx, use_pallas_a2a=ep)


def _decode_hidden(engine, token, cache):
    """The final-normed hidden states of one more decode step on
    ``engine``'s backend (the mega step on mega)."""
    model = engine.model
    if engine.decode_mode != "mega":
        return model.decode_hidden(token, cache.k, cache.v, cache.lengths, mode=engine.decode_mode)
    x = model.params.embed[token.long()]
    x, _, _ = engine._mega_step(engine._mega_layers, x, cache.k, cache.v, cache.lengths)
    return model.final_norm(x)


def serve(ctx, arrays, backend, ids, gen_len, prompts, remaining, chunk, max_len, ep=None, moe=False):
    """``serve`` (none when ``gen_len`` is 0), the first logits of its
    prefill, two slots through ``prefill_into_slot`` + ``decode_steps`` on
    ``backend``, then the hidden states of one more step."""
    model = _model(ctx, arrays, ep, moe)
    engine = Engine(model, backend=backend, max_len=max_len)
    ids = torch.tensor(ids)
    logits, _ = model.prefill(ids, mode=engine.prefill_mode)
    logits = mesh.all_gather(ctx, logits, 1)
    served = engine.serve(ids, gen_len=gen_len) if gen_len else torch.zeros(0)
    cache = engine.alloc_slots(len(prompts))
    first = [int(engine.prefill_into_slot(cache, slot, torch.tensor([p]))[0]) for slot, p in enumerate(prompts)]
    out, last, cache, rem = engine.decode_steps(cache, torch.tensor(first, dtype=torch.int32),
                                                torch.tensor(remaining), chunk)
    result = {"logits": _np(logits), "served": _np(served), "first": first, "out": _np(out),
              "lengths": _np(cache.lengths), "k": _np(cache.k)}
    result["hidden"] = _np(_decode_hidden(engine, last, cache))
    return result


def dist_prefill(ctx, arrays, ids):
    return _np(_model(ctx, arrays).prefill(torch.tensor(ids), mode="dist")[0])


def _same_on_every_rank(ctx, t) -> bool:
    import torch.distributed as dist

    raw = t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()
    everyone = [None] * ctx.world
    dist.all_gather_object(everyone, raw, group=ctx.group)
    return all(x == raw for x in everyone)


def cuda_kernels(ctx, dtype, seed, atol, rtol):
    """Rows 16-19 at edge shapes on the card against their plain versions
    (the plain collective plus the fp32 product), and row 27 against
    ``ag_attention_reference``, on the same inputs; every
    rank draws every rank's inputs from ``seed``. Returns, per case, the
    max |error|, whether every element is within ``atol + rtol·|plain|``
    and, for rows 18 and 19, whether every rank got the same bits; and the
    launches each wrapper counted."""
    dt = getattr(torch, dtype)

    def check(got, want):
        err = (got.float() - want.float()).abs()
        return err.max().item(), bool((err <= atol + rtol * want.float().abs()).all())

    gen = torch.Generator(device=ctx.device).manual_seed(seed)
    w, me = ctx.world, ctx.rank
    k, n = 96, 128

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=ctx.device) * scale).to(dt)

    out = {}
    before = {f.__name__: f.launches for f in (ag.ag_gemm_fused, rs.gemm_rs_fused, ar.gemm_ar_fused, ar.gemm_ar_ll)}
    for m, swiglu in ((1, False), (33, True), (64, False), (65, True)):
        a = randn(w, m, k)[me].contiguous()
        bs = tuple(randn(k, n, scale=k ** -0.5) for _ in range(2 if swiglu else 1))
        got, want = ag.ag_gemm_fused(ctx, a, bs), ag.ag_gemm_reference(ctx, a, bs)
        out[f"ag m_shard={m} swiglu={swiglu}"] = (*check(got, want), None)
    for m in (4, 260):
        a, b = randn(w, m, k)[me].contiguous(), randn(w, k, n, scale=(w * k) ** -0.5)[me].contiguous()
        got, want = rs.gemm_rs_fused(ctx, a, b), rs.gemm_rs_reference(ctx, a, b)
        out[f"rs m={m}"] = (*check(got, want), None)
    for name, fn, ms in (("ar", ar.gemm_ar_fused, (4, 68)), ("ll", ar.gemm_ar_ll, (1, 3, 4, 68))):
        for m in ms:
            a, b = randn(w, m, k)[me].contiguous(), randn(w, k, n, scale=(w * k) ** -0.5)[me].contiguous()
            got, want = fn(ctx, a, b), ar.gemm_ar_reference(ctx, a, b)
            out[f"{name} m={m}"] = (*check(got, want), _same_on_every_rank(ctx, got))
    # Row 27 against its plain version: a ragged shard (GQA 2) and B 2 (GQA
    # 4), causal or not, with and without residuals (k_full and v_full
    # bitwise: they are copies).
    ag_before = aga.ag_attn_kernel.launches
    for b, hq, hkv, s_loc, d in ((1, 4, 2, 40, 128), (2, 8, 2, 64, 64)):
        q = randn(w, b, hq, s_loc, d)[me].contiguous()
        k, v = (randn(w, b, hkv, s_loc, d)[me].contiguous() for _ in range(2))
        for causal in (True, False):
            for res in (False, True):
                got = aga.ag_attn_kernel(ctx, q, k, v, causal=causal, return_residuals=res)
                want = aga.ag_attention_reference(ctx, q, k, v, causal=causal, return_residuals=res)
                label = f"ag_attn b={b} hq={hq} hkv={hkv} s_loc={s_loc} d={d} causal={causal}"
                if not res:
                    out[label] = (*check(got, want), None)
                    continue
                out[label + " o"] = (*check(got[0], want[0]), None)
                out[label + " lse"] = (*check(got[1][0], want[1][0]), None)
                for name, x, y in (("k_full", got[1][1], want[1][1]), ("v_full", got[1][2], want[1][2])):
                    out[f"{label} {name}"] = (0.0, torch.equal(x, y), None)
    ctx.check_status()
    launches = {f.__name__: f.launches - before[f.__name__]
                for f in (ag.ag_gemm_fused, rs.gemm_rs_fused, ar.gemm_ar_fused, ar.gemm_ar_ll)}
    launches["ag_attn_kernel"] = aga.ag_attn_kernel.launches - ag_before
    return {"cases": out, "launches": launches}


def cuda_quant_kernels(ctx, dtype, wire, seed, atol, rtol):
    """Rows 16q-19q (a quantized A) at edge shapes on the card against
    their plain versions on the same inputs, and bitwise against the
    unquantized kernels on the A dequantized into the weights' dtype (the
    tiles dequantize exactly); every rank draws every rank's inputs from
    ``seed``. Returns, per case, the max |error|, whether every element is
    within ``atol + rtol·|plain|``, whether the bits equal the unquantized
    kernel's and, for rows 18 and 19, whether every rank got the same bits;
    and the launches each quant wrapper counted."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=ctx.device).manual_seed(seed)
    w, me = ctx.world, ctx.rank
    k, n = 96, 128
    fns = (ag.ag_gemm_fused_quant, rs.gemm_rs_fused_quant, ar.gemm_ar_fused_quant, ar.gemm_ar_ll_quant)
    before = {f.__name__: f.launches for f in fns}

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=ctx.device) * scale).to(dt)

    def quant(m):
        return quantize_tensor(torch.randn((w, m, k), generator=gen, device=ctx.device)[me], wire)

    def check(got, want, same_as):
        err = (got.float() - want.float()).abs()
        return (err.max().item(), bool((err <= atol + rtol * want.float().abs()).all()),
                torch.equal(got.view(torch.uint8), same_as.view(torch.uint8)))

    out = {}
    for m, swiglu in ((1, False), (33, True), (64, False), (65, True)):
        a = quant(m)
        bs = tuple(randn(k, n, scale=k ** -0.5) for _ in range(2 if swiglu else 1))
        got = ag.ag_gemm_fused_quant(ctx, a, bs)
        same_as = ag.ag_gemm_fused(ctx, a.q.float().mul(a.scale).to(dt).contiguous(), bs)
        out[f"ag m_shard={m} swiglu={swiglu}"] = (*check(got, ag.ag_gemm_quant_reference(ctx, a, bs), same_as), None)
    cases = [("rs", rs.gemm_rs_fused_quant, rs.gemm_rs_fused, rs.gemm_rs_quant_reference, (4, 260))]
    cases += [("ar", ar.gemm_ar_fused_quant, ar.gemm_ar_fused, ar.gemm_ar_quant_reference, (4, 68)),
              ("ll", ar.gemm_ar_ll_quant, ar.gemm_ar_ll, ar.gemm_ar_quant_reference, (1, 3, 4, 68))]
    for name, fn, plain_fn, ref, ms in cases:
        for m in ms:
            a, b = quant(m), randn(w, k, n, scale=(w * k) ** -0.5)[me].contiguous()
            got = fn(ctx, a, b)
            same_as = plain_fn(ctx, a.q.float().mul(a.scale).to(dt).contiguous(), b)
            same = _same_on_every_rank(ctx, got) if name != "rs" else None
            out[f"{name} m={m}"] = (*check(got, ref(ctx, a, b), same_as), same)
    ctx.check_status()
    return {"cases": out, "launches": {f.__name__: f.launches - before[f.__name__] for f in fns}}


def cuda_collectives(ctx, seed):
    """Rows 20-22 on the card against their plain versions on the same
    inputs, at edge shapes (one row, a ragged lead, odd byte counts, bf16,
    a message larger than one workspace). Every rank draws every rank's
    inputs from ``seed``. Returns, per case, whether the kernel's bits equal
    the plain version's and whether every rank got the same bits; and the
    launches each wrapper counted."""
    w, me, dev = ctx.world, ctx.rank, ctx.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    fns = (cag.ring_ag_call, cag.full_mesh_ag_call, crs.ring_rs_call, car.one_shot_ar_call)
    before = {f.__name__: f.launches for f in fns}
    before_p2p = p2p.p2p_kernel.launches
    out = {}
    for label, shape, dtype in (("one row fp32", (1, 64), torch.float32),
                                ("ragged (6, 48) fp32", (6, 48), torch.float32),
                                ("(4, 4096) bf16", (4, 4096), torch.bfloat16), ("3 fp32", (3,), torch.float32),
                                ("(8, 2048) fp32", (8, 2048), torch.float32),
                                ("(4096, 1024) fp32, over one workspace", (4096, 1024), torch.float32)):
        x = torch.randn((w, *shape), generator=gen, device=dev).to(dtype)[me].contiguous()
        cases = [("ring_ag", cag.ring_ag_call, cag.all_gather_reference, False),
                 ("full_mesh_ag", cag.full_mesh_ag_call, cag.all_gather_reference, False),
                 ("one_shot", car.one_shot_ar_call, car.one_shot_ar_reference, True)]
        if shape[0] % w == 0:
            cases.append(("ring_rs", crs.ring_rs_call, crs.ring_rs_reference, False))
        for name, fn, ref, replicated in cases:
            got, want = fn(ctx, x), ref(ctx, x)
            torch.cuda.synchronize()
            same = _same_on_every_rank(ctx, got) if replicated else None
            out[f"{name} {label}"] = (torch.equal(got.view(torch.uint8), want.view(torch.uint8)), same)
    out.update(_cuda_p2p(ctx, gen))
    ctx.check_status()
    launches = {f.__name__: f.launches - before[f.__name__] for f in fns}
    launches["p2p_kernel"] = p2p.p2p_kernel.launches - before_p2p
    return {"cases": out, "launches": launches}


def _cuda_p2p(ctx, gen) -> dict:
    """Row 23 on the card: bitwise against ``mesh.ppermute`` at Qwen3-8B's
    handoff shapes (a prefill row of 144 tokens, a decode group of 2 rows,
    bf16) and at the edges, for offsets +1 and -1, over the ``pp`` axis of a
    ``pp`` × ``tp`` = 2 × 2 layout and over all four ranks (where the
    closing barrier stays); its autograd backward (the shift by -offset);
    a message one workspace half and 4 bytes long (two launches); and what
    the wrapper refuses. 14 launches a rank, 4 of them backward."""
    dev, out = ctx.device, {}
    mesh2 = mesh.split_axes(ctx, ("pp", "tp"), (2, 2))
    try:
        for axis_ctx, where in ((mesh2.axis("pp"), "pp of 2x2"), (ctx, "world 4")):
            for label, shape, dtype in (("prefill (144, 4096) bf16", (144, 4096), torch.bfloat16),
                                        ("decode (2, 4096) bf16", (2, 4096), torch.bfloat16)):
                x = torch.randn((ctx.world, *shape), generator=gen, device=dev).to(dtype)[ctx.rank].contiguous()
                for offset in (1, -1):
                    got, want = p2p.p2p_kernel(axis_ctx, x, offset), p2p.p2p_reference(axis_ctx, x, offset)
                    torch.cuda.synchronize()
                    out[f"p2p {where} {label} offset {offset}"] = (torch.equal(got.view(torch.uint8),
                                                                               want.view(torch.uint8)), None)
        pp = mesh2.axis("pp")
        for label, shape in (("odd bytes (3, 5) fp32", (3, 5)), ("autograd (6, 64) fp32", (6, 64))):
            x = torch.randn((ctx.world, *shape), generator=gen, device=dev)[ctx.rank].contiguous().requires_grad_()
            g = torch.randn((ctx.world, *shape), generator=gen, device=dev)[ctx.rank].contiguous()
            y = p2p.p2p_put_shard(mesh2, x, "pp", 1)
            y.backward(g)
            torch.cuda.synchronize()
            ok = torch.equal(y.detach(), p2p.p2p_reference(pp, x.detach(), 1))
            ok = ok and torch.equal(x.grad, p2p.p2p_reference(pp, g, -1))
            out[f"p2p {label} forward and backward"] = (ok, None)
        # One workspace half and 4 bytes: two launches, the second of 4 bytes.
        xs = torch.randn((pp.world, WS_BYTES // 4 + 1), generator=gen, device=dev)
        got = p2p.p2p_kernel(pp, xs[pp.rank].contiguous(), 1)
        torch.cuda.synchronize()
        out["p2p over one workspace"] = (torch.equal(got, xs[(pp.rank - 1) % pp.world]), None)
        del xs, got
        refused = []
        for bad in (torch.empty(0, device=dev), torch.zeros((64, 32), device=dev).t()):
            try:
                p2p.p2p_kernel(pp, bad, 1)
            except ValueError:
                refused.append(True)
        out["p2p refuses empty and strided tensors"] = (refused == [True] * 2, None)
        mesh2.axis("pp").check_status()
    finally:
        torch.cuda.synchronize()
        ctx.host_barrier()
        for name in mesh2.axis_names:
            mesh.close(mesh2.axis(name))
    return out


def stall(ctx, absent, timeout_s, op="ll"):
    """Every rank but ``absent`` calls the LL GEMM-AR (``op="ll"``), the EP
    all-to-all (``op="a2a"``), the one-shot all-reduce (``"one_shot"``) or
    the ring reduce-scatter (``"ring_rs"``) with its waits bounded by
    ``timeout_s``; returns what ``check_status`` raised (or None)."""
    ctx.heap.timeout_ns = int(timeout_s * 1e9)
    if ctx.rank == absent:
        return None
    if op == "a2a":
        ep_a2a.all_to_all_kernel(ctx, torch.ones((ctx.world, 8, 64), device=ctx.device))
    elif op == "one_shot":
        car.one_shot_ar_call(ctx, torch.ones((4, 4096), device=ctx.device))
    elif op == "ring_rs":
        crs.ring_rs_call(ctx, torch.ones((8, 64), device=ctx.device))
    else:
        a = torch.ones((4, 64), device=ctx.device)
        ar.gemm_ar_ll(ctx, a, torch.ones((64, 64), device=ctx.device))
    try:
        ctx.check_status()
    except Exception as e:  # noqa: BLE001 - the test reads the type and message
        return f"{type(e).__name__}: {e}"
    return None


def cuda_ep_kernels(ctx, dtype, seed, atol, rtol):
    """Rows 25 and 26 on the card against their plain versions (the plain
    all-to-all over the heap; plus the grouped SwiGLU and a ``bmm`` for 26)
    at edge shapes, and rows 16-19 at Qwen3-30B-A3B's world-4 shapes (wqkv
    shard of 1280 columns, wo shard of 1024 rows). Every rank draws every
    rank's inputs from ``seed``. Returns, per case, the max |error|, whether
    it is within tolerance (row 25: bitwise), and whether every rank got
    the same bits where they must; and the launches each wrapper counted."""
    dt = getattr(torch, dtype)
    w, me, dev = ctx.world, ctx.rank, ctx.device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0, dtype=dt):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def check(got, want):
        err = (got.float() - want.float()).abs()
        return err.max().item(), bool((err <= atol + rtol * want.float().abs()).all())

    fns = (ep_a2a.all_to_all_kernel, ep_fused.fused_ep_kernel, ag.ag_gemm_fused, rs.gemm_rs_fused,
           ar.gemm_ar_fused, ar.gemm_ar_ll)
    before = {f.__name__: f.launches for f in fns}
    out = {}
    # Row 25: (label, per-rank shape, dtype, rank whose chunks are all zero)
    for label, shape, a_dt, zero in (("bf16 (4, 256, 2048)", (256, 2048), dt, None),
                                     ("fp8 payload as int8", (256, 2048), torch.int8, None),
                                     ("scales (4, 256, 1)", (256, 1), torch.float32, None),
                                     ("T=1 scales (4, 8, 1)", (8, 1), torch.float32, None),
                                     ("12-byte chunks", (3, 1), torch.float32, None),
                                     ("zero source", (24, 64), dt, 2)):
        if a_dt == torch.int8:
            x_all = torch.randint(-128, 128, (w, w, *shape), generator=gen, device=dev, dtype=torch.int8)
        else:
            x_all = randn(w, w, *shape, dtype=a_dt)
        if zero is not None:
            x_all[zero] = 0
        x = x_all[me].contiguous()
        got = ep_a2a.all_to_all_kernel(ctx, x)
        plain = mesh.all_to_all(ctx, x)
        torch.cuda.synchronize()
        ok = torch.equal(got.view(torch.uint8), plain.view(torch.uint8)) and torch.equal(
            got.view(torch.uint8), x_all[:, me].contiguous().view(torch.uint8))
        out[f"a2a {label}"] = (0.0 if ok else float("inf"), ok, None)
    # Row 26: (label, E_local, C, d, ff, replicated send, rank with an all-zero send)
    for label, e_local, cap, d, ff, replicated, zero in (("C=8", 2, 8, 64, 48, False, None),
                                                         ("C=72 (two row tiles)", 3, 72, 128, 96, False, None),
                                                         ("all-zero source", 2, 16, 64, 48, False, 1),
                                                         ("replicated", 2, 24, 128, 64, True, None)):
        send_all = randn(w, w, e_local * cap, d)
        if replicated:
            send_all[:] = send_all[0].clone()
        if zero is not None:
            send_all[zero] = 0
        wg = randn(w * e_local, d, ff, scale=d ** -0.5)
        wu = randn(w * e_local, d, ff, scale=d ** -0.5)
        wd = randn(w * e_local, ff, d, scale=ff ** -0.5)
        sl = slice(me * e_local, (me + 1) * e_local)
        args = (send_all[me].contiguous(), wg[sl].contiguous(), wu[sl].contiguous(), wd[sl].contiguous())
        got = ep_fused.fused_ep_kernel(ctx, *args, capacity=cap)
        want = ep_fused.fused_ep_reference(ctx, *args, capacity=cap)
        torch.cuda.synchronize()
        same = _same_on_every_rank(ctx, got) if replicated else None
        out[f"fused_ep {label}"] = (*check(got, want), same)
    # Rows 16-19 at Qwen3-30B-A3B's world-4 shapes (d 2048).
    d, n_qkv, k_o = 2048, (32 + 2 * 4) * 128 // w, 32 * 128 // w
    for m in (1, 33):
        a_all, b_all = randn(w, m, d), randn(d, w * n_qkv, scale=d ** -0.5)
        a, b = a_all[me].contiguous(), b_all[:, me * n_qkv:(me + 1) * n_qkv].contiguous()
        out[f"ag wqkv m_shard={m} n={n_qkv}"] = (*check(ag.ag_gemm_fused(ctx, a, (b,)),
                                                       ag.ag_gemm_reference(ctx, a, (b,))), None)
    for name, fn, ref, m in (("rs", rs.gemm_rs_fused, rs.gemm_rs_reference, 132),
                             ("ar", ar.gemm_ar_fused, ar.gemm_ar_reference, 68),
                             ("ll", ar.gemm_ar_ll, ar.gemm_ar_reference, 4)):
        a, b = randn(w, m, k_o)[me].contiguous(), randn(w, k_o, d, scale=(w * k_o) ** -0.5)[me].contiguous()
        got = fn(ctx, a, b)
        same = None if name == "rs" else _same_on_every_rank(ctx, got)
        out[f"{name} wo k={k_o} m={m}"] = (*check(got, ref(ctx, a, b)), same)
    ctx.check_status()
    return {"cases": out, "launches": {f.__name__: f.launches - before[f.__name__] for f in fns}}


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def ep_op(ctx, op, **kw):
    """One expert-parallel function of the port on this rank's inputs
    (numpy), its result(s) as numpy."""
    t = {k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    if op == "a2a":
        return _np(ep_a2a.all_to_all_single_shard(ctx, t["x"], use_pallas=t["use_pallas"]))
    if op == "dispatch_combine":  # ep_dispatch_shard through its context-bound form
        a2a_ctx = ep_a2a.create_all_to_all_context(ctx, t["num_experts"], t["capacity"], t["use_pallas"])
        disp = ep_a2a.fast_all_to_all(a2a_ctx, t["x"], t["idx"])
        y = disp.expert_inputs * t["scale"][:, None, None]
        return {"expert_inputs": _np(disp.expert_inputs),
                "out": _np(ep_a2a.ep_combine_shard(ctx, y, disp, t["w"], use_pallas=t["use_pallas"]))}
    if op == "ll_dispatch_combine":
        disp = ll.ll_dispatch_shard(ctx, t["x"], t["idx"], num_experts=t["num_experts"], capacity=t["capacity"],
                                    use_pallas=t["use_pallas"], wire_fp8=t["wire_fp8"])
        y = disp.expert_inputs * t["scale"][:, None, None]
        return {"expert_inputs": _np(disp.expert_inputs),
                "out": _np(ll.ll_combine_shard(ctx, y, disp, t["w"], use_pallas=t["use_pallas"]))}
    weights = (t["w_router"], t["w_gate"], t["w_up"], t["w_down"])
    moe_kw = {k: t.get(k) for k in ("num_experts", "top_k", "capacity_factor")}
    if op == "ll_moe":
        return _np(ll.ep_moe_ll_shard(ctx, t["x"], *weights, **moe_kw, use_pallas=t["use_pallas"],
                                      wire_fp8=t["wire_fp8"]))
    if op == "fused_moe":
        return _np(ep_fused.ep_moe_fused_kernel_shard(
            ctx, t["x"], *weights, **moe_kw, use_pallas_a2a=t["use_pallas"],
            combine_in_kernel=t["combine_in_kernel"], wire_fp8=t["wire_fp8"]))
    gate_up_down = weights[1:]
    if op == "fused_mlp":
        return _np(ep_fused.fused_dispatch_mlp_shard(ctx, t["send"], *gate_up_down, capacity=t["capacity"],
                                                     wire_fp8=t["wire_fp8"]))
    if op == "fused_mlp_combine":
        return _np(ep_fused.fused_dispatch_mlp_combine_shard(ctx, t["send"], *gate_up_down, capacity=t["capacity"],
                                                             wire_fp8=t["wire_fp8"]))
    raise ValueError(f"unknown op {op!r}")


def ep_mlp(ctx, arrays, layer, x, mode, use_pallas_a2a):
    """``EPMoELLM._ep_mlp`` of ``test-moe``'s layer ``layer`` on this rank's
    tokens x."""
    model = _model(ctx, arrays, use_pallas_a2a)
    p = model.params
    lp = {"router": p.router[layer], "mlp_gate": p.mlp_gate[layer], "mlp_up": p.mlp_up[layer],
          "mlp_down": p.mlp_down[layer]}
    return _np(model._ep_mlp(lp, torch.from_numpy(x), mode))


def function_grads(ctx, op, args, c, **kw):
    """One differentiable function of ``triton_dist_tpu_torch.function`` on
    this rank's inputs ``args`` (numpy): the loss is sum(out · c) (divided by
    the world size for ``gemm_ar``, whose output and loss every rank holds
    whole), and the answer the output and the gradient of every input."""
    from triton_dist_tpu_torch import function as fn

    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    if op == "ag_gemm":
        out = fn.ag_gemm_fn(ctx, *leaves)
    elif op == "gemm_rs":
        out = fn.gemm_rs_fn(ctx, *leaves)
    elif op == "gemm_ar":
        out = fn.gemm_ar_fn(ctx, *leaves)
    elif op == "a2a":
        out = fn.all_to_all_single_fn(ctx, *leaves, use_pallas=kw["use_pallas"])
    elif op == "ep_moe":
        out = fn.ep_moe_fused_fn(ctx, *leaves, **kw)
    elif op == "ring":
        out = fn.ring_attention_fn(ctx, *leaves, **kw)
    elif op == "ring_varlen":
        out = fn.ring_attention_varlen_fn(ctx, *leaves, **kw)
    elif op == "ag":
        out = fn.ag_attention_fn(ctx, *leaves, **kw)
    else:
        raise ValueError(f"unknown op {op!r}")
    loss = (out * torch.from_numpy(c)).sum()
    if op == "gemm_ar":
        loss = loss / ctx.world
    loss.backward()
    grads = [_np(t.grad) for t in leaves]
    if op == "ep_moe":  # the router is replicated: JAX's gradient is the sum of the ranks'
        grads[1] = _np(mesh.psum(ctx, leaves[1].grad))
    return {"out": _np(out), "grads": grads}


def sp_op(ctx, op, **kw):
    """One sequence-parallel function or layer of the port on this rank's
    inputs (numpy), its results as numpy. ``agsp`` also returns which route
    ``AGSPAttn`` called (row 27 or the ring), counted around the call."""
    t = {k: _t(a) if isinstance(a, np.ndarray) else a for k, a in kw.items()}
    if op == "ag":
        o, (lse, k_full, v_full) = aga.ag_flash_attention_shard(ctx, t["q"], t["k"], t["v"], causal=t["causal"],
                                                                return_residuals=True)
        return {"o": _np(o), "lse": _np(lse), "k_full": _np(k_full), "v_full": _np(v_full)}
    if op == "ring":
        layer = lsp.RingSPAttn(ctx, causal=t["causal"])
        return _np(layer(t["q"], t["k"], t["v"], cu_seqlens=kw.get("cu_seqlens")))
    if op == "ulysses":
        layer = lsp.UlyssesSPAttn(ctx, causal=t["causal"], use_pallas_a2a=t["use_pallas_a2a"])
        return _np(layer(t["q"], t["k"], t["v"]))
    if op == "agsp":
        calls = {"ag": 0, "ring": 0}
        routes = {"ag": "ag_flash_attention_shard", "ring": "ring_attention_shard"}
        saved = {name: getattr(lsp, attr) for name, attr in routes.items()}

        def counted(name):
            def call(*a, **k):
                calls[name] += 1
                return saved[name](*a, **k)
            return call

        try:
            for name, attr in routes.items():
                setattr(lsp, attr, counted(name))
            o = lsp.AGSPAttn(ctx, vmem_limit_mb=t["vmem_limit_mb"])(t["q"], t["k"], t["v"])
        finally:
            for name, attr in routes.items():
                setattr(lsp, attr, saved[name])
        return {"o": _np(o), "calls": calls}
    if op == "ulysses_gemms":
        q, k, v = ksp.ulysses_qkv_gemm_a2a_shard(ctx, t["x3"], t["wqkv"], num_q_heads=t["hq"],
                                                 num_kv_heads=t["hkv"], head_dim=t["hd"])
        return {"gemm_a2a": _np(ksp.gemm_a2a_shard(ctx, t["x"], t["w"])),
                "a2a_gemm": _np(ksp.a2a_gemm_shard(ctx, t["chunks"], t["w2"])),
                "qkv": [_np(q), _np(k), _np(v)], "o_proj": _np(ksp.ulysses_o_a2a_gemm_shard(ctx, t["o"], t["wo"]))}
    raise ValueError(f"unknown op {op!r}")


def _pipeline(pp, ws, x, act, unroll=True):
    """The toy stack ``h = act(h @ w)`` over the layers ``ws`` (L, D, D)
    through ``gpipe_forward`` on the pipeline context ``pp`` (each stage its
    L/S layers), the last stage's output broadcast (an all-gather pick)."""
    def stage(h):
        for w in gpipe_stage_params(ws, ws.shape[0], ctx=pp):
            h = act(h @ w)
        return h

    out = gpipe_forward(stage, x, ctx=pp, unroll=unroll)
    return mesh.all_gather(pp.axis("pp"), out[None], 0)[-1], out


def pp_gpipe(ctx, stages, ws, x, exact_ws, exact_x, grad_x=None):
    """The toy GPipe stack of ``tests/test_pp.py`` on ``stages`` pipeline
    stages (all four ranks: ``stages`` 4; the ``pp`` axis otherwise): tanh
    with the unrolled and the uniform (``unroll=False``) bodies, the
    identity activation on ``exact_ws`` (small integers, exact in fp32 in
    any summation order), and, with ``grad_x``, the gradient of
    sum(out²) over ``ws`` summed over the stages."""
    pp = mesh.split_axes(ctx, ("pp",), (4,)) if stages == 4 else ctx
    with torch.no_grad():
        got = {"tanh": _np(_pipeline(pp, torch.from_numpy(ws), torch.from_numpy(x), torch.tanh)[0]),
               "tanh_scan": _np(_pipeline(pp, torch.from_numpy(ws), torch.from_numpy(x), torch.tanh, False)[0]),
               "exact": _np(_pipeline(pp, torch.from_numpy(exact_ws), torch.from_numpy(exact_x), lambda h: h)[0])}
    if grad_x is not None:
        w = torch.from_numpy(ws).requires_grad_()
        _, out = _pipeline(pp, w, torch.from_numpy(grad_x), torch.tanh)
        (out ** 2).sum().backward()
        got["grad"] = _np(mesh.psum(pp.axis("pp"), w.grad))
    return got


def pp_comm(ctx, x):
    """``PPCommLayer.send_next`` / ``send_prev`` on both backends and the host
    op ``p2p_send_recv`` over the ``pp`` axis, and ``send_next`` over all
    four ranks as one ``pp`` axis."""
    t = torch.from_numpy(x)
    out = {}
    for backend in ("pallas", "xla"):
        comm = PPCommLayer(ctx, "pp", backend)
        out[f"next {backend}"], out[f"prev {backend}"] = _np(comm.send_next(t)), _np(comm.send_prev(t))
    out["send_recv"] = _np(p2p.p2p_send_recv(ctx, t, offset=-1))
    out["next pp4"] = _np(PPCommLayer(mesh.split_axes(ctx, ("pp",), (4,))).send_next(t))
    return out


def pp_serve(ctx, arrays, backend, ids, gen_len, prompts, remaining, chunk, max_len):
    """``test-dense`` on the ``pp`` × ``tp`` context and, on the same
    parameters, on its ``tp`` axis alone: each engine's prefill (the
    pipeline's stage-local KV gathered over ``pp`` into layer order), its
    ``serve`` and its slots (``prefill_into_slot`` + ``decode_steps``)."""
    cfg = PRESETS["test-dense"]
    params = params_from_numpy(arrays, cfg, ctx=ctx)
    result = {}
    for name, mctx in (("pp", ctx), ("tp", ctx.axis("tp"))):
        engine = Engine(DenseLLM(cfg, params, ctx=mctx), backend=backend, max_len=max_len)
        t = torch.tensor(ids)
        logits, (ks, vs) = engine._prefill(t)
        if name == "pp":
            ks, vs = (mesh.all_gather(ctx.axis("pp"), c, 0) for c in (ks, vs))
        cache = engine.alloc_slots(len(prompts))
        first = [int(engine.prefill_into_slot(cache, slot, torch.tensor([p]))[0]) for slot, p in enumerate(prompts)]
        out, _, cache, _ = engine.decode_steps(cache, torch.tensor(first, dtype=torch.int32),
                                               torch.tensor(remaining), chunk)
        result[name] = {"logits": _np(engine._full(logits)), "k": _np(ks), "v": _np(vs),
                        "served": _np(engine.serve(t, gen_len=gen_len)), "first": first, "out": _np(out),
                        "lengths": _np(cache.lengths), "pp_world": engine.pp_world,
                        "cache_layers": int(cache.k.shape[0])}
    return result


TASKS = {"collectives": collectives, "collective_ops": collective_ops, "tp_moe": tp_moe,
         "matmuls": matmuls, "serve": serve, "dist_prefill": dist_prefill, "cuda_collectives": cuda_collectives,
         "cuda_kernels": cuda_kernels, "stall": stall, "ep_op": ep_op, "ep_mlp": ep_mlp,
         "cuda_ep_kernels": cuda_ep_kernels, "function_grads": function_grads, "quant_matmuls": quant_matmuls,
         "cuda_quant_kernels": cuda_quant_kernels, "sp_op": sp_op, "pp_gpipe": pp_gpipe, "pp_comm": pp_comm,
         "pp_serve": pp_serve}


def _read(stream):
    head = stream.read(8)
    if len(head) < 8:
        return None
    (n,) = struct.unpack("<Q", head)
    return pickle.loads(stream.read(n))


def _write(stream, obj) -> None:
    data = pickle.dumps(obj)
    stream.write(struct.pack("<Q", len(data)) + data)
    stream.flush()


class Ranks:
    """``world`` rank processes of this file over the file store ``store``,
    laid out over ``axes`` (``(("pp", 2), ("tp", 2))``) when given;
    ``run(task, kwargs)`` (one dict for all, or one per rank) returns their
    answers in rank order, ``ok`` their results (asserting none failed)."""

    def __init__(self, store, world: int = 4, device: str = "cpu", axes=None):
        repo = pathlib.Path(__file__).resolve().parents[1]
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(repo), os.environ.get("PYTHONPATH", "")]))
        self.world = world
        self.procs = [
            subprocess.Popen([sys.executable, __file__, str(r), str(world), str(store), device]
                             + ([",".join(f"{n}={k}" for n, k in axes)] if axes else []),
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=repo, env=env)
            for r in range(world)
        ]

    def run(self, task, kwargs):
        if isinstance(kwargs, dict):
            kwargs = [kwargs] * self.world
        for p, kw in zip(self.procs, kwargs):
            _write(p.stdin, (task, kw))
        answers = []
        for r, p in enumerate(self.procs):
            answer = _read(p.stdout)
            assert answer is not None, f"rank {r} ended (exit {p.poll()})"
            answers.append(answer)
        return answers

    def ok(self, task, kwargs):
        answers = self.run(task, kwargs)
        for r, (status, value) in enumerate(answers):
            assert status == "ok", f"rank {r}: {value}"
        return [value for _, value in answers]

    def close(self):
        for p in self.procs:
            p.stdin.close()
        for p in self.procs:
            p.wait(timeout=120)


def main() -> None:
    rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    device = sys.argv[4] if len(sys.argv) > 4 else "cpu"
    axes = [a.split("=") for a in sys.argv[5].split(",")] if len(sys.argv) > 5 else [("tp", world)]
    torch.set_num_threads(1)
    pipe_in, pipe_out = sys.stdin.buffer, sys.stdout.buffer
    sys.stdout = sys.stderr  # nothing but answers on the pipe
    ctx = mesh.initialize_distributed(rank, world, f"file://{store}", device=None if device == "cuda" else "cpu",
                                      axis_names=tuple(n for n, _ in axes), axis_sizes=tuple(int(k) for _, k in axes))
    while (req := _read(pipe_in)) is not None:
        task, kwargs = req
        try:
            answer = ("ok", TASKS[task](ctx, **kwargs))
        except Exception as e:  # noqa: BLE001 - the test names the failure
            answer = ("err", f"{type(e).__name__}: {e}")
        _write(pipe_out, answer)


if __name__ == "__main__":
    main()

"""One rank of the port's tensor-parallel CPU tests (``tests/test_torch_tp.py``).

Run as ``python test_torch_tp_ranks.py RANK WORLD STORE [DEVICE]``: it joins a
``gloo`` group through the file store STORE, on the CPU (the plain
versions; the default) or, with DEVICE ``cuda``, on card ``RANK %
device_count`` (the kernels; ``tests/test_torch_cuda.py``), then serves
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

from triton_dist_tpu_torch.kernels import allgather_gemm as ag
from triton_dist_tpu_torch.kernels import gemm_allreduce as ar
from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as rs
from triton_dist_tpu_torch.models import PRESETS, DenseLLM, Engine, params_from_numpy
from triton_dist_tpu_torch.runtime import mesh


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


def _model(ctx, arrays):
    cfg = PRESETS["test-dense"]
    params = params_from_numpy(arrays, cfg, "cpu", rank=ctx.rank, world=ctx.world)
    return DenseLLM(cfg, params, ctx=ctx)


def serve(ctx, arrays, backend, ids, gen_len, prompts, remaining, chunk, max_len):
    """``serve``, the first logits of its prefill, and two slots through
    ``prefill_into_slot`` + ``decode_steps`` on ``backend``."""
    model = _model(ctx, arrays)
    engine = Engine(model, backend=backend, max_len=max_len)
    ids = torch.tensor(ids)
    logits, _ = model.prefill(ids, mode=engine.prefill_mode)
    logits = mesh.all_gather(ctx, logits, 1)
    served = engine.serve(ids, gen_len=gen_len)
    cache = engine.alloc_slots(len(prompts))
    first = [int(engine.prefill_into_slot(cache, slot, torch.tensor([p]))[0]) for slot, p in enumerate(prompts)]
    out, last, cache, rem = engine.decode_steps(cache, torch.tensor(first, dtype=torch.int32),
                                                torch.tensor(remaining), chunk)
    return {"logits": _np(logits), "served": _np(served), "first": first, "out": _np(out),
            "lengths": _np(cache.lengths), "k": _np(cache.k)}


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
    (the plain collective plus the fp32 product) on the same inputs; every
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
    ctx.check_status()
    launches = {f.__name__: f.launches - before[f.__name__]
                for f in (ag.ag_gemm_fused, rs.gemm_rs_fused, ar.gemm_ar_fused, ar.gemm_ar_ll)}
    return {"cases": out, "launches": launches}


def stall(ctx, absent, timeout_s):
    """Every rank but ``absent`` calls the LL GEMM-AR with its waits bounded
    by ``timeout_s``; returns what ``check_status`` raised (or None)."""
    ctx.heap.timeout_ns = int(timeout_s * 1e9)
    if ctx.rank == absent:
        return None
    a = torch.ones((4, 64), device=ctx.device)
    ar.gemm_ar_ll(ctx, a, torch.ones((64, 64), device=ctx.device))
    try:
        ctx.check_status()
    except Exception as e:  # noqa: BLE001 - the test reads the type and message
        return f"{type(e).__name__}: {e}"
    return None


TASKS = {"collectives": collectives, "matmuls": matmuls, "serve": serve, "dist_prefill": dist_prefill,
         "cuda_kernels": cuda_kernels, "stall": stall}


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
    """``world`` rank processes of this file over the file store ``store``;
    ``run(task, kwargs)`` (one dict for all, or one per rank) returns their
    answers in rank order, ``ok`` their results (asserting none failed)."""

    def __init__(self, store, world: int = 4, device: str = "cpu"):
        repo = pathlib.Path(__file__).resolve().parents[1]
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(repo), os.environ.get("PYTHONPATH", "")]))
        self.world = world
        self.procs = [
            subprocess.Popen([sys.executable, __file__, str(r), str(world), str(store), device],
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
    torch.set_num_threads(1)
    pipe_in, pipe_out = sys.stdin.buffer, sys.stdout.buffer
    sys.stdout = sys.stderr  # nothing but answers on the pipe
    ctx = mesh.initialize_distributed(rank, world, f"file://{store}", device=None if device == "cuda" else "cpu")
    while (req := _read(pipe_in)) is not None:
        task, kwargs = req
        try:
            answer = ("ok", TASKS[task](ctx, **kwargs))
        except Exception as e:  # noqa: BLE001 - the test names the failure
            answer = ("err", f"{type(e).__name__}: {e}")
        _write(pipe_out, answer)


if __name__ == "__main__":
    main()

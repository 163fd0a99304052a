#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``triton_dist_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``triton_dist_tpu_torch/csrc`` and
then, on the card:

1. prints the card (``nvidia-smi`` name and power limit) and the build time;
2. holds each kernel against its plain PyTorch version at the shapes the
   served paths give it (bf16) and times kernel, plain version, the
   yardstick PyTorch call (``scaled_dot_product_attention`` for attention,
   one ``torch.bmm`` of x against the concatenated gate and up weights for
   the grouped SwiGLU; the port calls neither) and the card's bound for the
   same work;
3. serves a small dense model and the ``test-moe`` MoE model (fp32) through
   ``Engine`` on CUDA and on the CPU (plain versions) and requires equal
   greedy tokens and close logits;
4. serves Qwen3-8B at full width and depth (36 layers, bf16, random weights
   from a seeded generator): four requests joined into four slots with
   ``prefill_into_slot`` and decoded together with ``decode_steps``, plus one
   batch-2 ``serve``, with the kernels' launch counts read around exactly
   that run; then frees it and serves Qwen3-30B-A3B at full width and depth
   (48 layers, 128 experts, top-8, bf16) with the same four requests and a
   batch-8 ``serve``, its counts read around its own run;
5. prints one ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.

It exits nonzero and prints no result when CUDA is unavailable, when run
away from the repository, or when any phase fails.
"""

from __future__ import annotations

import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): bf16 tensor cores
# and HBM3 bandwidth. The bound of a function is the larger of its FLOPs
# over the first and its bytes over the second.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# bf16 kernel vs plain version: both accumulate in fp32, but the kernels sum
# in another order (and flash attention rounds P to bf16 against a running
# row max), and the output is rounded to bf16 (8 significant bits). |err|
# must stay within ATOL + RTOL·|plain|.
BF16_ATOL, BF16_RTOL = 1e-2, 2e-2
LSE_ATOL = 1e-3  # fp32 LSE from the same bf16 products, another summation order
# fp32 parity (phase 3): the same fp32 math on the card and on the CPU,
# summed in another order.
FP32_LOGITS_TOL = 5e-4

FLASH_PROMPTS = (96, 384, 777, 1500)
DECODE_STEPS = 32
MAX_LEN = 2048
SEED = 20261016
# Capacities group_gemm_swiglu sees on the Qwen3-30B-A3B path (E = 128,
# top-8, factor 2.0): decode at batch ≤ 8, and prefills of 777 and 1500.
SWIGLU_CAPACITIES = (8, 104, 192)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def smi_sample() -> str:
    """The card's SM clock, power draw and temperature now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def time_ms(fn, flush_buf, iters: int = 20, warmup: int = 3) -> float:
    """Median of per-launch CUDA-event times, L2 flushed before each."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush_buf.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def close(got, want, atol, rtol) -> float:
    """Max |got - want|; raises when an element is outside atol + rtol·|want|
    or got is not finite."""
    import torch

    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if bool(bad.any()) or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"mismatch: max |err| {err.max().item():.3e}, "
                             f"{int(bad.sum())} elements out of tolerance")
    return err.max().item()


_GEMM_WORDS = ("gemm", "xmma", "cutlass", "nvjet", "sm90_")


def _family(kernel_name: str) -> str:
    if "flash_fwd" in kernel_name:
        return "flash_attention"
    if "flash_decode" in kernel_name:
        return "flash_decode"
    if "group_swiglu" in kernel_name:
        return "group_gemm_swiglu"
    if any(w in kernel_name.lower() for w in _GEMM_WORDS):
        return "matmul"
    return "other"


# The profiler loses the records of the first or last kernels of a window
# (two of them in every window on the card so far), so each window is padded
# on both sides with spin kernels, which are left out of every count.
_PAD_KERNEL, _PADS = "spin_kernel", 4


def profile_window(fn) -> tuple[float, float | None, dict[str, float], int]:
    """Run ``fn`` once under ``torch.profiler``. Returns the wall time (ms,
    ending in a synchronize), the time at least one kernel was running on
    the card (ms, the union of kernel intervals; None when the profiler saw
    no kernel), the kernel time by family (ms) and the number of kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(_PADS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        for _ in range(_PADS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    spans, families = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or _PAD_KERNEL in e.name:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        fam = _family(e.name)
        families[fam] = families.get(fam, 0.0) + (end - start) / 1e3
    if not spans:
        return wall, None, {}, 0
    busy, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    return wall, busy / 1e3, families, len(spans)


# ------------------------------------------- 2. kernels vs plain versions

def check_kernels(dev, flush_buf) -> dict[str, dict]:
    """Phase 2: every kernel against its plain version at the served shapes,
    then timed. Returns the JSON entry of each kernel (without launches)."""
    import torch
    import torch.nn.functional as F

    from triton_dist_tpu_torch.kernels import (
        attention_reference,
        decode_reference,
        flash_attention,
        flash_decode,
        group_gemm_swiglu,
        group_swiglu_reference,
    )
    from triton_dist_tpu_torch.kernels.flash_attn import attention_bytes, attention_flops
    from triton_dist_tpu_torch.kernels.flash_decode import decode_bytes, decode_flops
    from triton_dist_tpu_torch.kernels.group_gemm import swiglu_bytes, swiglu_flops
    from triton_dist_tpu_torch.models import PRESETS

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale).to(torch.bfloat16)

    cfg8b, cfg_moe = PRESETS["qwen3-8b"], PRESETS["qwen3-moe-30b-a3b"]
    hq, d = cfg8b.num_q_heads, cfg8b.head_dim
    entries = {}

    # flash_attention: causal prefill at Sq = Sk in {1024, 777}; one chunk
    # continuation with offsets; one return_lse case; Qwen3-8B's 8 kv heads
    # (group 4) and Qwen3-30B-A3B's 4 (group 8).
    attn_cases = [
        ("causal-1024", cfg8b.num_kv_heads, 1024, 1024, {}, False),
        ("causal-777", cfg8b.num_kv_heads, 777, 777, {}, False),
        ("chunk-256@512", cfg8b.num_kv_heads, 256, 1024, dict(q_offset=512, kv_offset=0), False),
        ("causal-777-lse", cfg8b.num_kv_heads, 777, 777, {}, True),
        ("moe-causal-1024", cfg_moe.num_kv_heads, 1024, 1024, {}, False),
    ]
    attn_err = 0.0
    for label, hkv, sq, sk, offs, with_lse in attn_cases:
        q, k, v = randn(1, hq, sq, d), randn(1, hkv, sk, d), randn(1, hkv, sk, d)
        got = flash_attention(q, k, v, causal=True, return_lse=with_lse, **offs)
        want = attention_reference(q, k, v, causal=True, return_lse=with_lse, **offs)
        torch.cuda.synchronize()
        if with_lse:
            err = close(got[0], want[0], BF16_ATOL, BF16_RTOL)
            lse_err = close(got[1], want[1], LSE_ATOL, 0.0)
            log(f"flash_attention {label}: max|o err| {err:.3e}, max|lse err| {lse_err:.3e}")
        else:
            err = close(got, want, BF16_ATOL, BF16_RTOL)
            log(f"flash_attention {label}: max|o err| {err:.3e}")
        attn_err = max(attn_err, err)
        if label in ("causal-1024", "moe-causal-1024"):
            kernel_ms = time_ms(lambda: flash_attention(q, k, v, causal=True), flush_buf)
            plain_ms = time_ms(lambda: attention_reference(q, k, v, causal=True), flush_buf, iters=5)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
                             flush_buf)
            b_ms, b_by = bound_ms(attention_flops(1, hq, sq, sk, d, causal=True), attention_bytes(q, k, v))
            log(f"flash_attention causal B=1 Hq={hq} Hkv={hkv} S={sq} D={d} bf16: kernel_ms {kernel_ms}, "
                f"plain_ms {plain_ms}, library_ms(SDPA) {lib_ms}, bound_ms {b_ms} ({b_by})")
            if label == "causal-1024":
                entries["flash_attention"] = dict(
                    name="flash_attention", route="cuda", source="triton_dist_tpu_torch/csrc/flash_attn.cu",
                    replaces="triton_dist_tpu/kernels/flash_attn.py:43", ms=kernel_ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                )
    entries["flash_attention"]["max_abs_err"] = attn_err

    # flash_decode: B=4 over a 2048-row cache with ragged lengths, at both
    # models' kv head counts.
    b, s = 4, MAX_LEN
    lengths = torch.tensor([1, 777, 1500, 2048], dtype=torch.int32, device=dev)
    mask = (torch.arange(s, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    dec_err = 0.0
    for label, hkv in (("qwen3-8b", cfg8b.num_kv_heads), ("qwen3-moe-30b-a3b", cfg_moe.num_kv_heads)):
        q = randn(b, hq, d)
        kc, vc = randn(b, hkv, s, d), randn(b, hkv, s, d)
        got_o, got_lse = flash_decode(q, kc, vc, lengths, return_lse=True)
        want_o, want_lse = decode_reference(q, kc, vc, lengths, return_lse=True)
        torch.cuda.synchronize()
        err = close(got_o, want_o, BF16_ATOL, BF16_RTOL)
        lse_err = close(got_lse, want_lse, LSE_ATOL, 0.0)
        dec_err = max(dec_err, err)
        log(f"flash_decode {label} B={b} lengths {lengths.tolist()}: max|o err| {err:.3e}, "
            f"max|lse err| {lse_err:.3e}")
        kernel_ms = time_ms(lambda: flash_decode(q, kc, vc, lengths), flush_buf)
        plain_ms = time_ms(lambda: decode_reference(q, kc, vc, lengths), flush_buf, iters=5)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True), flush_buf)
        b_ms, b_by = bound_ms(decode_flops(q, kc, lengths), decode_bytes(q, kc, lengths))
        log(f"flash_decode B={b} Hq={hq} Hkv={hkv} S={s} D={d} bf16: kernel_ms {kernel_ms}, "
            f"plain_ms {plain_ms}, library_ms(SDPA) {lib_ms}, bound_ms {b_ms} ({b_by})")
        if label == "qwen3-8b":
            entries["flash_decode"] = dict(
                name="flash_decode", route="cuda", source="triton_dist_tpu_torch/csrc/flash_decode.cu",
                replaces="triton_dist_tpu/kernels/flash_decode.py:71", ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            )
    entries["flash_decode"]["max_abs_err"] = dec_err

    # group_gemm_swiglu: Qwen3-30B-A3B's experts at the served capacities.
    # The yardstick is the two products alone, one bmm against [wg | wu].
    e, dm, f = cfg_moe.num_experts, cfg_moe.hidden_size, cfg_moe.moe_intermediate_size
    wg, wu = randn(e, dm, f, scale=dm ** -0.5), randn(e, dm, f, scale=dm ** -0.5)
    w_cat = torch.cat([wg, wu], dim=2)
    sw_err = 0.0
    for c in SWIGLU_CAPACITIES:
        x = randn(e, c, dm)
        got = group_gemm_swiglu(x, wg, wu)
        want = group_swiglu_reference(x, wg, wu)
        torch.cuda.synchronize()
        err = close(got, want, BF16_ATOL, BF16_RTOL)
        sw_err = max(sw_err, err)
        kernel_ms = time_ms(lambda: group_gemm_swiglu(x, wg, wu), flush_buf)
        plain_ms = time_ms(lambda: group_swiglu_reference(x, wg, wu), flush_buf, iters=5)
        lib_ms = time_ms(lambda: torch.bmm(x, w_cat), flush_buf)
        b_ms, b_by = bound_ms(swiglu_flops(x, wg), swiglu_bytes(x, wg))
        log(f"group_gemm_swiglu E={e} C={c} d={dm} f={f} bf16: max|err| {err:.3e}; kernel_ms {kernel_ms}, "
            f"plain_ms {plain_ms}, library_ms(bmm x@[wg|wu]) {lib_ms}, bound_ms {b_ms} ({b_by})")
        if c == SWIGLU_CAPACITIES[0]:
            entries["group_gemm_swiglu"] = dict(
                name="group_gemm_swiglu", route="cuda", source="triton_dist_tpu_torch/csrc/group_gemm.cu",
                replaces="triton_dist_tpu/kernels/group_gemm.py:38", ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            )
    entries["group_gemm_swiglu"]["max_abs_err"] = sw_err
    log(f"card during phase 2 (clocks.sm, power.draw, temperature): {smi_sample()}")
    return entries


# ------------------------------------- 3. parity: CUDA vs CPU, small fp32

def parity_fp32(dev) -> None:
    """Phase 3: a small dense model and ``test-moe``, fp32, served on the
    card and on the CPU: greedy tokens equal, logits and KV close."""
    import torch

    from triton_dist_tpu_torch.models import PRESETS, DenseLLM, DenseParams, Engine, ModelConfig, Qwen3MoE, init_params

    def on_card(p):
        return DenseParams(**{k: None if t is None else t.to(dev) for k, t in vars(p).items()})

    small = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                        num_q_heads=8, num_kv_heads=2, head_dim=128, dtype="float32")
    p_cpu = init_params(small, torch.Generator().manual_seed(SEED), "cpu")
    m_cpu = DenseLLM(small, p_cpu, device="cpu")
    m_gpu = DenseLLM(small, on_card(p_cpu), device=dev)
    ids = torch.randint(0, small.vocab_size, (2, 37), generator=torch.Generator().manual_seed(SEED))
    lg_cpu, (k_cpu, _) = m_cpu.prefill(ids)
    lg_gpu, (k_gpu, _) = m_gpu.prefill(ids)
    err_logits = close(lg_gpu.cpu(), lg_cpu, FP32_LOGITS_TOL, FP32_LOGITS_TOL)
    err_kv = close(k_gpu.cpu(), k_cpu, FP32_LOGITS_TOL, FP32_LOGITS_TOL)
    tok_cpu = Engine(m_cpu, max_len=64).serve(ids, gen_len=10)
    tok_gpu = Engine(m_gpu, max_len=64).serve(ids, gen_len=10)
    if not torch.equal(tok_gpu.cpu(), tok_cpu):
        raise AssertionError(f"greedy tokens differ:\ncuda {tok_gpu.tolist()}\ncpu  {tok_cpu.tolist()}")
    e_cpu, e_gpu = Engine(m_cpu, max_len=64), Engine(m_gpu, max_len=64)
    c_cpu, c_gpu = e_cpu.alloc_slots(2), e_gpu.alloc_slots(2)
    t_cpu, t_gpu = [], []
    for slot, n in enumerate((37, 11)):
        t_cpu.append(e_cpu.prefill_into_slot(c_cpu, slot, ids[slot:slot + 1, :n])[0])
        t_gpu.append(e_gpu.prefill_into_slot(c_gpu, slot, ids[slot:slot + 1, :n])[0])
    rem = torch.tensor([6, 3], dtype=torch.int32)
    out_cpu = e_cpu.decode_steps(c_cpu, torch.stack(t_cpu), rem, 6)[0]
    out_gpu = e_gpu.decode_steps(c_gpu, torch.stack(t_gpu), rem, 6)[0]
    if not torch.equal(out_gpu.cpu(), out_cpu):
        raise AssertionError(f"slot decode differs:\ncuda {out_gpu.tolist()}\ncpu  {out_cpu.tolist()}")
    log(f"parity fp32 (L=2, d=256, Hq=8, Hkv=2, D=128): prefill logits max|err| {err_logits:.3e}, "
        f"KV max|err| {err_kv:.3e} (tol {FP32_LOGITS_TOL}); serve and slot decode tokens equal "
        f"({tok_gpu.numel() + out_gpu.numel()} tokens)")

    # test-moe: prefill through the T < 8 branch and through tp_moe_rs_shard;
    # decode at batch 2 (the unchunked branch) and batch 8 (tp_moe_ar_shard).
    cfg = PRESETS["test-moe"]
    p_cpu = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    m_cpu = Qwen3MoE(cfg, p_cpu, device="cpu")
    m_gpu = Qwen3MoE(cfg, on_card(p_cpu), device=dev)
    ids = torch.randint(0, cfg.vocab_size, (8, 24), generator=torch.Generator().manual_seed(SEED + 2))
    errs = []
    for rows, n in ((1, 5), (2, 24)):
        lg_cpu, (k_cpu, _) = m_cpu.prefill(ids[:rows, :n])
        lg_gpu, (k_gpu, _) = m_gpu.prefill(ids[:rows, :n])
        errs.append(close(lg_gpu.cpu(), lg_cpu, FP32_LOGITS_TOL, FP32_LOGITS_TOL))
        errs.append(close(k_gpu.cpu(), k_cpu, FP32_LOGITS_TOL, FP32_LOGITS_TOL))
    n_tokens = 0
    for rows, gen_len in ((2, 10), (8, 6)):
        tok_cpu = Engine(m_cpu, max_len=64).serve(ids[:rows], gen_len=gen_len)
        tok_gpu = Engine(m_gpu, max_len=64).serve(ids[:rows], gen_len=gen_len)
        if not torch.equal(tok_gpu.cpu(), tok_cpu):
            raise AssertionError(f"test-moe greedy tokens differ (batch {rows}):\n"
                                 f"cuda {tok_gpu.tolist()}\ncpu  {tok_cpu.tolist()}")
        n_tokens += tok_gpu.numel()
    log(f"parity fp32 test-moe (L=2, d=64, E=8, top-2, f=48): prefill logits and KV max|err| "
        f"{max(errs):.3e} (tol {FP32_LOGITS_TOL}); serve tokens equal at batch 2 and 8 ({n_tokens} tokens)")


# ----------------------------------------------- 4. full-width serving

def serve_full_width(preset: str, model_cls, dev, serve_rows: int, serve_prompt: int,
                     serve_gen: int) -> dict[str, int]:
    """Build ``preset`` at full width and depth with random bf16 weights and
    serve it: four requests joined into four slots, ``DECODE_STEPS`` decode
    steps of all four, then one ``serve`` of ``serve_rows`` prompts. The
    launch counts are read around exactly that run and must be one per
    layer per prefill (flash_attention) and per decode step (flash_decode),
    and for a MoE model one per layer per prefill or decode step
    (group_gemm_swiglu). Returns those counts."""
    import torch

    from triton_dist_tpu_torch.kernels import launch_counts, reset_launch_counts
    from triton_dist_tpu_torch.models import PRESETS, Engine

    cfg = PRESETS[preset]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = model_cls(cfg, generator=torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in vars(model.params).values() if t is not None)
    shape = f"{cfg.num_experts} experts top-{cfg.top_k}, " if cfg.is_moe else ""
    log(f"{preset}: {cfg.num_layers} layers, {shape}{n_params / 1e9:.2f} B params bf16, "
        f"random init {time.perf_counter() - t0:.1f} s")
    engine = Engine(model, backend="dist", max_len=MAX_LEN)
    vocab = cfg.vocab_size
    tgen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def prompt(n, rows=1):
        return torch.randint(0, vocab, (rows, n), generator=tgen, device=dev)

    # Warm-up (cuBLAS handles, kernel modules), before the counted run.
    warm = engine.alloc_slots(4)
    tok, warm = engine.prefill_into_slot(warm, 0, prompt(32))
    engine.decode_steps(warm, torch.stack([tok] * 4), torch.tensor([2, 0, 0, 0]), 2)
    del warm
    torch.cuda.synchronize()

    prompts = [prompt(n) for n in FLASH_PROMPTS]
    serve_ids = prompt(serve_prompt, rows=serve_rows)
    cache = engine.alloc_slots(len(prompts))
    torch.cuda.synchronize()
    reset_launch_counts()
    ttft = []
    tokens0 = []
    for slot, ids in enumerate(prompts):
        t0 = time.perf_counter()
        tok, cache = engine.prefill_into_slot(cache, slot, ids)
        tokens0.append(int(tok))  # the host holds the first token: that is TTFT
        ttft.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, last, cache, rem = engine.decode_steps(
        cache, torch.tensor(tokens0, dtype=torch.int32), torch.full((4,), DECODE_STEPS), DECODE_STEPS)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / DECODE_STEPS
    t0 = time.perf_counter()
    served = engine.serve(serve_ids, gen_len=serve_gen)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()

    layers, prefills = cfg.num_layers, len(prompts) + 1
    steps = DECODE_STEPS + serve_gen - 1
    want = {
        "flash_attention": layers * prefills,
        "flash_decode": layers * steps,
        "group_gemm_swiglu": layers * (prefills + steps) if cfg.is_moe else 0,
    }
    if launches != want:
        raise AssertionError(f"{preset}: launches on the served path {launches}, expected {want}")
    for name, toks in (("decode_steps", out), ("serve", served)):
        if not bool(((toks >= 0) & (toks < vocab)).all()):
            raise AssertionError(f"{name} produced tokens outside the vocabulary: {toks.tolist()}")
    want_len = [n + DECODE_STEPS for n in FLASH_PROMPTS]
    if cache.lengths.tolist() != want_len or rem.tolist() != [0] * 4:
        raise AssertionError(f"slot lengths {cache.lengths.tolist()} != {want_len}")
    logits, _ = model.prefill(prompts[2])
    step_logits, _, _ = model.decode(last, cache.k, cache.v, cache.lengths)
    if not (bool(torch.isfinite(logits).all()) and bool(torch.isfinite(step_logits).all())):
        raise AssertionError(f"{preset}: non-finite logits at full width")
    for n, t in zip(FLASH_PROMPTS, ttft):
        log(f"{preset} request prompt={n}: TTFT {t:.2f} ms")
    log(f"{preset} decode_steps B=4, {DECODE_STEPS} steps: {decode_ms:.2f} ms/step "
        f"({4 * 1e3 / decode_ms:.1f} tokens/s); serve B={serve_rows} {serve_prompt}+{serve_gen} tokens: "
        f"{serve_ms:.1f} ms")
    log(f"{preset} launches on the served path ({prefills} prefills, {steps} decode steps): {launches}")
    log(f"{preset} peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"first tokens {tokens0}, decode row 0 {out[0, :8].tolist()}")
    log(f"card after {preset} decode (clocks.sm, power.draw, temperature): {smi_sample()}")

    # Where a step's time goes: one profiled prefill and one profiled
    # 4-step decode chunk, after the counted run.
    for label, fn, n_steps, unprofiled in (
        (f"prefill {FLASH_PROMPTS[2]} tokens", lambda: model.prefill(prompts[2]), 1, ttft[2]),
        ("decode_steps B=4", lambda: engine.decode_steps(cache, last, torch.full((4,), 4), 4), 4, decode_ms),
    ):
        wall, busy, families, n_kernels = profile_window(fn)
        if busy is None:
            log(f"{preset} profile {label}: wall {wall / n_steps:.2f} ms/step, device time not measured "
                "(the profiler recorded no CUDA kernels)")
            continue
        shares = ", ".join(f"{k} {v / n_steps:.3f} ms" for k, v in
                           sorted(families.items(), key=lambda kv: -kv[1]))
        log(f"{preset} profile {label}: profiled wall {wall / n_steps:.2f} ms/step, device busy "
            f"{busy / n_steps:.3f} ms/step ({100 * busy / wall:.1f} % of the profiled wall; the "
            f"unprofiled run took {unprofiled:.2f} ms/step), {n_kernels / n_steps:.0f} kernels/step; "
            f"by kernel family per step: {shares}")
    if cfg.is_moe:
        for tokens, mode in ((4, "dist_ar"), (FLASH_PROMPTS[2], "dist")):
            moe_layer_breakdown(model, dev, tokens, mode)
    return launches


def moe_layer_breakdown(model, dev, tokens: int, mode: str) -> None:
    """Device time of one MoE layer at ``tokens`` tokens, piece by piece,
    each piece profiled on its own after the counted run: the routing
    (router matmul, top-k, plan) with the dispatch, the grouped gate/up
    kernel, the grouped down GEMM, the combine, and the whole layer."""
    import torch

    from triton_dist_tpu_torch.kernels.group_gemm import group_gemm, group_gemm_swiglu, matmul_f32
    from triton_dist_tpu_torch.kernels.moe_utils import capacity_for, combine, dispatch, make_routing_plan, topk_routing
    from triton_dist_tpu_torch.layers.tp import MOE_CAPACITY_FACTOR

    moe = model.layers[0][3]
    d, e = moe.w_router.shape
    x = torch.randn((tokens, d), generator=torch.Generator(device=dev).manual_seed(SEED + 3), device=dev)
    x = x.to(moe.w_router.dtype)
    cap = capacity_for(tokens, moe.top_k, e, MOE_CAPACITY_FACTOR)

    def route():
        idx, w = topk_routing(matmul_f32(x, moe.w_router), moe.top_k)
        plan = make_routing_plan(idx, e, cap)
        return plan, w, dispatch(x, plan)

    plan, w, xe = route()
    h = group_gemm_swiglu(xe, moe.w_gate, moe.w_up)
    y = group_gemm(h, moe.w_down)
    pieces = (
        ("routing + dispatch", route),
        ("group_gemm_swiglu", lambda: group_gemm_swiglu(xe, moe.w_gate, moe.w_up)),
        ("grouped down GEMM", lambda: group_gemm(h, moe.w_down)),
        ("combine", lambda: combine(y, plan, w, tokens, out_dtype=torch.float32).to(x.dtype)),
        ("whole layer", lambda: moe(x, mode=mode)),
    )
    # Each piece runs 10 times in one profiled window. Every run launches the
    # same kernels, so a count that is not a multiple of 10 shows that the
    # profiler lost records past the padding, and the piece is reported as
    # not measured.
    reps = 10
    parts = []
    for label, fn in pieces:
        fn()  # warm
        _, busy, _, n_kernels = profile_window(lambda: [fn() for _ in range(reps)])
        if busy is None or n_kernels == 0 or n_kernels % reps:
            parts.append(f"{label} not measured (the profiler recorded {n_kernels} kernels in {reps} runs)")
        else:
            parts.append(f"{label} {busy / reps} ms busy in {n_kernels // reps} kernels")
    log(f"moe layer T={tokens} mode={mode} C={cap}: " + "; ".join(parts))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no card, no run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    from triton_dist_tpu_torch.kernels import _build
    from triton_dist_tpu_torch.models import DenseLLM, Qwen3MoE
    from triton_dist_tpu_torch.runtime import device_report, nvidia_smi_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()

    # ------------------------------------------------------------ 1. build
    log(card)  # nvidia-smi's name and power limit, as it prints them
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    per_source = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
        + ", ".join(f"{k} {v:.1f} s" for k, v in per_source.items()))
    for name, text in sorted(_build.BUILD_LOGS.items()):
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill stores", text))
        log(f"  ptxas {name}: {len(regs)} kernels, registers {min(regs)}-{max(regs)}, "
            f"spill stores {spills} bytes in all")

    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    entries = check_kernels(dev, flush_buf)
    del flush_buf
    parity_fp32(dev)

    launches = serve_full_width("qwen3-8b", DenseLLM, dev, serve_rows=2, serve_prompt=128, serve_gen=16)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"qwen3-8b freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated")
    moe_launches = serve_full_width("qwen3-moe-30b-a3b", Qwen3MoE, dev, serve_rows=8, serve_prompt=64,
                                    serve_gen=8)

    # --------------------------------------------------------- 5. results
    kernels = []
    for name in ("flash_attention", "flash_decode", "group_gemm_swiglu"):
        e = dict(entries[name])
        e["launches"] = launches[name] + moe_launches[name]
        kernels.append({k: e[k] for k in ("name", "route", "source", "replaces", "launches",
                                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device_report()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

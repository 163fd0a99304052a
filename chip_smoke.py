#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``triton_dist_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``triton_dist_tpu_torch/csrc`` and
then, on the card:

1. prints the card (``nvidia-smi`` name and power limit) and the build time;
2. holds each kernel against its plain PyTorch version at the shapes the
   served paths give it (bf16) and times kernel, plain version, the
   yardstick PyTorch calls (``scaled_dot_product_attention`` for attention,
   one ``torch.bmm`` of x against the concatenated gate and up weights for
   the grouped SwiGLU, the cuBLAS products (and SDPA) of each mega decode
   kernel; the port calls none of them) and the card's bound for the same
   work;
3. serves a small dense model, ``test-dense`` on the mega backend, the
   ``test-moe`` MoE model on ``dist`` and ``mega``, and through the paged
   pool ``test-moe`` and ``test-dense`` on ``mega`` and ``test-dense`` on
   ``dist`` (fp32) through ``Engine`` on CUDA and on the CPU (plain
   versions) and requires equal greedy tokens and close logits;
4. serves Qwen3-8B at full width and depth (36 layers, bf16, random weights
   from a seeded generator): four requests joined into four slots with
   ``prefill_into_slot`` and decoded together with ``decode_steps``, plus one
   batch-2 ``serve``, with the kernels' launch counts read around exactly
   that run, first on the ``dist`` backend and then, on the same model and
   requests, on ``mega``, then on ``mega`` through a paged KV pool
   (``alloc_paged``, ``prefill_chunk`` in chunks of 256,
   ``complete_paged_prefill``, ``decode_steps_paged``); then frees it and
   serves Qwen3-30B-A3B at full width and depth (48 layers, 128 experts,
   top-8, bf16) with the same four requests and a batch-8 ``serve`` on
   ``dist``, and the four requests on ``mega`` through the pool, each run's
   counts read around its own run;
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
# The mega backend's fused decode kernels, timed at the Qwen3-8B decode step
# of phase 4 (batch 4); the attention back-leg at the lengths of its slots
# one step before a full cache.
MEGA_KERNELS = ("fused_ln_qkv_rope", "fused_attn_back", "fused_mlp_block", "fused_norm_head")
MEGA_LENGTHS = (1, 777, 1500, MAX_LEN - 1)
# The paged KV pool of this slice: rows per block, the prefill chunk, and
# the capacities the routed-experts kernel is checked at (8 is what decode
# at batch <= 8 gives Qwen3-30B-A3B).
PAGED_BS = 16
PAGED_CHUNK = 256
MOE_CAPACITIES = (8, 16)


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
    """Median of per-launch CUDA-event times, L2 flushed before each. A spin
    kernel of about 0.2 ms runs before the start event, so the card is busy
    while the host prepares the call and the events bracket device time, not
    the host's dispatch of the wrapper."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush_buf.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(400_000)
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


_MEGA_FAMILIES = (("qkv_partial", "fused_ln_qkv_rope"), ("qkv_epilogue", "fused_ln_qkv_rope"),
                  ("attn_back", "fused_attn_back"), ("oproj_partial", "fused_attn_back"),
                  ("mlp_tile", "fused_mlp_block"), ("mlp_reduce", "fused_mlp_block"),
                  ("norm_head", "fused_norm_head"), ("paged_decode", "paged_flash_decode"),
                  ("moe_tile", "fused_moe_block"), ("moe_reduce", "fused_moe_block"))


def _family(kernel_name: str) -> str:
    for word, family in _MEGA_FAMILIES:
        if word in kernel_name:
            return family
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


def kernel_passes(fn, flush_buf, reps: int = 10) -> dict[str, float]:
    """Device time (ms, mean over ``reps`` calls, L2 flushed before each) of
    every CUDA kernel one call of ``fn`` launches, by kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush_buf.zero_()
            fn()
        torch.cuda.synchronize()
    passes = {}
    for e in prof.events():
        name = re.sub(r"^void |\(anonymous namespace\)::|[<(].*", "", e.name)
        if e.device_type != DeviceType.CUDA or "elementwise" in name:  # the flush
            continue
        passes[name] = passes.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / reps
    return passes


def check_mega_kernels(dev, flush_buf) -> dict[str, dict]:
    """Phase 2, mega backend: each fused decode kernel against its plain
    version at the Qwen3-8B decode step's shapes (bf16, batch 4), then
    timed. The yardstick of each is the library calls for its products
    (cuBLAS ``torch.matmul``; SDPA for the attention), timed together."""
    import torch
    import torch.nn.functional as F

    from triton_dist_tpu_torch.kernels import mega_decode as mk
    from triton_dist_tpu_torch.kernels.norm_rope import rmsnorm
    from triton_dist_tpu_torch.models import PRESETS

    c = PRESETS["qwen3-8b"]
    d, ff, hq, hkv, hd, vocab = (c.hidden_size, c.intermediate_size, c.num_q_heads, c.num_kv_heads,
                                 c.head_dim, c.vocab_size)
    b = len(MEGA_LENGTHS)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def norm_w(n):
        return (torch.rand(n, generator=gen, device=dev) + 0.5).to(torch.bfloat16)

    lengths = torch.tensor(MEGA_LENGTHS, dtype=torch.int32, device=dev)
    x = randn(b, d)
    ln_w = norm_w(d)
    xn = rmsnorm(x, ln_w, c.rms_eps)
    wqkv = randn(d, (hq + 2 * hkv) * hd, scale=d ** -0.5)
    qn, kn = norm_w(hd), norm_w(hd)
    rope = dict(num_q_heads=hq, num_kv_heads=hkv, head_dim=hd, rope_theta=c.rope_theta, eps=c.rms_eps)
    q, k_new, v_new = randn(b, hq, hd), randn(b, hkv, hd), randn(b, hkv, hd)
    kc, vc = randn(b, hkv, MAX_LEN, hd), randn(b, hkv, MAX_LEN, hd)
    wo = randn(hq * hd, d, scale=(hq * hd) ** -0.5)
    o = randn(b, hq * hd)
    mask = (torch.arange(MAX_LEN, device=dev)[None, :] <= lengths[:, None])[:, None, None, :]
    wg, wu = randn(d, ff, scale=d ** -0.5), randn(d, ff, scale=d ** -0.5)
    wd = randn(ff, d, scale=ff ** -0.5)
    w_gu = torch.cat([wg, wu], dim=1)
    h = randn(b, ff)
    head = randn(d, vocab, scale=d ** -0.5)

    cases = {
        "fused_ln_qkv_rope": (
            "triton_dist_tpu_torch/csrc/mega_ln_qkv_rope.cu", "triton_dist_tpu/megakernel/kernels.py:113",
            lambda: mk.fused_ln_qkv_rope(x, ln_w, wqkv, qn, kn, lengths, **rope),
            lambda: mk.ln_qkv_rope_reference(x, ln_w, wqkv, qn, kn, lengths, **rope),
            lambda: torch.matmul(xn, wqkv), "matmul xn@wqkv", mk.ln_qkv_rope_cost(x, wqkv)),
        "fused_attn_back": (
            "triton_dist_tpu_torch/csrc/mega_attn_back.cu", "triton_dist_tpu/megakernel/kernels.py:310",
            lambda: mk.fused_attn_back(q, k_new, v_new, kc, vc, lengths, wo),
            lambda: mk.attn_back_reference(q, k_new, v_new, kc, vc, lengths, wo),
            lambda: (F.scaled_dot_product_attention(q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True),
                     torch.matmul(o, wo)),
            "SDPA + matmul o@wo", mk.attn_back_cost(q, kc, lengths, wo)),
        "fused_mlp_block": (
            "triton_dist_tpu_torch/csrc/mega_mlp_block.cu", "triton_dist_tpu/megakernel/kernels.py:31",
            lambda: mk.fused_mlp_block(x, ln_w, wg, wu, wd, eps=c.rms_eps),
            lambda: mk.mlp_block_reference(x, ln_w, wg, wu, wd, eps=c.rms_eps),
            lambda: (torch.matmul(xn, w_gu), torch.matmul(h, wd)), "matmul xn@[wg|wu] + h@wd",
            mk.mlp_block_cost(x, wg)),
        "fused_norm_head": (
            "triton_dist_tpu_torch/csrc/mega_norm_head.cu", "triton_dist_tpu/megakernel/kernels.py:581",
            lambda: mk.fused_norm_head(x, ln_w, head, eps=c.rms_eps),
            lambda: mk.norm_head_reference(x, ln_w, head, eps=c.rms_eps),
            lambda: torch.matmul(xn, head), "matmul xn@lm_head", mk.norm_head_cost(x, head)),
    }
    entries = {}
    for name, (source, replaces, kernel, plain, library, lib_label, (flops, nbytes)) in cases.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        err = max(close(g, w, BF16_ATOL, BF16_RTOL) for g, w in zip(got, want))
        kernel_ms = time_ms(kernel, flush_buf)
        plain_ms = time_ms(plain, flush_buf, iters=5)
        lib_ms = time_ms(library, flush_buf)
        b_ms, b_by = bound_ms(flops, nbytes)
        log(f"{name} qwen3-8b B={b} bf16: max|err| {err:.3e}; kernel_ms {kernel_ms}, plain_ms {plain_ms}, "
            f"library_ms({lib_label}) {lib_ms}, bound_ms {b_ms} ({b_by}; {nbytes} bytes, {flops} FLOP); "
            f"device ms by pass: {kernel_passes(kernel, flush_buf)}")
        entries[name] = dict(name=name, route="cuda", source=source, replaces=replaces, ms=kernel_ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                             max_abs_err=err)
    log(f"card after the mega kernels (clocks.sm, power.draw, temperature): {smi_sample()}")
    return entries


def _shuffled_pool(gen, lengths, hq, hkv, d, dev):
    """q, a shuffled block pool (``PAGED_BS`` rows a block, tables for
    ``MAX_LEN`` rows) and its tables, each sequence owning distinct blocks,
    NULL past its chain."""
    import torch

    b, bs, mb = len(lengths), PAGED_BS, MAX_LEN // PAGED_BS
    nb = 1 + b * mb
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(SEED)) + 1
    tables = perm.reshape(b, mb).to(torch.int32)
    for i, n in enumerate(lengths):
        tables[i, -(-n // bs):] = 0

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    return (randn(b, hq, d), randn(nb, hkv, bs, d), randn(nb, hkv, bs, d), tables.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def check_paged_moe_kernels(dev, flush_buf) -> dict[str, dict]:
    """Phase 2, this slice's kernels (bf16): the block-table walk at both
    models' decode shapes (B = 4, bs = 16, a shuffled table, lengths
    1/777/1500/2047, then 0/bs-1/bs/S) against its plain version and
    bitwise against ``flash_decode`` on the gathered view; the routed-experts
    kernel at Qwen3-30B-A3B's widths, C = 8 and 16, with empty experts."""
    import torch
    import torch.nn.functional as F

    from triton_dist_tpu_torch.kernels.flash_decode import (
        flash_decode,
        gather_paged_kv,
        paged_decode_cost,
        paged_decode_reference,
        paged_flash_decode,
    )
    from triton_dist_tpu_torch.kernels.mega_moe import fused_moe_block, moe_block_cost, moe_block_reference
    from triton_dist_tpu_torch.models import PRESETS

    cfg8b, cfg_moe = PRESETS["qwen3-8b"], PRESETS["qwen3-moe-30b-a3b"]
    hq, d = cfg8b.num_q_heads, cfg8b.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    entries = {}
    err_max = 0.0
    for label, hkv in (("qwen3-8b", cfg8b.num_kv_heads), ("qwen3-moe-30b-a3b", cfg_moe.num_kv_heads)):
        for lengths in (MEGA_LENGTHS, (0, PAGED_BS - 1, PAGED_BS, MAX_LEN)):
            q, kp, vp, tables, lens = _shuffled_pool(gen, lengths, hq, hkv, d, dev)
            got_o, got_lse = paged_flash_decode(q, kp, vp, tables, lens, return_lse=True)
            want_o, want_lse = paged_decode_reference(q, kp, vp, tables, lens, return_lse=True)
            kc, vc = gather_paged_kv(kp, tables), gather_paged_kv(vp, tables)
            ref_o, ref_lse = flash_decode(q, kc, vc, lens, return_lse=True)
            torch.cuda.synchronize()
            err = close(got_o, want_o, BF16_ATOL, BF16_RTOL)
            lse_err = close(got_lse, want_lse, LSE_ATOL, 0.0)
            if not (torch.equal(got_o, ref_o) and torch.equal(got_lse, ref_lse)):
                raise AssertionError(f"paged_flash_decode {label} lengths {lengths}: not bitwise equal to "
                                     "flash_decode on the gathered view")
            err_max = max(err_max, err)
            log(f"paged_flash_decode {label} B={len(lengths)} bs={PAGED_BS} lengths {list(lengths)}: max|o err| "
                f"{err:.3e}, max|lse err| {lse_err:.3e}; bitwise equal to flash_decode on the gathered view")
            if lengths != MEGA_LENGTHS:
                continue
            mask = (torch.arange(MAX_LEN, device=dev)[None, :] < lens[:, None])[:, None, None, :]
            kernel_ms = time_ms(lambda: paged_flash_decode(q, kp, vp, tables, lens), flush_buf)
            plain_ms = time_ms(lambda: paged_decode_reference(q, kp, vp, tables, lens), flush_buf, iters=5)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], gather_paged_kv(kp, tables), gather_paged_kv(vp, tables), attn_mask=mask,
                enable_gqa=True), flush_buf)
            flops, nbytes = paged_decode_cost(q, kp, tables, lens)
            b_ms, b_by = bound_ms(flops, nbytes)
            log(f"paged_flash_decode {label} B={len(lengths)} Hq={hq} Hkv={hkv} D={d} bf16: kernel_ms {kernel_ms}, "
                f"plain_ms {plain_ms}, library_ms(gather_paged_kv + SDPA, two calls) {lib_ms}, bound_ms {b_ms} "
                f"({b_by}; {nbytes} bytes)")
            if label == "qwen3-8b":
                entries["paged_flash_decode"] = dict(
                    name="paged_flash_decode", route="cuda", source="triton_dist_tpu_torch/csrc/flash_decode.cu",
                    replaces="triton_dist_tpu/kernels/flash_decode.py:205", ms=kernel_ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    entries["paged_flash_decode"]["max_abs_err"] = err_max
    del q, kp, vp, kc, vc

    e, dm, f = cfg_moe.num_experts, cfg_moe.hidden_size, cfg_moe.moe_intermediate_size
    def weight(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * shape[-2] ** -0.5).to(torch.bfloat16)

    wg, wu, wd = weight(e, dm, f), weight(e, dm, f), weight(e, f, dm)
    w_cat = torch.cat([wg, wu], dim=2)
    err_max = 0.0
    for c in MOE_CAPACITIES:
        # Experts 1, 4, 7, ... are empty; the others hold 1..C tokens, zero rows after.
        fill = torch.randint(1, c + 1, (e,), generator=torch.Generator().manual_seed(c))
        fill[1::3] = 0
        rows = (torch.arange(c)[None, :] < fill[:, None]).to(dev)
        xe = (torch.randn((e, c, dm), generator=gen, device=dev) * rows[..., None]).to(torch.bfloat16)
        got, want = fused_moe_block(xe, wg, wu, wd), moe_block_reference(xe, wg, wu, wd)
        torch.cuda.synchronize()
        err = close(got, want, BF16_ATOL, BF16_RTOL)
        if got[1::3].any():
            raise AssertionError("fused_moe_block: an empty expert gave a nonzero output")
        err_max = max(err_max, err)

        def library():
            gu = torch.bmm(xe, w_cat)
            return torch.bmm(F.silu(gu[..., :f]) * gu[..., f:], wd)

        kernel_ms = time_ms(lambda: fused_moe_block(xe, wg, wu, wd), flush_buf)
        plain_ms = time_ms(lambda: moe_block_reference(xe, wg, wu, wd), flush_buf, iters=5)
        lib_ms = time_ms(library, flush_buf)
        flops, nbytes = moe_block_cost(xe, wg)
        b_ms, b_by = bound_ms(flops, nbytes)
        log(f"fused_moe_block E={e} C={c} d={dm} f={f} bf16 ({int((fill == 0).sum())} empty experts): max|err| "
            f"{err:.3e}; kernel_ms {kernel_ms}, plain_ms {plain_ms}, library_ms(bmm x@[wg|wu], silu*mul, bmm h@wd) "
            f"{lib_ms}, bound_ms {b_ms} ({b_by}; {nbytes} bytes); device ms by pass: "
            f"{kernel_passes(lambda: fused_moe_block(xe, wg, wu, wd), flush_buf)}")
        if c == MOE_CAPACITIES[0]:
            entries["fused_moe_block"] = dict(
                name="fused_moe_block", route="cuda", source="triton_dist_tpu_torch/csrc/mega_moe_block.cu",
                replaces="triton_dist_tpu/megakernel/kernels.py:239", ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    # The panels one decode step gives it: 4 tokens, top-8 of a random
    # router, dispatched at capacity_for(4, 8, 128); at most 32 experts live.
    from triton_dist_tpu_torch.kernels.moe_utils import capacity_for, dispatch, make_routing_plan, topk_routing

    x = torch.randn((4, dm), generator=gen, device=dev).to(torch.bfloat16)
    idx, _ = topk_routing(x.float() @ torch.randn((dm, e), generator=gen, device=dev), cfg_moe.top_k)
    xe = dispatch(x, make_routing_plan(idx, e, capacity_for(4, cfg_moe.top_k, e)))
    got, want = fused_moe_block(xe, wg, wu, wd), moe_block_reference(xe, wg, wu, wd)
    torch.cuda.synchronize()
    err_max = max(err_max, close(got, want, BF16_ATOL, BF16_RTOL))
    kernel_ms = time_ms(lambda: fused_moe_block(xe, wg, wu, wd), flush_buf)
    flops, nbytes = moe_block_cost(xe, wg)
    b_ms, b_by = bound_ms(flops, nbytes)
    log(f"fused_moe_block decode-routed panels (4 tokens, top-{cfg_moe.top_k}, C={xe.shape[1]}, "
        f"{int(xe.ne(0).any(2).any(1).sum())} live experts): kernel_ms {kernel_ms}, bound_ms {b_ms} "
        f"({b_by}; {nbytes} bytes)")
    entries["fused_moe_block"]["max_abs_err"] = err_max
    log(f"card after the paged and MoE kernels (clocks.sm, power.draw, temperature): {smi_sample()}")
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

    # The mega backend on test-dense: one decode step's logits, a serve, and
    # a slot decode with slot 1 left free.
    cfg = PRESETS["test-dense"]
    p_cpu = init_params(cfg, torch.Generator().manual_seed(SEED + 4), "cpu")
    m_cpu = DenseLLM(cfg, p_cpu, device="cpu")
    m_gpu = DenseLLM(cfg, on_card(p_cpu), device=dev)
    ids = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(SEED + 5))
    e_cpu, e_gpu = Engine(m_cpu, backend="mega", max_len=64), Engine(m_gpu, backend="mega", max_len=64)
    tok_cpu, tok_gpu = e_cpu.serve(ids, gen_len=10), e_gpu.serve(ids, gen_len=10)
    if not torch.equal(tok_gpu.cpu(), tok_cpu):
        raise AssertionError(f"mega greedy tokens differ:\ncuda {tok_gpu.tolist()}\ncpu  {tok_cpu.tolist()}")
    c_cpu, c_gpu = e_cpu.kv_cache, e_gpu.kv_cache
    err_kv = close(c_gpu.k.cpu(), c_cpu.k, FP32_LOGITS_TOL, FP32_LOGITS_TOL)
    lg_cpu = e_cpu._decode(tok_cpu[:, -1], c_cpu, c_cpu.lengths)
    lg_gpu = e_gpu._decode(tok_gpu[:, -1], c_gpu, c_gpu.lengths)
    err_logits = close(lg_gpu.cpu(), lg_cpu, FP32_LOGITS_TOL, FP32_LOGITS_TOL)
    outs = []
    for eng in (e_cpu, e_gpu):
        cache = eng.alloc_slots(3)
        t0 = eng.prefill_into_slot(cache, 0, ids[:1])[0]
        t2 = eng.prefill_into_slot(cache, 2, ids[1:, :7])[0]
        out, _, cache, _ = eng.decode_steps(cache, torch.stack([t0, t0, t2]), torch.tensor([6, 0, 4]), 6)
        outs.append((out.cpu(), cache.lengths.cpu().tolist()))
    if not torch.equal(outs[1][0], outs[0][0]) or not outs[1][1] == outs[0][1] == [12 + 6, 0, 7 + 4]:
        raise AssertionError(f"mega slot decode differs:\ncuda {outs[1]}\ncpu  {outs[0]}")
    log(f"parity fp32 mega test-dense (L=2, d=64, Hq=8, Hkv=4, D=32): decode logits max|err| {err_logits:.3e}, "
        f"KV max|err| {err_kv:.3e} (tol {FP32_LOGITS_TOL}); serve and slot decode tokens equal, slot 1 "
        f"free (-1 cells, length 0)")

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

    # test-moe on mega, contiguous: a serve and one more step's logits.
    e_cpu, e_gpu = Engine(m_cpu, backend="mega", max_len=64), Engine(m_gpu, backend="mega", max_len=64)
    tok_cpu, tok_gpu = e_cpu.serve(ids[:4], gen_len=8), e_gpu.serve(ids[:4], gen_len=8)
    if not torch.equal(tok_gpu.cpu(), tok_cpu):
        raise AssertionError(f"test-moe mega tokens differ:\ncuda {tok_gpu.tolist()}\ncpu  {tok_cpu.tolist()}")
    lg_cpu = e_cpu._decode(tok_cpu[:, -1], e_cpu.kv_cache, e_cpu.kv_cache.lengths)
    lg_gpu = e_gpu._decode(tok_gpu[:, -1], e_gpu.kv_cache, e_gpu.kv_cache.lengths)
    err_logits = close(lg_gpu.cpu(), lg_cpu, FP32_LOGITS_TOL, FP32_LOGITS_TOL)
    log(f"parity fp32 test-moe mega (contiguous): serve tokens equal ({tok_gpu.numel()} tokens), decode logits "
        f"max|err| {err_logits:.3e}")

    # The paged pool: test-moe and test-dense on mega, test-dense on dist;
    # slot 1 free, staggered prompts, chunked prefill.
    for preset, cls, backend in (("test-moe", Qwen3MoE, "mega"), ("test-dense", DenseLLM, "mega"),
                                 ("test-dense", DenseLLM, "dist")):
        cfg = PRESETS[preset]
        p_cpu = init_params(cfg, torch.Generator().manual_seed(SEED + 6), "cpu")
        prompts = [torch.randint(0, cfg.vocab_size, (1, n), generator=torch.Generator().manual_seed(SEED + n))
                   for n in (21, 0, 9)]
        prompts[1] = None
        runs = []
        for model in (cls(cfg, p_cpu, device="cpu"), cls(cfg, on_card(p_cpu), device=dev)):
            engine = Engine(model, backend=backend, max_len=64)
            paged, tokens, _, logits = paged_prefill(engine, prompts, 6, block_size=8, chunk=8)
            out, _, paged, _ = engine.decode_steps_paged(paged, tokens, torch.tensor([6, 0, 4]), 6)
            runs.append((out.cpu(), paged.lengths.cpu().tolist(), [lg.cpu() for lg in logits],
                         paged.k[:, 1:].cpu()))
        (o_cpu, n_cpu, lg_cpu, k_cpu), (o_gpu, n_gpu, lg_gpu, k_gpu) = runs
        if not torch.equal(o_gpu, o_cpu) or not n_gpu == n_cpu == [21 + 6, 0, 9 + 4]:
            raise AssertionError(f"{preset} {backend} paged decode differs:\ncuda {o_gpu.tolist()} {n_gpu}\n"
                                 f"cpu  {o_cpu.tolist()} {n_cpu}")
        err_logits = max(close(g, c, FP32_LOGITS_TOL, FP32_LOGITS_TOL) for g, c in zip(lg_gpu, lg_cpu))
        err_kv = close(k_gpu, k_cpu, FP32_LOGITS_TOL, FP32_LOGITS_TOL)
        log(f"parity fp32 {preset} {backend} paged (bs 8, prompts 21/-/9 in chunks of 8, 6 steps): prefill "
            f"logits max|err| {err_logits:.3e}, pool max|err| {err_kv:.3e} (tol {FP32_LOGITS_TOL}); tokens "
            f"equal, slot 1 free")


# ----------------------------------------------- 4. full-width serving

def paged_prefill(engine, prompts, steps: int, *, block_size: int, chunk: int):
    """Join ``prompts`` ((1, P) id tensors; None leaves a slot free) into a
    fresh pool of ``engine``: each slot's chain comes from a
    ``BlockAllocator`` (room for ``steps`` more rows), its prompt goes
    through ``prefill_chunk`` in chunks of ``min(chunk, P)`` (the last one
    padded) and ``complete_paged_prefill``; the tables and lengths are set
    on the handle. Returns (paged, first tokens (B,) int32, TTFT per slot in
    ms (the host holds the first token), final-chunk logits per slot)."""
    import torch

    from triton_dist_tpu_torch.models import sample_token
    from triton_dist_tpu_torch.models.kv_cache import BlockAllocator

    b, dev = len(prompts), engine.device
    mb = -(-engine.max_len // block_size)
    paged = engine.alloc_paged(b, block_size=block_size, num_blocks=1 + b * mb)
    alloc = BlockAllocator(paged.num_blocks)
    tokens, ttft, last_logits = [0] * b, [], []
    for slot, ids in enumerate(prompts):
        if ids is None:
            continue
        t0 = time.perf_counter()
        p = ids.shape[1]
        row = torch.zeros(mb, dtype=torch.int32)
        chain = alloc.alloc(-(-(p + steps) // block_size))
        row[:len(chain)] = torch.tensor(chain, dtype=torch.int32)
        kb, vb = engine.paged_kbuf_zeros(p)
        c = min(chunk, p)
        for off in range(0, p, c):
            ids_c = torch.zeros((1, c), dtype=torch.long, device=dev)
            take = ids[:, off:off + c]
            ids_c[:, :take.shape[1]] = take
            logits, kb, vb = engine.prefill_chunk(kb, vb, ids_c, off, p - 1 - off if off + c >= p else c - 1)
        engine.complete_paged_prefill(paged, kb, vb, row, 0)
        paged.tables[slot] = row.to(dev)
        paged.lengths[slot] = p
        tokens[slot] = int(sample_token(logits, None)[0])
        ttft.append((time.perf_counter() - t0) * 1e3)
        last_logits.append(logits)
    return paged, torch.tensor(tokens, dtype=torch.int32, device=dev), ttft, last_logits


def expected_paged_launches(cfg, chunks: int, steps: int) -> dict[str, int]:
    """A paged mega run: one flash_attention per layer per prefill chunk
    (and, for a MoE model, one group_gemm_swiglu: chunks route through
    TP_MoE), and per decode step one fused_ln_qkv_rope, paged_flash_decode
    and fused_moe_block / fused_mlp_block per layer, one fused_norm_head."""
    layers = cfg.num_layers
    want = {name: 0 for name in expected_launches(cfg, "mega", 0, 0)}
    want.update(flash_attention=layers * chunks, fused_ln_qkv_rope=layers * steps,
                paged_flash_decode=layers * steps, fused_norm_head=steps)
    if cfg.is_moe:
        want.update(group_gemm_swiglu=layers * chunks, fused_moe_block=layers * steps)
    else:
        want["fused_mlp_block"] = layers * steps
    return want


def serve_paged_full_width(model, preset: str, dev) -> tuple[dict[str, int], object]:
    """The four requests of ``serve_full_width`` on ``Engine(model,
    backend="mega")`` through a paged pool: chains from a
    ``BlockAllocator``, each prompt through ``paged_kbuf_zeros``,
    ``prefill_chunk`` (chunks of ``PAGED_CHUNK``) and
    ``complete_paged_prefill``, then ``DECODE_STEPS`` steps of
    ``decode_steps_paged``. The launch counts are read around exactly that
    run and must equal ``expected_paged_launches``. Returns the counts and
    the engine."""
    import torch

    from triton_dist_tpu_torch.kernels import launch_counts, reset_launch_counts
    from triton_dist_tpu_torch.models import Engine

    cfg = model.config
    tag = f"{preset} [mega, paged]"
    torch.cuda.reset_peak_memory_stats()
    engine = Engine(model, backend="mega", max_len=MAX_LEN)
    tgen = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompts = [torch.randint(0, cfg.vocab_size, (1, n), generator=tgen, device=dev) for n in FLASH_PROMPTS]
    # Warm-up (library handles, the new kernels' first launches), uncounted.
    warm, tok, _, _ = paged_prefill(engine, [prompts[0][:, :32]], 2, block_size=PAGED_BS, chunk=PAGED_CHUNK)
    engine.decode_steps_paged(warm, tok, torch.tensor([2]), 2)
    del warm
    torch.cuda.synchronize()

    reset_launch_counts()
    paged, tokens0, ttft, _ = paged_prefill(engine, prompts, DECODE_STEPS, block_size=PAGED_BS,
                                            chunk=PAGED_CHUNK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, last, paged, rem = engine.decode_steps_paged(paged, tokens0, torch.full((4,), DECODE_STEPS), DECODE_STEPS)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / DECODE_STEPS
    launches = launch_counts()

    chunks = sum(-(-n // min(PAGED_CHUNK, n)) for n in FLASH_PROMPTS)
    want = expected_paged_launches(cfg, chunks, DECODE_STEPS)
    if launches != want:
        raise AssertionError(f"{tag}: launches on the served path {launches}, expected {want}")
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"{tag}: tokens outside the vocabulary: {out.tolist()}")
    want_len = [n + DECODE_STEPS for n in FLASH_PROMPTS]
    if paged.lengths.tolist() != want_len or rem.tolist() != [0] * 4:
        raise AssertionError(f"{tag}: slot lengths {paged.lengths.tolist()} != {want_len}")
    active = torch.ones(4, dtype=torch.bool, device=dev)
    step_logits, _, _ = model.decode_mega_paged(engine._mega_paged_step, engine._mega_layers, last, paged.k,
                                                paged.v, paged.tables, paged.lengths, active)
    if not bool(torch.isfinite(step_logits).all()):
        raise AssertionError(f"{tag}: non-finite logits at full width")
    for n, t in zip(FLASH_PROMPTS, ttft):
        log(f"{tag} request prompt={n} ({-(-n // min(PAGED_CHUNK, n))} chunks): TTFT {t:.2f} ms")
    log(f"{tag} decode_steps_paged B=4 bs={PAGED_BS}, {DECODE_STEPS} steps: {decode_ms:.2f} ms/step "
        f"({4 * 1e3 / decode_ms:.1f} tokens/s); pool {paged.num_blocks} blocks, "
        f"{paged.bytes_per_block * paged.num_blocks / 2**30:.2f} GiB")
    log(f"{tag} launches on the served path ({chunks} prefill chunks, {DECODE_STEPS} decode steps): {launches}")
    log(f"{tag} peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; first tokens "
        f"{tokens0.tolist()}, decode row 0 {out[0, :8].tolist()}")
    log(f"card after {tag} decode (clocks.sm, power.draw, temperature): {smi_sample()}")
    wall, busy, families, n_kernels = profile_window(
        lambda: engine.decode_steps_paged(paged, last, torch.full((4,), 4), 4))
    if busy is None:
        log(f"{tag} profile decode_steps_paged B=4: wall {wall / 4:.2f} ms/step, device time not measured "
            "(the profiler recorded no CUDA kernels)")
    else:
        shares = ", ".join(f"{k} {v / 4:.3f} ms" for k, v in sorted(families.items(), key=lambda kv: -kv[1]))
        log(f"{tag} profile decode_steps_paged B=4: profiled wall {wall / 4:.2f} ms/step, device busy "
            f"{busy / 4:.3f} ms/step ({100 * busy / wall:.1f} % of the profiled wall; the unprofiled run took "
            f"{decode_ms:.2f} ms/step), {n_kernels / 4:.0f} kernels/step; by kernel family per step: {shares}")
    return launches, engine

def build_full_width(preset: str, model_cls, dev):
    """``preset`` at full width and depth with random bf16 weights from a
    seeded generator."""
    import torch

    from triton_dist_tpu_torch.models import PRESETS

    cfg = PRESETS[preset]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = model_cls(cfg, generator=torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in vars(model.params).values() if t is not None)
    shape = f"{cfg.num_experts} experts top-{cfg.top_k}, " if cfg.is_moe else ""
    log(f"{preset}: {cfg.num_layers} layers, {shape}{n_params / 1e9:.2f} B params bf16, "
        f"random init {time.perf_counter() - t0:.1f} s")
    return model


def expected_launches(cfg, backend: str, prefills: int, steps: int) -> dict[str, int]:
    """One launch per layer per prefill (flash_attention) and per decode
    step: flash_decode on ``dist``, the three fused layer kernels on
    ``mega`` (fused_moe_block in place of fused_mlp_block for a MoE model)
    plus one ``fused_norm_head`` per step; for a MoE model one
    group_gemm_swiglu per layer per prefill, and per decode step on
    ``dist``."""
    layers = cfg.num_layers
    mega = backend == "mega"
    return {
        "flash_attention": layers * prefills,
        "flash_decode": 0 if mega else layers * steps,
        "paged_flash_decode": 0,
        "group_gemm_swiglu": layers * (prefills + (0 if mega else steps)) if cfg.is_moe else 0,
        "fused_ln_qkv_rope": layers * steps if mega else 0,
        "fused_attn_back": layers * steps if mega else 0,
        "fused_mlp_block": layers * steps if mega and not cfg.is_moe else 0,
        "fused_norm_head": steps if mega else 0,
        "fused_moe_block": layers * steps if mega and cfg.is_moe else 0,
    }


def serve_full_width(model, preset: str, backend: str, dev, serve_rows: int, serve_prompt: int,
                     serve_gen: int, profile_prefill: bool = True) -> dict[str, int]:
    """Serve ``model`` through ``Engine(backend=...)``: four requests joined
    into four slots, ``DECODE_STEPS`` decode steps of all four, then one
    ``serve`` of ``serve_rows`` prompts (the same prompts for every backend:
    they come from a generator seeded here). The launch counts are read
    around exactly that run and must equal ``expected_launches``. Returns
    those counts."""
    import torch

    from triton_dist_tpu_torch.kernels import launch_counts, reset_launch_counts
    from triton_dist_tpu_torch.models import Engine

    cfg = model.config
    tag = f"{preset} [{backend}]"
    torch.cuda.reset_peak_memory_stats()
    engine = Engine(model, backend=backend, max_len=MAX_LEN)
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

    prefills, steps = len(prompts) + 1, DECODE_STEPS + serve_gen - 1
    want = expected_launches(cfg, backend, prefills, steps)
    if launches != want:
        raise AssertionError(f"{tag}: launches on the served path {launches}, expected {want}")
    for name, toks in (("decode_steps", out), ("serve", served)):
        if not bool(((toks >= 0) & (toks < vocab)).all()):
            raise AssertionError(f"{name} produced tokens outside the vocabulary: {toks.tolist()}")
    want_len = [n + DECODE_STEPS for n in FLASH_PROMPTS]
    if cache.lengths.tolist() != want_len or rem.tolist() != [0] * 4:
        raise AssertionError(f"slot lengths {cache.lengths.tolist()} != {want_len}")
    logits, _ = model.prefill(prompts[2])
    step_logits = engine._decode(last, cache, cache.lengths)
    if not (bool(torch.isfinite(logits).all()) and bool(torch.isfinite(step_logits).all())):
        raise AssertionError(f"{tag}: non-finite logits at full width")
    for n, t in zip(FLASH_PROMPTS, ttft):
        log(f"{tag} request prompt={n}: TTFT {t:.2f} ms")
    log(f"{tag} decode_steps B=4, {DECODE_STEPS} steps: {decode_ms:.2f} ms/step "
        f"({4 * 1e3 / decode_ms:.1f} tokens/s); serve B={serve_rows} {serve_prompt}+{serve_gen} tokens: "
        f"{serve_ms:.1f} ms")
    log(f"{tag} launches on the served path ({prefills} prefills, {steps} decode steps): {launches}")
    log(f"{tag} peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"first tokens {tokens0}, decode row 0 {out[0, :8].tolist()}")
    log(f"card after {tag} decode (clocks.sm, power.draw, temperature): {smi_sample()}")

    # Where a step's time goes: one profiled prefill and one profiled
    # 4-step decode chunk, after the counted run.
    windows = [("decode_steps B=4", lambda: engine.decode_steps(cache, last, torch.full((4,), 4), 4), 4,
                decode_ms)]
    if profile_prefill:
        windows.insert(0, (f"prefill {FLASH_PROMPTS[2]} tokens", lambda: model.prefill(prompts[2]), 1, ttft[2]))
    for label, fn, n_steps, unprofiled in windows:
        wall, busy, families, n_kernels = profile_window(fn)
        if busy is None:
            log(f"{tag} profile {label}: wall {wall / n_steps:.2f} ms/step, device time not measured "
                "(the profiler recorded no CUDA kernels)")
            continue
        shares = ", ".join(f"{k} {v / n_steps:.3f} ms" for k, v in
                           sorted(families.items(), key=lambda kv: -kv[1]))
        log(f"{tag} profile {label}: profiled wall {wall / n_steps:.2f} ms/step, device busy "
            f"{busy / n_steps:.3f} ms/step ({100 * busy / wall:.1f} % of the profiled wall; the "
            f"unprofiled run took {unprofiled:.2f} ms/step), {n_kernels / n_steps:.0f} kernels/step; "
            f"by kernel family per step: {shares}")
    if cfg.is_moe:
        for tokens, mode in ((4, "dist_ar"), (FLASH_PROMPTS[2], "dist")):
            moe_layer_breakdown(model, dev, tokens, mode)
    return launches


def compare_first_step(model, dev, paged_engine) -> None:
    """One decode step of the four served slots on ``mega`` and on ``dist``
    from the same caches (bf16), and on ``mega`` through the paged pool
    (``paged_engine``, prefilled in chunks): printed, not gated, since the
    paths round at different points."""
    import torch

    from triton_dist_tpu_torch.models import Engine

    tgen = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompts = [torch.randint(0, model.config.vocab_size, (1, n), generator=tgen, device=dev)
               for n in FLASH_PROMPTS]
    dist, mega = Engine(model, backend="dist", max_len=MAX_LEN), Engine(model, backend="mega", max_len=MAX_LEN)
    cache = dist.alloc_slots(len(prompts))
    tokens = torch.stack([dist.prefill_into_slot(cache, slot, ids)[0] for slot, ids in enumerate(prompts)])
    k0, v0 = cache.k.clone(), cache.v.clone()
    lg_dist = dist._decode(tokens, cache, cache.lengths)
    cache.k.copy_(k0)
    cache.v.copy_(v0)
    lg_mega = mega._decode(tokens, cache, cache.lengths)
    same = (lg_dist.argmax(-1) == lg_mega.argmax(-1)).tolist()
    log(f"qwen3-8b first decode step, mega vs dist (bf16, B=4): max |logit diff| "
        f"{(lg_mega - lg_dist).abs().max().item()}, max |logit| {lg_dist.abs().max().item()}, "
        f"greedy tokens equal {sum(same)}/{len(same)}")
    paged, _, _, _ = paged_prefill(paged_engine, prompts, 1, block_size=PAGED_BS, chunk=PAGED_CHUNK)
    active = torch.ones(len(prompts), dtype=torch.bool, device=dev)
    lg_paged, _, _ = model.decode_mega_paged(paged_engine._mega_paged_step, paged_engine._mega_layers, tokens,
                                             paged.k, paged.v, paged.tables, paged.lengths, active)
    same = (lg_paged.argmax(-1) == lg_mega.argmax(-1)).tolist()
    log(f"qwen3-8b first decode step, mega paged (chunked prefill) vs mega contiguous (bf16, B=4, same first "
        f"tokens): max |logit diff| {(lg_paged - lg_mega).abs().max().item()}, greedy tokens equal "
        f"{sum(same)}/{len(same)}")


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
    t_phase = time.perf_counter()
    entries = check_kernels(dev, flush_buf)
    entries.update(check_mega_kernels(dev, flush_buf))
    entries.update(check_paged_moe_kernels(dev, flush_buf))
    del flush_buf
    log(f"phase 2 (kernels vs plain, timed): {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    parity_fp32(dev)
    log(f"phase 3 (fp32 parity, CUDA vs CPU): {time.perf_counter() - t_phase:.1f} s")

    # Qwen3-8B on the default backend, on mega and on mega through the pool:
    # one model object, the same requests; each run's counts are read around
    # that run alone.
    t_phase = time.perf_counter()
    model = build_full_width("qwen3-8b", DenseLLM, dev)
    runs = [serve_full_width(model, "qwen3-8b", "dist", dev, serve_rows=2, serve_prompt=128, serve_gen=16)]
    runs.append(serve_full_width(model, "qwen3-8b", "mega", dev, serve_rows=2, serve_prompt=128, serve_gen=16,
                                 profile_prefill=False))
    paged_launches, paged_engine = serve_paged_full_width(model, "qwen3-8b", dev)
    runs.append(paged_launches)
    compare_first_step(model, dev, paged_engine)
    del model, paged_engine
    gc.collect()
    torch.cuda.empty_cache()
    log(f"qwen3-8b freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated; phase 4 qwen3-8b "
        f"{time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    model = build_full_width("qwen3-moe-30b-a3b", Qwen3MoE, dev)
    runs.append(serve_full_width(model, "qwen3-moe-30b-a3b", "dist", dev, serve_rows=8, serve_prompt=64,
                                 serve_gen=8))
    runs.append(serve_paged_full_width(model, "qwen3-moe-30b-a3b", dev)[0])
    del model
    log(f"phase 4 qwen3-moe-30b-a3b: {time.perf_counter() - t_phase:.1f} s")

    # --------------------------------------------------------- 5. results
    kernels = []
    for name in ("flash_attention", "flash_decode", "group_gemm_swiglu", *MEGA_KERNELS, "paged_flash_decode",
                 "fused_moe_block"):
        e = dict(entries[name])
        e["launches"] = sum(run[name] for run in runs)
        kernels.append({k: e[k] for k in ("name", "route", "source", "replaces", "launches",
                                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device_report()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

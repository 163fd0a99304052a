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
   work; row 3b (the walk of an fp8 or int8 pool) also bitwise against row
   3 on the pool dequantized to bf16, timed beside it;
3. serves a small dense model, ``test-dense`` on the mega backend, the
   ``test-moe`` MoE model on ``dist`` and ``mega``, and through the paged
   pool ``test-moe`` and ``test-dense`` on ``mega`` and ``test-dense`` on
   ``dist`` (fp32) through ``Engine`` on CUDA and on the CPU (plain
   versions), the paged ones again through fp8 and int8 pools, and requires
   equal greedy tokens and close logits; then every
   attention autograd function of ``triton_dist_tpu_torch.function`` and
   one ``test-dense`` attention-block SGD step (dense and packed), fp32,
   gradients on the card against the CPU's;
4. serves Qwen3-8B at full width and depth (36 layers, bf16, random weights
   from a seeded generator): four requests joined into four slots with
   ``prefill_into_slot`` and decoded together with ``decode_steps``, plus one
   batch-2 ``serve``, with the kernels' launch counts read around exactly
   that run, first on the ``dist`` backend and then, on the same model and
   requests, on ``mega``, then on ``mega`` through a paged KV pool
   (``alloc_paged``, ``prefill_chunk`` in chunks of 256,
   ``complete_paged_prefill``, ``decode_steps_paged``) and through fp8 and
   int8 pools of as many blocks; then frees it and
   serves Qwen3-30B-A3B at full width and depth (48 layers, 128 experts,
   top-8, bf16) with the same four requests and a batch-8 ``serve`` on
   ``dist``, and the four requests on ``mega`` through the pool and through
   an fp8 pool, each run's counts read around its own run, the quantized
   runs' first-step logits held to a band around the bf16 pool's;
5. spawns four rank processes at tensor-parallel world 4, rank r on card
   ``r % device_count`` (four ranks share the card when there is one; the
   GPU then time-slices their contexts), which map each other's
   symmetric heap through CUDA IPC: (5a) rows 16-19 and the barrier
   against their plain versions at the Qwen3-8B world-4 shapes and at the
   edges, rows 18 and 19 bitwise equal on every rank, each timed beside its
   bound and, when every rank has its own card, beside NCCL + cuBLAS;
   (5a-q) the same with an fp8 and an int8 A (rows 16q-19q), bitwise
   against the bf16-operand kernels on the dequantized A, and the four
   entry points driven once with an fp8 A, counts held to AUTO's routes;
   (5a') rows 20 (ring and full mesh), 21 and 22 bitwise against their
   plain versions at the served messages (a decode step's all-reduces, a
   1500-row fp32 two-shot) and at the edges, the same bits on every rank,
   each timed beside its bound and, with a card a rank, NCCL's collective;
   then the host ops ``all_reduce``, ``all_gather``, ``reduce_scatter`` at
   those sizes, counts held to AUTO's routes; (5b) a small fp32 model
   served on ``dist``, ``dist_ar`` and ``xla`` on the card and on the CPU
   inside the same ranks, tokens equal; (5b') the same for ``test-dense``
   on mega and a ``test-moe`` shape as ``Qwen3MoE`` on ``dist``,
   ``dist_ar`` and mega, decode hidden states the same bits on every rank;
   (5c) Qwen3-8B at full width and depth served on ``dist`` (four slots, 8
   decode steps on a shared card and 32 with a card a rank, one
   ``serve``) plus one ``dist_ar`` prefill, launch counts read
   around that run and held to the routers' prediction; (5c') the same
   model on mega (the four slots, 8 decode steps on a shared card and 32
   with a card a rank; row 22 twice a layer); then, expert-parallel:
   (5d) rows 25 (the all-to-all) and 26 (the fused dispatch, expert MLP
   and return) against their plain versions at the Qwen3-30B-A3B world-4
   shapes and at the edges, row 25 bitwise, row 26 bitwise equal on every
   rank where the ranks route the same tokens, each timed beside its bound
   and, with a card a rank, NCCL's all-to-all; (5e) the fp32 ``test-moe``
   ``EPMoELLM`` on ``xla``, ``dist`` and ``dist_ar``, card vs CPU, tokens
   equal and the decode's hidden states the same bits on every rank; (5f)
   Qwen3-30B-A3B as ``EPMoELLM`` at full width and depth (32 whole experts
   a rank) served on ``dist`` (four slots, 8 decode steps on a shared card
   and 32 with a card a rank) plus one ``dist_ar`` prefill, launch counts
   held to the routers' prediction; (5h) Qwen3-30B-A3B as ``Qwen3MoE``
   (``TP_MoE``: every expert's ff split over the ranks) at full width and
   depth on ``dist`` (the 5c prompts, one ``serve``) and on mega, counts
   held to the prediction; (5g) training at world 4: tutorial 09's
   TP MLP (``ag_gemm_fn``, ``gemm_rs_fn``), the causal ring
   (``ring_attention_fn``) and the EP MoE (``ep_moe_fused_fn``) at full
   width, each first at a small fp32 size card vs CPU, then two SGD steps
   with the loss falling, replicated gradients the same bits on every rank
   and the launch counts as predicted, and, fourth, the same attention
   block through ``ag_attention_fn`` (row 27 forward, row 5 and a
   reduce-scatter backward) at S_local 384; before it (5i)
   sequence-parallel attention at world 4: ``AGSPAttn`` (row 27 where
   JAX's plan fits, the ring where it does not), ``RingSPAttn`` (causal,
   packed), ``UlyssesSPAttn`` (row 25), the fused Ulysses projections and
   ``ag_attention_fn``'s gradients, small fp32 card vs CPU, then at
   Qwen3-8B's attention width in bf16 against row 1 over the gathered
   sequence with their launch counts and a profile line each, and row 27
   against its plain version, timed; last, the abort tests: three ranks
   call row 22, then row 27, without the fourth and each ends in a named
   ``CollectiveAbort``;
6. trains Qwen3-8B's attention block at world 1 (embed, RMSNorm, wqkv,
   RoPE, ``flash_attention_fn``, wo; B 1, S 4096, bf16): three SGD steps,
   then three through ``flash_attention_varlen_fn`` on a packed batch, the
   loss falling at every step and the counts as predicted;
7. prints one ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.

``python3 chip_smoke.py --quant-collectives`` runs phase 5a-q alone (rows
16q-19q against their plain versions, timed, and their entry points), and
``python3 chip_smoke.py --sequence-parallel`` phase 5i alone (the
sequence-parallel layers and row 27, timed), each for the four-card
measurement.

It exits nonzero and prints no result when CUDA is unavailable, when run
away from the repository, or when any phase fails.
"""

from __future__ import annotations

import gc
import json
import math
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
# Phase 5: four ranks, tensor-parallel world 4. The dist prefill splits
# B·S rows over the ranks, so every prompt is a multiple of 4 tokens; the
# serve is 2 rows of 128 + 16. NVLink's rate in one direction (H100 SXM
# data sheet: 900 GB/s both ways) bounds what crosses between ranks.
WORLD = 4
W4_PROMPTS = (96, 384, 776, 1500)
W4_SERVE = (2, 128, 16)
LINK_BYTES_PER_S = 450e9
W4_TIMEOUT_S = 900
#: The kernels of the multi-rank layer (rows 16-19 and the barrier).
COLLECTIVE_KERNELS = ("ag_gemm_fused", "gemm_rs_fused", "gemm_ar_fused", "gemm_ar_ll", "barrier_all_on_device")
# Phase 5d-5f: Qwen3-30B-A3B expert-parallel at world 4 (EPMoELLM, 32
# experts a rank) on dist, with the 5c prompts; decode steps at B = 4 when
# the ranks share one card, and when each has its own; the replicated
# prefill that takes row 26 on dist_ar.
EP_PRESET = "qwen3-moe-30b-a3b"
EP_STEPS_SHARED, EP_STEPS_OWN = 8, 32
EP_AR_PROMPT = 384
#: The expert-parallel kernels (rows 25 and 26).
EP_KERNELS = ("all_to_all_kernel", "fused_ep_kernel")
#: The standalone collectives (rows 20, ring and full mesh; 21; 22).
STANDALONE_KERNELS = ("ring_ag_call", "full_mesh_ag_call", "ring_rs_call", "one_shot_ar_call")
# Phase 5h: Qwen3-30B-A3B as Qwen3MoE (TP_MoE: every expert's ff split over
# the ranks) at world 4 on dist, with the 5c prompts and a serve of 2 x
# (128 + 8); then on mega. 5c' and 5h decode EP_STEPS_SHARED /
# EP_STEPS_OWN steps, as 5f does.
TP_MOE_PRESET = "qwen3-moe-30b-a3b"
TP_MOE_SERVE = (2, 128, 8)
# The training path (phases 2, 6 and 5g): Qwen3-8B's attention at B 1, S
# 4096, and the same 4096 tokens packed as sequences of 512, 1024, 1536 and
# 1000 with a padding tail of 24; SGD steps at world 1 and at world 4 (the
# TP MLP on 512 tokens a rank, the ring over 4 x 1024 tokens, the EP MoE at
# Qwen3-30B-A3B's width on 256 tokens a rank). SGD's rate is set once per
# tensor from the first step so that it moves the tensor by 1 % of its norm,
# which a bf16 weight keeps.
TRAIN_S = 4096
TRAIN_CU = (0, 512, 1536, 3072, 4072)
TRAIN_STEPS, TRAIN_STEPS_W4 = 3, 2
TRAIN_MLP_TOKENS, TRAIN_RING_TOKENS, TRAIN_EP_TOKENS = 512, 1024, 256
# Phase 5i: sequence-parallel attention at world 4 at Qwen3-8B's attention
# width (Hq 32, Hkv 8, D 128), bf16, B 1. AGSPAttn at S_local 384 (global
# 1536), the largest multiple of 128 whose TPU plan with residuals fits
# JAX's default 100 MB, so row 27; and at 1024 (global 4096), where it does
# not fit, so the ring. The ring (causal, and packed as TRAIN_CU), Ulysses
# with row 25 and the fused Ulysses projections run at 4 x 1024. 5g's fourth
# workload trains the attention block through ag_attention_fn at S_local
# 384.
SP_AG_TOKENS, SP_RING_TOKENS = 384, 1024
#: The sequence-parallel kernel (row 27).
SP_KERNELS = ("ag_attn_kernel",)
SGD_STEP = 0.01
FP32_KERNEL_TOL = 1e-4  # fp32 SIMT kernels vs fp32 plain versions, another summation order
#: The training kernels (rows 4, 5 and 6).
TRAIN_KERNELS = ("flash_attention_varlen", "flash_attention_bwd", "flash_attention_varlen_bwd")
# Item E, the int8/fp8 format: the quantized paged pool's wires (fp8 first:
# its numbers go into the kernels line), row 3b's walk, and rows 16q-19q
# (the collective matmuls with a quantized A). The first decode step's
# logits through a quantized pool stay within a sanity band of the bf16
# pool's: max |diff| at most QUANT_LOGIT_BAND[wire] of max |logit| (the
# format's per-element bound is 2^-4 of a row's absmax for fp8, 2^-7 for
# int8; random weights at full depth carry it unevenly, so the band is a
# bound on breakage, not on accuracy).
QUANT_WIRES = ("fp8", "int8")
QUANT_KERNELS = ("ag_gemm_fused_quant", "gemm_rs_fused_quant", "gemm_ar_fused_quant", "gemm_ar_ll_quant")
QUANT_LOGIT_BAND = {"fp8": 0.5, "int8": 0.25}


def log(msg: str) -> None:
    # One write per line: phase 5's four rank processes share the stream.
    sys.stdout.write(msg + "\n")
    sys.stdout.flush()


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


def close_scaled(got, want, tol) -> float:
    """``close`` on both tensors divided by max|want|: for gradients of a
    mean, whose scale says nothing about the tolerance. Returns the scaled
    max |error|."""
    scale = max(want.float().abs().max().item(), 1e-30)
    return close(got.float() / scale, want.float() / scale, tol, tol)


_GEMM_WORDS = ("gemm", "xmma", "cutlass", "nvjet", "sm90_")


_MEGA_FAMILIES = (("qkv_partial", "fused_ln_qkv_rope"), ("qkv_epilogue", "fused_ln_qkv_rope"),
                  ("attn_back", "fused_attn_back"), ("oproj_partial", "fused_attn_back"),
                  ("mlp_tile", "fused_mlp_block"), ("mlp_reduce", "fused_mlp_block"),
                  ("norm_head", "fused_norm_head"), ("paged_decode_quant", "paged_flash_decode_quant"),
                  ("paged_decode", "paged_flash_decode"),
                  ("moe_tile", "fused_moe_block"), ("moe_reduce", "fused_moe_block"))
# The kernels of the multi-rank layer all take tdt::Shmem first.
_SHMEM_FAMILIES = (("ag_push", "ag_gemm_fused"), ("ag_gemm", "ag_gemm_fused"),
                   ("partial_kernel", "rows 17-19 partials"), ("reduce_kernel", "rows 17-19 reduce"),
                   ("gather_kernel", "gemm_ar_fused broadcast"), ("barrier_kernel", "barrier_all_on_device"),
                   ("a2a_push", "a2a push (rows 20, 22, 25, 26)"), ("a2a_recv", "all_to_all_kernel"),
                   ("ep_gate_up", "fused_ep_kernel gate/up"), ("ep_down", "fused_ep_kernel down"),
                   ("ep_combine", "fused_ep_kernel combine"), ("ring_ag_kernel", "ring_ag_call"),
                   ("fullmesh_ag_kernel", "full_mesh_ag_call"), ("ring_rs_kernel", "ring_rs_call"),
                   ("one_shot_ar_kernel", "one_shot_ar_call"), ("ag_kv_push", "ag_attn_kernel push"),
                   ("ag_attn_", "ag_attn_kernel"))


def _family(kernel_name: str) -> str:
    families = _SHMEM_FAMILIES if "Shmem" in kernel_name else _MEGA_FAMILIES
    for word, family in families:
        if word in kernel_name:
            return family
    if "flash_fwd" in kernel_name:
        return "flash_attention"
    if "flash_bwd" in kernel_name:
        return "flash_attention_bwd"
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


def check_quant_paged_kernel(dev, flush_buf) -> dict[str, dict]:
    """Phase 2, item E (bf16): row 3b, the walk of an fp8 or int8 pool, at
    row 3's shapes (both models' Hkv, B = 4, bs = 16, a shuffled table;
    lengths 1/777/1500/2047, then 0/bs-1/bs/S) against its plain version
    and bitwise against row 3 on the pool dequantized to bf16; timed beside
    row 3 on that pool, its bound and gather + dequantize + SDPA."""
    import torch
    import torch.nn.functional as F

    from triton_dist_tpu_torch.kernels.flash_decode import (
        gather_paged_kv,
        paged_decode_cost,
        paged_decode_quant_reference,
        paged_flash_decode,
        paged_flash_decode_quant,
    )
    from triton_dist_tpu_torch.models import PRESETS
    from triton_dist_tpu_torch.models.quant import dequantize_kv, quantize_kv_rows

    cfg8b, cfg_moe = PRESETS["qwen3-8b"], PRESETS["qwen3-moe-30b-a3b"]
    hq, d = cfg8b.num_q_heads, cfg8b.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    bf16 = torch.bfloat16
    entries, err_max = {}, 0.0
    for label, hkv in (("qwen3-8b", cfg8b.num_kv_heads), ("qwen3-moe-30b-a3b", cfg_moe.num_kv_heads)):
        for lengths in (MEGA_LENGTHS, (0, PAGED_BS - 1, PAGED_BS, MAX_LEN)):
            q, kp, vp, tables, lens = _shuffled_pool(gen, lengths, hq, hkv, d, dev)
            for wire in QUANT_WIRES:
                (kq, ks), (vq, vs) = quantize_kv_rows(kp, wire), quantize_kv_rows(vp, wire)
                kd, vd = dequantize_kv(kq, ks, bf16), dequantize_kv(vq, vs, bf16)
                kw = dict(k_scale=ks, v_scale=vs)
                got_o, got_lse = paged_flash_decode_quant(q, kq, vq, tables, lens, return_lse=True, **kw)
                want_o, want_lse = paged_decode_quant_reference(q, kq, vq, tables, lens, return_lse=True, **kw)
                ref_o, ref_lse = paged_flash_decode(q, kd, vd, tables, lens, return_lse=True)
                torch.cuda.synchronize()
                err = close(got_o, want_o, BF16_ATOL, BF16_RTOL)
                lse_err = close(got_lse, want_lse, LSE_ATOL, 0.0)
                if not (torch.equal(got_o, ref_o) and torch.equal(got_lse, ref_lse)):
                    raise AssertionError(f"paged_flash_decode_quant {label} {wire} lengths {lengths}: not bitwise "
                                         "equal to paged_flash_decode on the pool dequantized to bf16")
                err_max = max(err_max, err)
                log(f"paged_flash_decode_quant {label} {wire} B={len(lengths)} lengths {list(lengths)}: max|o err| "
                    f"{err:.3e}, max|lse err| {lse_err:.3e}; bitwise equal to row 3 on the dequantized pool")
                if lengths != MEGA_LENGTHS:
                    continue
                mask = (torch.arange(MAX_LEN, device=dev)[None, :] < lens[:, None])[:, None, None, :]

                def library(kq=kq, ks=ks, vq=vq, vs=vs, mask=mask):
                    kc = dequantize_kv(gather_paged_kv(kq, tables), gather_paged_kv(ks, tables), bf16)
                    vc = dequantize_kv(gather_paged_kv(vq, tables), gather_paged_kv(vs, tables), bf16)
                    return F.scaled_dot_product_attention(q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True)

                row3_ms = time_ms(lambda: paged_flash_decode(q, kd, vd, tables, lens), flush_buf)
                kernel_ms = time_ms(lambda: paged_flash_decode_quant(q, kq, vq, tables, lens, **kw), flush_buf)
                plain_ms = time_ms(lambda: paged_decode_quant_reference(q, kq, vq, tables, lens, **kw), flush_buf,
                                   iters=5)
                lib_ms = time_ms(library, flush_buf)
                flops, nbytes = paged_decode_cost(q, kq, tables, lens, quantized=True)
                b_ms, b_by = bound_ms(flops, nbytes)
                row3_bound = bound_ms(*paged_decode_cost(q, kd, tables, lens))[0]
                log(f"paged_flash_decode_quant {label} {wire} B={len(lengths)} Hq={hq} Hkv={hkv} D={d}: kernel_ms "
                    f"{kernel_ms}, row 3 on the bf16 pool {row3_ms}, plain_ms {plain_ms}, library_ms(gather + "
                    f"dequantize + SDPA) {lib_ms}, bound_ms {b_ms} ({b_by}; {nbytes} bytes; row 3's {row3_bound}, "
                    f"ratio {b_ms / row3_bound:.4f})")
                if label == "qwen3-8b" and wire == QUANT_WIRES[0]:
                    entries["paged_flash_decode_quant"] = dict(
                        name="paged_flash_decode_quant", route="cuda",
                        source="triton_dist_tpu_torch/csrc/flash_decode.cu",
                        replaces="triton_dist_tpu/kernels/flash_decode.py:275", ms=kernel_ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    entries["paged_flash_decode_quant"]["max_abs_err"] = err_max
    log(f"card after row 3b (clocks.sm, power.draw, temperature): {smi_sample()}")
    return entries


# ------------------------------- 2b. the training kernels vs plain versions

def _sgd_rates(params, sq_norms=None) -> list[float]:
    """SGD's rate for each tensor, set once from the first step's gradient
    so that the step moves the tensor by ``SGD_STEP`` of its norm.
    ``sq_norms`` maps the per-tensor (|w|², |g|²) to their global values (a
    sum over the ranks for a sharded tensor)."""
    import torch

    sq = torch.stack([torch.stack([p.detach().float().pow(2).sum(), p.grad.float().pow(2).sum()]) for p in params])
    if sq_norms is not None:
        sq = sq_norms(sq)
    return [SGD_STEP * math.sqrt(w / g) for w, g in sq.tolist()]


def _sgd(params, rates) -> None:
    import torch

    with torch.no_grad():
        for p, lr in zip(params, rates):
            p.sub_((lr * p.grad.float()).to(p.dtype))
            p.grad = None


def _check_grads(got, want, atol, rtol) -> float:
    return max(close(g, w, atol, rtol) for g, w in zip(got, want))


def check_training_kernels(dev, flush_buf) -> dict[str, dict]:
    """Phase 2, the training path: rows 4, 5 and 6 against their plain
    versions at the shapes of phase 6 (Qwen3-8B's attention, bf16, S 4096;
    the packed batch of ``TRAIN_CU``) and at the edges (Sq < Sk, a nonzero
    LSE cotangent, a ring step that sees no key, D 64 and 32, fp32), each
    timed beside its bound, its plain version and the yardstick: SDPA
    forward and backward through autograd (rows 1 + 5) and SDPA with an
    explicit block-diagonal causal mask (rows 4 + 6); the port calls
    neither."""
    import torch
    import torch.nn.functional as F

    from triton_dist_tpu_torch.kernels import (
        attention_bwd_reference,
        flash_attention,
        flash_attention_bwd,
        flash_attention_varlen,
        flash_attention_varlen_bwd,
        varlen_bwd_reference,
        varlen_reference,
    )
    from triton_dist_tpu_torch.kernels.flash_attn import (
        NEG_INF,
        _varlen_mask,
        attention_bwd_bytes,
        attention_bwd_flops,
        attention_bytes,
        attention_flops,
        varlen_flops,
    )
    from triton_dist_tpu_torch.models import PRESETS

    cfg = PRESETS["qwen3-8b"]
    hq, hkv, d, s = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim, TRAIN_S
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def tols(dtype):
        return (BF16_ATOL, BF16_RTOL) if dtype == torch.bfloat16 else (FP32_KERNEL_TOL, FP32_KERNEL_TOL)

    entries, errs = {}, {name: 0.0 for name in ("flash_attention_varlen", "flash_attention_bwd",
                                                "flash_attention_varlen_bwd")}

    # Rows 1 + 5 at the served shape.
    q, k, v, do = randn(1, hq, s, d), randn(1, hkv, s, d), randn(1, hkv, s, d), randn(1, hq, s, d)
    o, lse = flash_attention(q, k, v, return_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    want = attention_bwd_reference(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    errs["flash_attention_bwd"] = _check_grads(got, want, BF16_ATOL, BF16_RTOL)
    del got, want
    fwd_ms = time_ms(lambda: flash_attention(q, k, v, return_lse=True), flush_buf)
    kernel_ms = time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do), flush_buf)
    plain_ms = time_ms(lambda: attention_bwd_reference(q, k, v, o, lse, do), flush_buf, iters=3, warmup=1)
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True, enable_gqa=True)
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(out, (qr, kr, vr), do, retain_graph=True), flush_buf)
    lib_ms = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qr, kr, vr, is_causal=True, enable_gqa=True), (qr, kr, vr), do), flush_buf)
    del out
    fwd_flops = attention_flops(1, hq, s, s, d, causal=True)
    b_ms, b_by = bound_ms(attention_bwd_flops(fwd_flops), attention_bwd_bytes(q, k, v))
    fb_ms, _ = bound_ms(fwd_flops, attention_bytes(q, k, v, return_lse=True))
    log(f"flash_attention_bwd causal B=1 Hq={hq} Hkv={hkv} S={s} D={d} bf16: max|grad err| "
        f"{errs['flash_attention_bwd']:.3e}; kernel_ms {kernel_ms}, plain_ms {plain_ms}, library_ms(SDPA backward "
        f"through autograd) {lib_bwd_ms}, bound_ms {b_ms} ({b_by}); rows 1 + 5 kernel_ms {fwd_ms + kernel_ms} "
        f"(forward {fwd_ms}, bound {fb_ms}) vs SDPA forward + backward {lib_ms}")
    entries["flash_attention_bwd"] = dict(
        name="flash_attention_bwd", route="cuda", source="triton_dist_tpu_torch/csrc/flash_attn_bwd.cu",
        replaces="triton_dist_tpu/kernels/flash_attn.py:559", ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_bwd_ms)
    del q, k, v, do, o, lse, qr, kr, vr

    # Rows 4 + 6 at the packed batch.
    cu = list(TRAIN_CU)
    q, k, v, do = randn(hq, s, d), randn(hkv, s, d), randn(hkv, s, d), randn(hq, s, d)
    dlse = torch.randn((hq, s), generator=gen, device=dev)
    o, lse = flash_attention_varlen(q, k, v, cu, return_lse=True)
    want_o, want_lse = varlen_reference(q, k, v, cu, return_lse=True)
    torch.cuda.synchronize()
    empty = want_lse == NEG_INF
    if not (torch.equal(lse[empty], want_lse[empty]) and not bool(o[empty].any())):
        raise AssertionError("flash_attention_varlen: padding rows are not o = 0, lse = NEG_INF")
    errs["flash_attention_varlen"] = close(o, want_o, BF16_ATOL, BF16_RTOL)
    close(lse[~empty], want_lse[~empty], LSE_ATOL, 0.0)
    got = flash_attention_varlen_bwd(q, k, v, o, lse, do, cu, dlse=dlse)
    want = varlen_bwd_reference(q, k, v, o, lse, do, cu, dlse=dlse)
    torch.cuda.synchronize()
    errs["flash_attention_varlen_bwd"] = _check_grads(got, want, BF16_ATOL, BF16_RTOL)
    del got, want, want_o, want_lse
    mask = _varlen_mask(cu, s, None, None, dev) | torch.eye(s, dtype=torch.bool, device=dev)  # no empty rows
    qb, kb, vb = q[None], k[None], v[None]
    v_ms = {}
    v_ms["fwd"] = time_ms(lambda: flash_attention_varlen(q, k, v, cu, return_lse=True), flush_buf)
    v_ms["fwd_plain"] = time_ms(lambda: varlen_reference(q, k, v, cu, return_lse=True), flush_buf, iters=3,
                                warmup=1)
    v_ms["fwd_lib"] = time_ms(lambda: F.scaled_dot_product_attention(qb, kb, vb, attn_mask=mask, enable_gqa=True),
                              flush_buf)
    v_ms["bwd"] = time_ms(lambda: flash_attention_varlen_bwd(q, k, v, o, lse, do, cu, dlse=dlse), flush_buf)
    v_ms["bwd_plain"] = time_ms(lambda: varlen_bwd_reference(q, k, v, o, lse, do, cu, dlse=dlse), flush_buf,
                                iters=3, warmup=1)
    qr, kr, vr = (t.detach().requires_grad_() for t in (qb, kb, vb))
    out = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask, enable_gqa=True)
    v_ms["bwd_lib"] = time_ms(lambda: torch.autograd.grad(out, (qr, kr, vr), do[None], retain_graph=True), flush_buf)
    del out, qr, kr, vr, mask
    vf = varlen_flops(cu, s, hq, d)
    fb_ms, fb_by = bound_ms(vf, attention_bytes(qb, kb, vb, return_lse=True))
    bb_ms, bb_by = bound_ms(attention_bwd_flops(vf), attention_bwd_bytes(q, k, v))
    log(f"flash_attention_varlen Hq={hq} Hkv={hkv} T={s} cu_seqlens {cu} D={d} bf16: max|o err| "
        f"{errs['flash_attention_varlen']:.3e}; kernel_ms {v_ms['fwd']}, plain_ms {v_ms['fwd_plain']}, "
        f"library_ms(SDPA, block-diagonal causal mask) {v_ms['fwd_lib']}, bound_ms {fb_ms} ({fb_by}; {vf} FLOP)")
    log(f"flash_attention_varlen_bwd same shapes, nonzero dlse: max|grad err| "
        f"{errs['flash_attention_varlen_bwd']:.3e}; kernel_ms {v_ms['bwd']}, plain_ms {v_ms['bwd_plain']}, "
        f"library_ms(SDPA backward, same mask) {v_ms['bwd_lib']}, bound_ms {bb_ms} ({bb_by})")
    entries["flash_attention_varlen"] = dict(
        name="flash_attention_varlen", route="cuda", source="triton_dist_tpu_torch/csrc/flash_attn.cu",
        replaces="triton_dist_tpu/kernels/flash_attn.py:333", ms=v_ms["fwd"], plain_ms=v_ms["fwd_plain"],
        bound_ms=fb_ms, bound_by=fb_by, library_ms=v_ms["fwd_lib"])
    entries["flash_attention_varlen_bwd"] = dict(
        name="flash_attention_varlen_bwd", route="cuda", source="triton_dist_tpu_torch/csrc/flash_attn_bwd.cu",
        replaces="triton_dist_tpu/kernels/flash_attn.py:905", ms=v_ms["bwd"], plain_ms=v_ms["bwd_plain"],
        bound_ms=bb_ms, bound_by=bb_by, library_ms=v_ms["bwd_lib"])
    del q, k, v, do, o, lse, dlse

    # Edges: (label, dtype, hq, hkv, sq, sk, d, offsets, dlse) for rows 1 + 5.
    for label, dtype, eq, ekv, sq, sk, ed, offs, with_dlse in (
            ("Sq<Sk end-aligned", torch.bfloat16, hq, hkv, 512, 1024, d, {}, False),
            ("ring step, dlse", torch.bfloat16, hq, hkv, 1024, 1024, d, dict(q_offset=2048, kv_offset=1024), True),
            ("ring step that sees no key", torch.bfloat16, hq, hkv, 1024, 1024, d,
             dict(q_offset=0, kv_offset=1024), True),
            ("D 64", torch.bfloat16, 16, 4, 1000, 1000, 64, {}, True),
            ("D 32", torch.bfloat16, 16, 2, 777, 777, 32, {}, False),
            ("fp32", torch.float32, 8, 2, 300, 300, d, dict(q_offset=40, kv_offset=0), True)):
        q, k, v = randn(1, eq, sq, ed, dtype=dtype), randn(1, ekv, sk, ed, dtype=dtype), randn(1, ekv, sk, ed, dtype=dtype)
        do = randn(1, eq, sq, ed, dtype=dtype)
        dlse = torch.randn((1, eq, sq), generator=gen, device=dev) if with_dlse else None
        o, lse = flash_attention(q, k, v, return_lse=True, **offs)
        got = flash_attention_bwd(q, k, v, o, lse, do, dlse=dlse, **offs)
        want = attention_bwd_reference(q, k, v, o, lse, do, dlse=dlse, **offs)
        torch.cuda.synchronize()
        err = _check_grads(got, want, *tols(dtype))
        if "no key" in label and any(bool(g.any()) for g in got):
            raise AssertionError("flash_attention_bwd: a step that sees no key has nonzero gradients")
        if dtype == torch.bfloat16:
            errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], err)
        log(f"flash_attention_bwd edge {label} (Hq={eq} Hkv={ekv} Sq={sq} Sk={sk} D={ed} {offs}): "
            f"max|grad err| {err:.3e}")
    # Edges of rows 4 + 6: (label, dtype, hq, hkv, t, d, global cu_seqlens, offsets)
    for label, dtype, eq, ekv, t, ed, ecu, offs in (
            ("ring step, D 64", torch.bfloat16, 16, 4, 1024, 64, [0, 300, 1200, 1900],
             dict(q_offset=1024, kv_offset=512)),
            ("ring step that sees no key", torch.bfloat16, 16, 4, 1024, 64, [0, 300, 1200, 1900],
             dict(q_offset=0, kv_offset=1024)),
            ("D 32, padding", torch.bfloat16, 16, 2, 1000, 32, [0, 1, 400, 990], {}),
            ("fp32", torch.float32, 8, 2, 300, d, [0, 100, 101, 290], {})):
        q, k, v = randn(eq, t, ed, dtype=dtype), randn(ekv, t, ed, dtype=dtype), randn(ekv, t, ed, dtype=dtype)
        do = randn(eq, t, ed, dtype=dtype)
        dlse = torch.randn((eq, t), generator=gen, device=dev)
        o, lse = flash_attention_varlen(q, k, v, ecu, return_lse=True, **offs)
        want_o = varlen_reference(q, k, v, ecu, **offs)
        got = flash_attention_varlen_bwd(q, k, v, o, lse, do, ecu, dlse=dlse, **offs)
        want = varlen_bwd_reference(q, k, v, o, lse, do, ecu, dlse=dlse, **offs)
        torch.cuda.synchronize()
        err_o = close(o, want_o, *tols(dtype))
        err = _check_grads(got, want, *tols(dtype))
        if "no key" in label and any(bool(g.any()) for g in got):
            raise AssertionError("flash_attention_varlen_bwd: a step that sees no key has nonzero gradients")
        if dtype == torch.bfloat16:
            errs["flash_attention_varlen"] = max(errs["flash_attention_varlen"], err_o)
            errs["flash_attention_varlen_bwd"] = max(errs["flash_attention_varlen_bwd"], err)
        log(f"flash_attention_varlen(+_bwd) edge {label} (Hq={eq} Hkv={ekv} T={t} D={ed} cu {ecu} {offs}): "
            f"max|o err| {err_o:.3e}, max|grad err| {err:.3e}")
    for name, err in errs.items():
        entries[name]["max_abs_err"] = err
    log(f"card during phase 2 training kernels (clocks.sm, power.draw, temperature): {smi_sample()}")
    return entries


# ------------------------------------- 3. parity: CUDA vs CPU, small fp32

def parity_fp32(dev) -> None:
    """Phase 3: a small dense model and ``test-moe``, fp32, served on the
    card and on the CPU: greedy tokens equal, logits and KV close."""
    import torch

    from triton_dist_tpu_torch.models import PRESETS, DenseLLM, DenseParams, Engine, ModelConfig, Qwen3MoE, init_params
    from triton_dist_tpu_torch.models.quant import ERROR_BOUND as QUANT_ERROR_BOUND
    from triton_dist_tpu_torch.models.quant import dequantize_kv

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
    # slot 1 free, staggered prompts, chunked prefill; then the same through
    # fp8 and int8 pools (item E: row 3b on mega, the gather bounce on
    # dist), with one more step's logits on mega.
    paged_runs = [("test-moe", Qwen3MoE, "mega", None), ("test-dense", DenseLLM, "mega", None),
                  ("test-dense", DenseLLM, "dist", None)]
    paged_runs += [(preset, cls, backend, wire) for wire in QUANT_WIRES for preset, cls, backend, _ in paged_runs]
    for preset, cls, backend, wire in paged_runs:
        cfg = PRESETS[preset]
        p_cpu = init_params(cfg, torch.Generator().manual_seed(SEED + 6), "cpu")
        prompts = [torch.randint(0, cfg.vocab_size, (1, n), generator=torch.Generator().manual_seed(SEED + n))
                   for n in (21, 0, 9)]
        prompts[1] = None
        runs = []
        for model in (cls(cfg, p_cpu, device="cpu"), cls(cfg, on_card(p_cpu), device=dev)):
            engine = Engine(model, backend=backend, max_len=64)
            paged, tokens, _, logits = paged_prefill(engine, prompts, 7, block_size=8, chunk=8, quant=wire)
            out, last, paged, _ = engine.decode_steps_paged(paged, tokens, torch.tensor([6, 0, 4]), 6)
            if backend == "mega":
                step, _, _ = model.decode_mega_paged(engine._mega_paged_step, engine._mega_layers, last,
                                                     *paged.pool_pair(), paged.tables, paged.lengths,
                                                     paged.lengths > 0)
                logits = [*logits, step[::2]]
            pool = paged.k[:, 1:] if wire is None else dequantize_kv(paged.k, paged.k_scale)[:, 1:]
            runs.append((out.cpu(), paged.lengths.cpu().tolist(), [lg.cpu() for lg in logits], pool.cpu()))
        (o_cpu, n_cpu, lg_cpu, k_cpu), (o_gpu, n_gpu, lg_gpu, k_gpu) = runs
        tag = f"{preset} {backend} paged{'' if wire is None else ', ' + wire + ' pool'}"
        if not torch.equal(o_gpu, o_cpu) or not n_gpu == n_cpu == [21 + 6, 0, 9 + 4]:
            raise AssertionError(f"{tag} decode differs:\ncuda {o_gpu.tolist()} {n_gpu}\n"
                                 f"cpu  {o_cpu.tolist()} {n_cpu}")
        err_logits = max(close(g, c, FP32_LOGITS_TOL, FP32_LOGITS_TOL) for g, c in zip(lg_gpu, lg_cpu))
        # A quantized row holds the format's rounding of its fp32 value: one
        # step of the grid apart where the card's and the CPU's fp32 values
        # sit on either side of a rounding edge, so the pool is compared at
        # the format's bound.
        kv_tol = FP32_LOGITS_TOL if wire is None else QUANT_ERROR_BOUND[wire] * k_cpu.abs().max().item()
        err_kv = close(k_gpu, k_cpu, kv_tol, FP32_LOGITS_TOL)
        log(f"parity fp32 {tag} (bs 8, prompts 21/-/9 in chunks of 8, 6 steps): prefill "
            f"{'and next-step ' if backend == 'mega' else ''}logits max|err| {err_logits:.3e} (tol "
            f"{FP32_LOGITS_TOL}), pool max|err| {err_kv:.3e} (tol {kv_tol:.3e}); tokens equal, slot 1 free")


def parity_grads_fp32(dev) -> None:
    """Phase 3, the training path: every attention function's output and
    gradients (fp32, small) on the card and on the CPU, and one
    ``test-dense`` attention-block SGD step, dense and packed: within
    ``FP32_LOGITS_TOL`` (the step's gradients of a mean, of their largest)."""
    import torch

    from triton_dist_tpu_torch import function as fn
    from triton_dist_tpu_torch.function.training import attention_block_loss
    from triton_dist_tpu_torch.kernels.flash_attn import NEG_INF
    from triton_dist_tpu_torch.models import PRESETS, init_params

    gen = torch.Generator().manual_seed(SEED + 30)

    def randn(*shape):
        return torch.randn(shape, generator=gen)

    def grads_on(device, f, args, cots):
        leaves = [a.detach().clone().to(device).requires_grad_() for a in args]
        outs = f(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        loss = sum((torch.where(o > NEG_INF, o, 0.0) * c.to(device)).sum() for o, c in zip(outs, cots))
        loss.backward()
        return [o.detach().cpu() for o in outs] + [t.grad.cpu() for t in leaves]

    cu, cu_ring = [0, 30, 64, 90], [0, 40, 150, 256]
    q, k, v, c, cl = randn(1, 8, 96, 64), randn(1, 2, 128, 64), randn(1, 2, 128, 64), randn(1, 8, 96, 64), randn(1, 8, 96)
    qs, ks, vs = q[:, :, :64], k[:, :, :64], v[:, :, :64]
    cases = (
        ("flash_attention_fn (Sq < Sk)", lambda *a: fn.flash_attention_fn(*a, True), (q, k, v), (c,)),
        ("flash_attention_lse_fn (ring step, dlse)", lambda *a: fn.flash_attention_lse_fn(*a, 128, 64, True),
         (qs, ks, vs), (c[:, :, :64], cl[:, :, :64])),
        ("flash_attention_varlen_fn", lambda *a: fn.flash_attention_varlen_fn(*a, cu), (q[0], k[0, :, :96], v[0, :, :96]),
         (c[0],)),
        ("flash_attention_varlen_lse_fn (ring step, dlse)",
         lambda *a: fn.flash_attention_varlen_lse_fn(*a, cu_ring, 128, 64), (qs[0], ks[0], vs[0]),
         (c[0, :, :64], cl[0, :, :64])),
    )
    for label, f, args, cots in cases:
        err = max(close(g, w, FP32_LOGITS_TOL, FP32_LOGITS_TOL)
                  for g, w in zip(grads_on(dev, f, args, cots), grads_on("cpu", f, args, cots)))
        log(f"parity fp32 {label}: outputs and gradients max|err| {err:.3e} (tol {FP32_LOGITS_TOL})")

    cfg = PRESETS["test-dense"]
    p = init_params(cfg, torch.Generator().manual_seed(SEED + 31), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 64), generator=gen)
    for label, packed in (("dense", None), ("packed", [0, 20, 41, 60])):
        runs = []
        for device in ("cpu", dev):
            leaves = [t.to(device).clone().requires_grad_() for t in (p.wqkv[0], p.wo[0])]
            loss_fn = lambda wqkv, wo: attention_block_loss(p.embed.to(device), p.ln1[0].to(device), wqkv, wo,
                                                            tokens.to(device), cfg, cu_seqlens=packed)
            loss = loss_fn(*leaves)
            loss.backward()
            rates = _sgd_rates(leaves)
            grads = [t.grad.cpu() for t in leaves]
            _sgd(leaves, rates)
            with torch.no_grad():
                runs.append((float(loss), grads, float(loss_fn(*leaves))))
        (l_cpu, g_cpu, l2_cpu), (l_gpu, g_gpu, l2_gpu) = runs
        err = max(close_scaled(a, b, FP32_LOGITS_TOL) for a, b in zip(g_gpu, g_cpu))
        if abs(l_gpu - l_cpu) > FP32_LOGITS_TOL or abs(l2_gpu - l2_cpu) > FP32_LOGITS_TOL or not l2_gpu < l_gpu:
            raise AssertionError(f"test-dense {label} step: losses cuda {l_gpu} -> {l2_gpu}, cpu {l_cpu} -> {l2_cpu}")
        log(f"parity fp32 test-dense attention-block SGD step ({label}, 64 tokens): wqkv and wo gradients max|err| "
            f"{err:.3e} of max|grad|; loss {l_gpu:.6f} -> {l2_gpu:.6f} (cpu {l_cpu:.6f} -> {l2_cpu:.6f})")


# ----------------------------------------------- 4. full-width serving

def paged_prefill(engine, prompts, steps: int, *, block_size: int, chunk: int, quant: str | None = None):
    """Join ``prompts`` ((1, P) id tensors; None leaves a slot free) into a
    fresh pool of ``engine`` (quantized when ``quant`` is set; the same
    block count either way): each slot's chain comes from a
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
    paged = engine.alloc_paged(b, block_size=block_size, num_blocks=1 + b * mb, quant=quant)
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


def expected_paged_launches(cfg, chunks: int, steps: int, quant: str | None = None) -> dict[str, int]:
    """A paged mega run: one flash_attention per layer per prefill chunk
    (and, for a MoE model, one group_gemm_swiglu: chunks route through
    TP_MoE), and per decode step one fused_ln_qkv_rope, paged_flash_decode
    (paged_flash_decode_quant, row 3b, through a quantized pool) and
    fused_moe_block / fused_mlp_block per layer, one fused_norm_head."""
    layers = cfg.num_layers
    want = {name: 0 for name in expected_launches(cfg, "mega", 0, 0)}
    want.update(flash_attention=layers * chunks, fused_ln_qkv_rope=layers * steps, fused_norm_head=steps)
    want["paged_flash_decode" if quant is None else "paged_flash_decode_quant"] = layers * steps
    if cfg.is_moe:
        want.update(group_gemm_swiglu=layers * chunks, fused_moe_block=layers * steps)
    else:
        want["fused_mlp_block"] = layers * steps
    return want


def serve_paged_full_width(model, preset: str, dev, quant: str | None = None):
    """The four requests of ``serve_full_width`` on ``Engine(model,
    backend="mega")`` through a paged pool (quantized when ``quant`` is
    set, with the same block count): chains from a ``BlockAllocator``, each
    prompt through ``paged_kbuf_zeros``, ``prefill_chunk`` (chunks of
    ``PAGED_CHUNK``) and ``complete_paged_prefill``, then ``DECODE_STEPS``
    steps of ``decode_steps_paged``. The launch counts are read around
    exactly that run and must equal ``expected_paged_launches``. Returns
    the counts, the engine and the decoded tokens."""
    import torch

    from triton_dist_tpu_torch.kernels import launch_counts, reset_launch_counts
    from triton_dist_tpu_torch.models import Engine

    cfg = model.config
    tag = f"{preset} [mega, paged{'' if quant is None else ', ' + quant + ' pool'}]"
    torch.cuda.reset_peak_memory_stats()
    engine = Engine(model, backend="mega", max_len=MAX_LEN)
    tgen = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompts = [torch.randint(0, cfg.vocab_size, (1, n), generator=tgen, device=dev) for n in FLASH_PROMPTS]
    # Warm-up (library handles, the new kernels' first launches), uncounted.
    warm, tok, _, _ = paged_prefill(engine, [prompts[0][:, :32]], 2, block_size=PAGED_BS, chunk=PAGED_CHUNK,
                                    quant=quant)
    engine.decode_steps_paged(warm, tok, torch.tensor([2]), 2)
    del warm
    torch.cuda.synchronize()

    reset_launch_counts()
    paged, tokens0, ttft, _ = paged_prefill(engine, prompts, DECODE_STEPS, block_size=PAGED_BS,
                                            chunk=PAGED_CHUNK, quant=quant)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, last, paged, rem = engine.decode_steps_paged(paged, tokens0, torch.full((4,), DECODE_STEPS), DECODE_STEPS)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / DECODE_STEPS
    launches = launch_counts()

    chunks = sum(-(-n // min(PAGED_CHUNK, n)) for n in FLASH_PROMPTS)
    want = expected_paged_launches(cfg, chunks, DECODE_STEPS, quant)
    if launches != want:
        raise AssertionError(f"{tag}: launches on the served path {launches}, expected {want}")
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"{tag}: tokens outside the vocabulary: {out.tolist()}")
    want_len = [n + DECODE_STEPS for n in FLASH_PROMPTS]
    if paged.lengths.tolist() != want_len or rem.tolist() != [0] * 4:
        raise AssertionError(f"{tag}: slot lengths {paged.lengths.tolist()} != {want_len}")
    active = torch.ones(4, dtype=torch.bool, device=dev)
    step_logits, _, _ = model.decode_mega_paged(engine._mega_paged_step, engine._mega_layers, last,
                                                *paged.pool_pair(), paged.tables, paged.lengths, active)
    if not bool(torch.isfinite(step_logits).all()):
        raise AssertionError(f"{tag}: non-finite logits at full width")
    for n, t in zip(FLASH_PROMPTS, ttft):
        log(f"{tag} request prompt={n} ({-(-n // min(PAGED_CHUNK, n))} chunks): TTFT {t:.2f} ms")
    bf16_gib = 2 * cfg.num_layers * cfg.num_kv_heads * PAGED_BS * cfg.head_dim * 2 * paged.num_blocks / 2**30
    log(f"{tag} decode_steps_paged B=4 bs={PAGED_BS}, {DECODE_STEPS} steps: {decode_ms:.2f} ms/step "
        f"({4 * 1e3 / decode_ms:.1f} tokens/s); pool {paged.num_blocks} blocks, "
        f"{paged.bytes_per_block * paged.num_blocks / 2**30:.4f} GiB ({paged.bytes_per_block} bytes a block; "
        f"the bf16 pool of as many blocks: {bf16_gib:.4f} GiB)")
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
    return launches, engine, out


def compare_quant_pools(model, preset: str, dev, engine, streams: dict) -> None:
    """The first decode step of the four requests through a bf16 pool and
    through each quantized pool (fresh prefills, the same first tokens),
    held to ``QUANT_LOGIT_BAND``; and how many decoded tokens of each
    quantized run equal the bf16 pool's (``streams``, by wire; reported
    only: with random weights an argmax margin can sit inside the
    format's error)."""
    import torch

    tgen = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompts = [torch.randint(0, model.config.vocab_size, (1, n), generator=tgen, device=dev) for n in FLASH_PROMPTS]
    active = torch.ones(len(prompts), dtype=torch.bool, device=dev)
    logits = {}
    for wire in (None, *[w for w in QUANT_WIRES if w in streams]):
        paged, tokens, _, _ = paged_prefill(engine, prompts, 1, block_size=PAGED_BS, chunk=PAGED_CHUNK, quant=wire)
        logits[wire], _, _ = model.decode_mega_paged(engine._mega_paged_step, engine._mega_layers, tokens,
                                                     *paged.pool_pair(), paged.tables, paged.lengths, active)
        del paged
    scale = logits[None].abs().max().item()
    for wire, out in streams.items():
        if wire is None:
            continue
        diff = (logits[wire] - logits[None]).abs().max().item()
        same = (logits[wire].argmax(-1) == logits[None].argmax(-1)).tolist()
        equal = int((out == streams[None]).sum())
        log(f"{preset} first decode step, {wire} pool vs bf16 pool (mega, B=4): max |logit diff| {diff}, "
            f"max |logit| {scale} (band {QUANT_LOGIT_BAND[wire]} of it), greedy tokens equal {sum(same)}/{len(same)}; "
            f"over the {DECODE_STEPS}-step streams {equal}/{out.numel()} tokens equal the bf16 pool's")
        if not bool(torch.isfinite(logits[wire]).all()) or diff > QUANT_LOGIT_BAND[wire] * scale:
            raise AssertionError(f"{preset} {wire} pool: first-step logits outside the band ({diff} vs {scale})")


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
        "paged_flash_decode_quant": 0,
        "group_gemm_swiglu": layers * (prefills + (0 if mega else steps)) if cfg.is_moe else 0,
        "fused_ln_qkv_rope": layers * steps if mega else 0,
        "fused_attn_back": layers * steps if mega else 0,
        "fused_mlp_block": layers * steps if mega and not cfg.is_moe else 0,
        "fused_norm_head": steps if mega else 0,
        "fused_moe_block": layers * steps if mega and cfg.is_moe else 0,
        **{name: 0 for name in COLLECTIVE_KERNELS + EP_KERNELS + STANDALONE_KERNELS + QUANT_KERNELS},  # world 1
        **{name: 0 for name in TRAIN_KERNELS + SP_KERNELS},  # serving runs no training kernel, no SP
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


# ------------------------------------------ 5. world 4: four rank processes

def bound3_ms(flops: float, hbm_bytes: float, link_bytes: float) -> tuple[float, str]:
    """The least time of a collective call: the largest of its FLOPs at the
    bf16 peak, its HBM bytes at the HBM rate and its NVLink bytes at one
    direction's rate."""
    t_ops, t_hbm, t_link = flops / PEAK_BF16_FLOPS, hbm_bytes / PEAK_BYTES_PER_S, link_bytes / LINK_BYTES_PER_S
    return max(t_ops, t_hbm, t_link) * 1e3, ("operations" if t_ops >= max(t_hbm, t_link) else "bytes")


def time_collective(ctx, fn, flush_buf, iters: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times of a collective ``fn``, every rank
    calling it alike: L2 flushed, a 0.2 ms spin, then the device barrier, so
    all ranks start the timed call together; the events bracket the call."""
    import torch

    from triton_dist_tpu_torch.kernels import barrier_all_on_device

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush_buf.zero_()
        torch.cuda._sleep(400_000)
        barrier_all_on_device(ctx)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _same_on_every_rank(ctx, t) -> bool:
    import hashlib

    import torch
    import torch.distributed as dist

    digest = hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
    digests = [None] * ctx.world
    dist.all_gather_object(digests, digest, group=ctx.group)
    return len(set(digests)) == 1


def rlog(ctx, msg: str) -> None:
    log(f"[rank {ctx.rank}] {msg}")


def timed_entry(ctx, flush_buf, name, source, replaces, kernel, plain, library, cost,
                library_name="NCCL + cuBLAS") -> dict:
    """A collective kernel's JSON entry (without launches and error): the
    kernel, its plain version and the yardstick (None when the ranks share
    a card) timed by ``time_collective``, and the bound of ``cost`` (FLOPs,
    HBM bytes, NVLink bytes)."""
    kernel_ms = time_collective(ctx, kernel, flush_buf)
    plain_ms = time_collective(ctx, plain, flush_buf, iters=5)
    lib_ms = time_collective(ctx, library, flush_buf) if library is not None else None
    b_ms, b_by = bound3_ms(*cost)
    rlog(ctx, f"{name} timed: kernel_ms {kernel_ms}, plain_ms {plain_ms}, library_ms({library_name}) "
         f"{lib_ms}, bound_ms {b_ms} ({b_by}; {cost[0]} FLOP, {cost[1]} HBM bytes, {cost[2]} NVLink bytes)")
    return dict(name=name, route="cuda", source=source, replaces=replaces, ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def check_collective_kernels(ctx, flush_buf, nccl) -> dict[str, dict]:
    """5a: rows 16-19 and the barrier against their plain versions at the
    Qwen3-8B world-4 shapes of the main path and at the edges (bf16). Every
    rank draws every rank's inputs from one seed and computes the reference
    alone; the plain version (the plain collective plus the fp32 product) is
    timed beside the kernel. Rows 18 and 19 must give the same bits on every
    rank. ``nccl``: a separate NCCL group for the yardstick, or None (ranks
    share a card)."""
    import time as _time

    import torch
    import torch.distributed as dist

    from triton_dist_tpu_torch.kernels import (
        ag_gemm_fused,
        ag_gemm_reference,
        barrier_all_on_device,
        gemm_ar_fused,
        gemm_ar_ll,
        gemm_ar_reference,
        gemm_rs_fused,
        gemm_rs_reference,
    )
    from triton_dist_tpu_torch.kernels.allgather_gemm import ag_gemm_cost
    from triton_dist_tpu_torch.kernels.gemm_allreduce import gemm_ar_cost
    from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import gemm_rs_cost
    from triton_dist_tpu_torch.kernels.group_gemm import matmul_f32
    from triton_dist_tpu_torch.models import PRESETS

    c = PRESETS["qwen3-8b"]
    w, me, dev = ctx.world, ctx.rank, ctx.device
    d = c.hidden_size
    n_qkv = (c.num_q_heads + 2 * c.num_kv_heads) * c.head_dim // w
    ff_l, k_o = c.intermediate_size // w, c.num_q_heads * c.head_dim // w
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)  # the same draws on every rank

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    entries = {}

    def record(name, source, replaces, kernel, plain, library, cost):
        entries[name] = timed_entry(ctx, flush_buf, name, source, replaces, kernel, plain, library, cost)

    # Row 16: AG(A) @ B and the SwiGLU pair. (label, m_shard, n, swiglu, timed)
    err16 = 0.0
    for label, m, n, swiglu, timed in (("wqkv S=1500", 375, n_qkv, False, False),
                                       ("gate/up S=1500", 375, ff_l, True, True),
                                       ("edge m_shard=33", 33, n_qkv, False, False),
                                       ("edge m_shard=1", 1, ff_l, True, False)):
        a_all = randn(w * m, d)
        bs_all = [randn(d, w * n, scale=d ** -0.5) for _ in range(2 if swiglu else 1)]
        a = a_all[me * m:(me + 1) * m].contiguous()
        bs = tuple(b[:, me * n:(me + 1) * n].contiguous() for b in bs_all)
        got = ag_gemm_fused(ctx, a, bs)
        if swiglu:
            want = (torch.nn.functional.silu(matmul_f32(a_all, bs[0])) * matmul_f32(a_all, bs[1])).to(a.dtype)
        else:
            want = matmul_f32(a_all, bs[0]).to(a.dtype)
        plain = ag_gemm_reference(ctx, a, bs)
        torch.cuda.synchronize()
        err = close(got, want, BF16_ATOL, BF16_RTOL)
        close(plain, want, BF16_ATOL, BF16_RTOL)
        err16 = max(err16, err)
        rlog(ctx, f"ag_gemm_fused {label} (m_shard {m}, k {d}, n {n}, {'SwiGLU' if swiglu else 'plain'}): "
             f"max|err| {err:.3e}")
        if timed:
            def library(a=a, bs=bs):
                g = torch.empty((w * m, d), dtype=a.dtype, device=dev)
                dist.all_gather_into_tensor(g, a, group=nccl)
                return torch.mm(g, torch.cat(bs, dim=1))
            record("ag_gemm_fused", "triton_dist_tpu_torch/csrc/collective_gemm.cu",
                   "triton_dist_tpu/kernels/allgather_gemm.py:336",
                   lambda: ag_gemm_fused(ctx, a, bs), lambda: ag_gemm_reference(ctx, a, bs),
                   library if nccl is not None else None, ag_gemm_cost(m, d, n, w, len(bs), 2))
    entries["ag_gemm_fused"]["max_abs_err"] = err16

    def partials(m, k, n):
        a_all, b_all = randn(w, m, k), randn(w, k, n, scale=(w * k) ** -0.5)
        total = matmul_f32(a_all[0], b_all[0])
        for r in range(1, w):
            total += matmul_f32(a_all[r], b_all[r])  # rank order
        return a_all[me].contiguous(), b_all[me].contiguous(), total.to(torch.bfloat16)

    # Row 17: RS(A @ B) by rows.
    err17 = 0.0
    for label, m, k, timed in (("wo S=1500", 1500, k_o, False), ("down S=1500", 1500, ff_l, True),
                               ("edge m=4", 4, k_o, False)):
        a, b, total = partials(m, k, d)
        chunk = m // w
        got = gemm_rs_fused(ctx, a, b)
        plain = gemm_rs_reference(ctx, a, b)
        torch.cuda.synchronize()
        want = total[me * chunk:(me + 1) * chunk]
        err = close(got, want, BF16_ATOL, BF16_RTOL)
        close(plain, want, BF16_ATOL, BF16_RTOL)
        err17 = max(err17, err)
        rlog(ctx, f"gemm_rs_fused {label} (m {m}, k {k}, n {d}): max|err| {err:.3e}")
        if timed:
            def library(a=a, b=b, chunk=chunk):
                out = torch.empty((chunk, d), dtype=a.dtype, device=dev)
                dist.reduce_scatter_tensor(out, torch.mm(a, b), group=nccl)
                return out
            record("gemm_rs_fused", "triton_dist_tpu_torch/csrc/collective_gemm.cu",
                   "triton_dist_tpu/kernels/gemm_reduce_scatter.py:170",
                   lambda: gemm_rs_fused(ctx, a, b), lambda: gemm_rs_reference(ctx, a, b),
                   library if nccl is not None else None, gemm_rs_cost(m, k, d, w, 2))
    entries["gemm_rs_fused"]["max_abs_err"] = err17

    # Rows 18 and 19: AR(A @ B), the same bits on every rank.
    for name, fn, replaces, cases in (
            ("gemm_ar_fused", gemm_ar_fused, "triton_dist_tpu/kernels/gemm_allreduce.py:143",
             (("wo S=1500", 1500, k_o, False), ("down S=1500", 1500, ff_l, True), ("edge m=68", 68, ff_l, False),
              ("edge m=4", 4, k_o, False))),
            ("gemm_ar_ll", gemm_ar_ll, "triton_dist_tpu/kernels/gemm_allreduce.py:501",
             (("wo B=4", 4, k_o, False), ("down B=4", 4, ff_l, True), ("edge m=3", 3, ff_l, False),
              ("edge m=1", 1, k_o, False)))):
        err_max = 0.0
        for label, m, k, timed in cases:
            a, b, want = partials(m, k, d)
            got = fn(ctx, a, b)
            plain = gemm_ar_reference(ctx, a, b)
            torch.cuda.synchronize()
            err = close(got, want, BF16_ATOL, BF16_RTOL)
            close(plain, want, BF16_ATOL, BF16_RTOL)
            if not _same_on_every_rank(ctx, got):
                raise AssertionError(f"{name} {label}: the ranks' outputs differ")
            err_max = max(err_max, err)
            rlog(ctx, f"{name} {label} (m {m}, k {k}, n {d}): max|err| {err:.3e}; bitwise equal on every rank")
            if timed:
                def library(a=a, b=b):
                    p = torch.mm(a, b)
                    dist.all_reduce(p, group=nccl)
                    return p
                record(name, "triton_dist_tpu_torch/csrc/collective_gemm.cu", replaces,
                       lambda fn=fn, a=a, b=b: fn(ctx, a, b), lambda a=a, b=b: gemm_ar_reference(ctx, a, b),
                       library if nccl is not None else None,
                       gemm_ar_cost(m, k, d, w, 2, ll=name == "gemm_ar_ll"))
        entries[name]["max_abs_err"] = err_max

    # The barrier (row 24's first half): its plain version is the gloo barrier.
    before = barrier_all_on_device.launches
    barrier_all_on_device(ctx)
    torch.cuda.synchronize()
    if barrier_all_on_device.launches != before + 1:
        raise AssertionError("barrier_all_on_device did not count its launch")
    kernel_ms = time_collective(ctx, lambda: barrier_all_on_device(ctx), flush_buf)
    t0 = _time.perf_counter()
    for _ in range(20):
        ctx.host_barrier()
    plain_ms = (_time.perf_counter() - t0) * 1e3 / 20
    lib_ms = time_collective(ctx, lambda: dist.barrier(group=nccl), flush_buf) if nccl is not None else None
    b_ms, b_by = bound3_ms(0, 0, 8 * (w - 1))
    rlog(ctx, f"barrier_all_on_device: kernel_ms {kernel_ms}, plain_ms (gloo, host clock) {plain_ms}, "
         f"library_ms(NCCL barrier) {lib_ms}, bound_ms {b_ms} ({b_by})")
    entries["barrier_all_on_device"] = dict(
        name="barrier_all_on_device", route="cuda", source="triton_dist_tpu_torch/csrc/shmem.cu",
        replaces="triton_dist_tpu/kernels/common_ops.py:29", ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms, max_abs_err=0.0)
    ctx.check_status()
    return entries


def check_quant_collective_kernels(ctx, flush_buf, nccl) -> dict[str, dict]:
    """5a-q, item E: rows 16q-19q (a quantized A: fp8, then int8, bf16
    weights) at 5a's Qwen3-8B world-4 shapes against their plain versions,
    and bitwise against the bf16-operand kernels on the A dequantized into
    bf16 (their tiles dequantize exactly); rows 18q and 19q the same bits on
    every rank. Each timed case beside its bf16-operand form, its bound
    (the A read as 1-byte payload and a 4-byte scale a row) and, with a
    card a rank, NCCL + cuBLAS on the dequantized operand. The fp8 numbers
    go into the kernels line."""
    import torch
    import torch.distributed as dist

    from triton_dist_tpu_torch.kernels import allgather_gemm as ag
    from triton_dist_tpu_torch.kernels import gemm_allreduce as ar
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as rs
    from triton_dist_tpu_torch.models import PRESETS
    from triton_dist_tpu_torch.models.quant import dequantize_tensor, quantize_tensor

    c = PRESETS["qwen3-8b"]
    w, me, dev = ctx.world, ctx.rank, ctx.device
    d = c.hidden_size
    n_qkv = (c.num_q_heads + 2 * c.num_kv_heads) * c.head_dim // w
    ff_l, k_o = c.intermediate_size // w, c.num_q_heads * c.head_dim // w
    bf16 = torch.bfloat16
    entries, errs = {}, {name: 0.0 for name in QUANT_KERNELS}
    for wire in QUANT_WIRES:
        gen = torch.Generator(device=dev).manual_seed(SEED + 19)  # the same draws on every rank

        def randn(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf16)

        def quant(*shape):
            a = quantize_tensor(torch.randn(shape, generator=gen, device=dev)[me], wire)
            return a, dequantize_tensor(a, bf16)

        def record(name, source, replaces, kernel, plain, bf16_form, library, cost):
            bf16_ms = time_collective(ctx, bf16_form, flush_buf)
            e = timed_entry(ctx, flush_buf, name, source, replaces, kernel, plain, library, cost,
                            library_name="NCCL + cuBLAS on the dequantized A")
            rlog(ctx, f"{name} {wire}: the bf16-operand form on the dequantized A {bf16_ms} ms against the "
                      f"quant form's {e['ms']} ms")
            if wire == QUANT_WIRES[0]:
                entries[name] = e

        def bitwise(got, same_as, what):
            if not torch.equal(got.view(torch.uint8), same_as.view(torch.uint8)):
                raise AssertionError(f"{what}: not the bf16-operand kernel's bits on the dequantized A")

        src = "triton_dist_tpu_torch/csrc/collective_gemm.cu"
        # Row 16q. (label, m_shard, n, swiglu, timed)
        for label, m, n, swiglu, timed in (("wqkv S=1500", 375, n_qkv, False, False),
                                           ("gate/up S=1500", 375, ff_l, True, True),
                                           ("edge m_shard=33", 33, n_qkv, False, False),
                                           ("edge m_shard=1", 1, ff_l, True, False)):
            a, a_deq = quant(w, m, d)
            bs = tuple(randn(d, n, scale=d ** -0.5) for _ in range(2 if swiglu else 1))
            got = ag.ag_gemm_fused_quant(ctx, a, bs)
            plain = ag.ag_gemm_quant_reference(ctx, a, bs)
            same_as = ag.ag_gemm_fused(ctx, a_deq, bs)
            torch.cuda.synchronize()
            err = close(got, plain, BF16_ATOL, BF16_RTOL)
            bitwise(got, same_as, f"ag_gemm_fused_quant {wire} {label}")
            errs["ag_gemm_fused_quant"] = max(errs["ag_gemm_fused_quant"], err)
            rlog(ctx, f"ag_gemm_fused_quant {wire} {label} (m_shard {m}, k {d}, n {n}): max|err| {err:.3e}; "
                      "bitwise equal to the bf16-operand kernel on the dequantized A")
            if timed:
                def library(a_deq=a_deq, bs=bs, m=m):
                    g = torch.empty((w * m, d), dtype=bf16, device=dev)
                    dist.all_gather_into_tensor(g, a_deq, group=nccl)
                    return torch.mm(g, torch.cat(bs, dim=1))
                record("ag_gemm_fused_quant", src, "triton_dist_tpu/kernels/allgather_gemm.py:338",
                       lambda: ag.ag_gemm_fused_quant(ctx, a, bs), lambda: ag.ag_gemm_quant_reference(ctx, a, bs),
                       lambda: ag.ag_gemm_fused(ctx, a_deq, bs), library if nccl is not None else None,
                       ag.ag_gemm_cost(m, d, n, w, len(bs), 2, a_row_bytes=d + 4))

        # Row 17q: RS(A @ B) by rows.
        for label, m, k, timed in (("wo S=1500", 1500, k_o, False), ("down S=1500", 1500, ff_l, True),
                                   ("edge m=4", 4, k_o, False)):
            a, a_deq = quant(w, m, k)
            b = randn(w, k, d, scale=(w * k) ** -0.5)[me].contiguous()
            got = rs.gemm_rs_fused_quant(ctx, a, b)
            plain = rs.gemm_rs_quant_reference(ctx, a, b)
            same_as = rs.gemm_rs_fused(ctx, a_deq, b)
            torch.cuda.synchronize()
            err = close(got, plain, BF16_ATOL, BF16_RTOL)
            bitwise(got, same_as, f"gemm_rs_fused_quant {wire} {label}")
            errs["gemm_rs_fused_quant"] = max(errs["gemm_rs_fused_quant"], err)
            rlog(ctx, f"gemm_rs_fused_quant {wire} {label} (m {m}, k {k}, n {d}): max|err| {err:.3e}; bitwise "
                      "equal to the bf16-operand kernel on the dequantized A")
            if timed:
                def library(a_deq=a_deq, b=b, m=m):
                    out = torch.empty((m // w, d), dtype=bf16, device=dev)
                    dist.reduce_scatter_tensor(out, torch.mm(a_deq, b), group=nccl)
                    return out
                record("gemm_rs_fused_quant", src, "triton_dist_tpu/kernels/gemm_reduce_scatter.py:201",
                       lambda: rs.gemm_rs_fused_quant(ctx, a, b), lambda: rs.gemm_rs_quant_reference(ctx, a, b),
                       lambda: rs.gemm_rs_fused(ctx, a_deq, b), library if nccl is not None else None,
                       rs.gemm_rs_cost(m, k, d, w, 2, a_row_bytes=k + 4))

        # Rows 18q and 19q: AR(A @ B), the same bits on every rank.
        for name, fn, bf16_fn, replaces, cases in (
                ("gemm_ar_fused_quant", ar.gemm_ar_fused_quant, ar.gemm_ar_fused,
                 "triton_dist_tpu/kernels/gemm_allreduce.py:143",
                 (("wo S=1500", 1500, k_o, False), ("down S=1500", 1500, ff_l, True), ("edge m=68", 68, ff_l, False))),
                ("gemm_ar_ll_quant", ar.gemm_ar_ll_quant, ar.gemm_ar_ll, "triton_dist_tpu/kernels/gemm_allreduce.py:501",
                 (("wo B=4", 4, k_o, False), ("down B=4", 4, ff_l, True), ("edge m=3", 3, ff_l, False)))):
            for label, m, k, timed in cases:
                a, a_deq = quant(w, m, k)
                b = randn(w, k, d, scale=(w * k) ** -0.5)[me].contiguous()
                got = fn(ctx, a, b)
                plain = ar.gemm_ar_quant_reference(ctx, a, b)
                same_as = bf16_fn(ctx, a_deq, b)
                torch.cuda.synchronize()
                err = close(got, plain, BF16_ATOL, BF16_RTOL)
                bitwise(got, same_as, f"{name} {wire} {label}")
                if not _same_on_every_rank(ctx, got):
                    raise AssertionError(f"{name} {wire} {label}: the ranks' outputs differ")
                errs[name] = max(errs[name], err)
                rlog(ctx, f"{name} {wire} {label} (m {m}, k {k}, n {d}): max|err| {err:.3e}; bitwise equal to the "
                          "bf16-operand kernel on the dequantized A and on every rank")
                if timed:
                    def library(a_deq=a_deq, b=b):
                        p = torch.mm(a_deq, b)
                        dist.all_reduce(p, group=nccl)
                        return p
                    record(name, src, replaces, lambda fn=fn, a=a, b=b: fn(ctx, a, b),
                           lambda a=a, b=b: ar.gemm_ar_quant_reference(ctx, a, b),
                           lambda bf16_fn=bf16_fn, a_deq=a_deq, b=b: bf16_fn(ctx, a_deq, b),
                           library if nccl is not None else None,
                           ar.gemm_ar_cost(m, k, d, w, 2, ll=name == "gemm_ar_ll_quant", a_row_bytes=k + 4))
    for name, err in errs.items():
        entries[name]["max_abs_err"] = err
    ctx.check_status()
    return entries


def quant_host_ops(ctx) -> dict[str, int]:
    """5a-q as a path: the four collective matmuls driven once through
    their entry points with a quantized A (fp8) and AUTO at the Qwen3-8B
    world-4 prefill and decode shapes, the launch counts reset just before
    and read just after: ``ag_gemm_swiglu_shard`` and ``ag_gemm_shard`` at
    S = 1500 (rows 16q), ``gemm_rs_shard`` at S = 1500 (17q),
    ``gemm_ar_shard`` at S = 1500 (18q) and at B = 4 (19q). Returns the
    counts, held to AUTO's routes."""
    import torch

    from triton_dist_tpu_torch.kernels import KERNELS, launch_counts, reset_launch_counts
    from triton_dist_tpu_torch.kernels.allgather_gemm import ag_gemm_shard, ag_gemm_swiglu_shard
    from triton_dist_tpu_torch.kernels.gemm_allreduce import gemm_ar_shard
    from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import gemm_rs_shard
    from triton_dist_tpu_torch.models import PRESETS
    from triton_dist_tpu_torch.models.quant import quantize_tensor

    c = PRESETS["qwen3-8b"]
    w, dev = ctx.world, ctx.device
    d, ff_l = c.hidden_size, c.intermediate_size // w
    n_qkv = (c.num_q_heads + 2 * c.num_kv_heads) * c.head_dim // w
    gen = torch.Generator(device=dev).manual_seed(SEED + 20 + ctx.rank)

    def weight(k, n):
        return (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)

    x = quantize_tensor(torch.randn((375, d), generator=gen, device=dev), QUANT_WIRES[0])
    h = quantize_tensor(torch.randn((1500, ff_l), generator=gen, device=dev), QUANT_WIRES[0])
    h4 = quantize_tensor(torch.randn((4, ff_l), generator=gen, device=dev), QUANT_WIRES[0])
    wg, wu, wqkv, wd = weight(d, ff_l), weight(d, ff_l), weight(d, n_qkv), weight(ff_l, d)
    torch.cuda.synchronize()
    reset_launch_counts()
    outs = [ag_gemm_swiglu_shard(ctx, x, wg, wu), ag_gemm_shard(ctx, x, wqkv), gemm_rs_shard(ctx, h, wd),
            gemm_ar_shard(ctx, h, wd), gemm_ar_shard(ctx, h4, wd)]
    torch.cuda.synchronize()
    launches = launch_counts()
    want = {name: 0 for name in KERNELS}
    want.update(ag_gemm_fused_quant=2, gemm_rs_fused_quant=1, gemm_ar_fused_quant=1, gemm_ar_ll_quant=1)
    if launches != want:
        raise AssertionError(f"5a-q host ops: launches {launches}, expected {want}")
    shapes = [(1500, ff_l), (1500, n_qkv), (375, d), (1500, d), (4, d)]
    if [tuple(o.shape) for o in outs] != shapes or not all(o.dtype == torch.bfloat16 for o in outs):
        raise AssertionError(f"5a-q host ops: shapes {[tuple(o.shape) for o in outs]}, expected {shapes} bf16")
    if not all(bool(torch.isfinite(o.float()).all()) for o in outs):
        raise AssertionError("5a-q host ops: non-finite results")
    if not (_same_on_every_rank(ctx, outs[3]) and _same_on_every_rank(ctx, outs[4])):
        raise AssertionError("5a-q host ops: the all-reduced outputs differ between the ranks")
    ctx.check_status()
    rlog(ctx, f"5a-q host ops ({QUANT_WIRES[0]} A; ag_gemm_swiglu_shard, ag_gemm_shard, gemm_rs_shard, "
              f"gemm_ar_shard x2; AUTO): launches { {k: v for k, v in launches.items() if v} } as predicted")
    return launches


def check_standalone_collectives(ctx, flush_buf, nccl) -> dict[str, dict]:
    """5a': rows 20 (ring and full mesh), 21 and 22 against their plain
    versions, bitwise, at the messages of the served paths (row 22: one
    decode step's all-reduces at B = 4; a 1500-row fp32 message, which AUTO
    sends two-shot: row 21, then row 20's ring on its chunk) and at the
    edges (one row, a ragged lead, 12 bytes, bf16, a message over one
    workspace). The gathers and the all-reduces give the same bits on every
    rank. Each kernel is timed beside its plain version, its bound and, with
    a card a rank, NCCL's collective in the yardstick group."""
    import torch
    import torch.distributed as dist

    from triton_dist_tpu_torch.kernels import (
        all_gather_reference,
        full_mesh_ag_call,
        one_shot_ar_call,
        one_shot_ar_reference,
        ring_ag_call,
        ring_rs_call,
        ring_rs_reference,
    )
    from triton_dist_tpu_torch.kernels.allgather import all_gather_cost
    from triton_dist_tpu_torch.kernels.allreduce import AllReduceMethod, all_reduce_shard, one_shot_ar_cost
    from triton_dist_tpu_torch.kernels.reduce_scatter import reduce_scatter_cost

    w, me, dev = ctx.world, ctx.rank, ctx.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)  # the same draws on every rank
    source = "triton_dist_tpu_torch/csrc/collectives.cu"
    entries = {}

    def draw(shape, dtype=torch.float32):
        return torch.randn((w, *shape), generator=gen, device=dev).to(dtype)[me].contiguous()

    def nbytes(t):
        return t.numel() * t.element_size()

    def bitwise(name, label, got, want, replicated):
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
            raise AssertionError(f"{name} {label}: the kernel's bits differ from the plain version's")
        if replicated and not _same_on_every_rank(ctx, got):
            raise AssertionError(f"{name} {label}: the ranks' outputs differ")
        rlog(ctx, f"{name} {label}: bitwise equal to the plain version"
             + ("; the same bits on every rank" if replicated else ""))

    def record(name, replaces, kernel, plain, library, cost):
        e = timed_entry(ctx, flush_buf, name, source, replaces, kernel, plain, library if nccl is not None else None,
                        cost, library_name="NCCL")
        e["max_abs_err"] = 0.0  # bitwise
        entries[name] = e

    # Row 22: one decode step's messages at B = 4, then the edges.
    for label, shape, dtype, timed in (("attention partial, bf16 4 x 4096 (qwen3-8b mega)", (4, 4096),
                                        torch.bfloat16, True),
                                       ("MoE combine, fp32 4 x 2048 (qwen3-moe-30b-a3b)", (4, 2048), torch.float32,
                                        False),
                                       ("MLP partial, fp32 4 x 4096 (qwen3-8b mega)", (4, 4096), torch.float32, False),
                                       ("edge: one row, fp32 1 x 4096", (1, 4096), torch.float32, False),
                                       ("edge: 12 bytes", (3,), torch.float32, False),
                                       ("edge: fp32 4096 x 1024, 16 MiB, over one workspace", (4096, 1024),
                                        torch.float32, False)):
        x = draw(shape, dtype)
        bitwise("one_shot_ar_call", label, one_shot_ar_call(ctx, x), one_shot_ar_reference(ctx, x), True)
        if timed:
            y = x.clone()
            record("one_shot_ar_call", "triton_dist_tpu/kernels/allreduce.py:114", lambda x=x: one_shot_ar_call(ctx, x),
                   lambda x=x: one_shot_ar_reference(ctx, x), lambda y=y: dist.all_reduce(y, group=nccl),
                   one_shot_ar_cost(nbytes(x), w, x.element_size()))
    # AUTO's two-shot: row 21 on a 1500-row fp32 message, then row 20's ring
    # on the chunk; each timed at that message.
    x = draw((1500, 4096))
    chunk = ring_rs_call(ctx, x)
    bitwise("ring_rs_call", "fp32 1500 x 4096", chunk, ring_rs_reference(ctx, x), False)
    out = torch.empty_like(chunk)
    record("ring_rs_call", "triton_dist_tpu/kernels/reduce_scatter.py:54", lambda: ring_rs_call(ctx, x),
           lambda: ring_rs_reference(ctx, x), lambda: dist.reduce_scatter_tensor(out, x, group=nccl),
           reduce_scatter_cost(nbytes(x), w, 4))
    bitwise("ring_ag_call", "fp32 375 x 4096 (the chunk)", ring_ag_call(ctx, chunk), all_gather_reference(ctx, chunk),
            True)
    gathered = torch.empty((w, *chunk.shape), dtype=chunk.dtype, device=dev)
    record("ring_ag_call", "triton_dist_tpu/kernels/allgather.py:96", lambda: ring_ag_call(ctx, chunk),
           lambda: all_gather_reference(ctx, chunk),
           lambda: dist.all_gather_into_tensor(gathered, chunk, group=nccl), all_gather_cost(nbytes(chunk), w))
    two = all_reduce_shard(ctx, x, method=AllReduceMethod.TWO_SHOT)
    bitwise("all_reduce_shard TWO_SHOT", "fp32 1500 x 4096", two, all_gather_reference(ctx, chunk).reshape(x.shape),
            True)
    ragged = draw((6, 4096))
    bitwise("all_reduce_shard TWO_SHOT", "edge: ragged lead 6 (one-shot)",
            all_reduce_shard(ctx, ragged, method=AllReduceMethod.TWO_SHOT), one_shot_ar_reference(ctx, ragged), True)
    for label, shape, dtype in (("edge: bf16 4 x 4096 (one row a chunk)", (4, 4096), torch.bfloat16),
                                ("edge: fp32 8 x 2048", (8, 2048), torch.float32)):
        x = draw(shape, dtype)
        bitwise("ring_rs_call", label, ring_rs_call(ctx, x), ring_rs_reference(ctx, x), False)
    for label, shape, dtype in (("edge: one row, bf16 1 x 4096", (1, 4096), torch.bfloat16),
                                ("edge: 12 bytes", (3,), torch.float32)):
        x = draw(shape, dtype)
        bitwise("ring_ag_call", label, ring_ag_call(ctx, x), all_gather_reference(ctx, x), True)
    # The full mesh: AUTO's route for a shard of at most 128 KiB (timed at a
    # decode step's bf16 4 x 4096), then the edges.
    for label, shape, dtype, timed in (("bf16 4 x 4096", (4, 4096), torch.bfloat16, True),
                                       ("edge: one row, fp32 1 x 64", (1, 64), torch.float32, False),
                                       ("edge: 12 bytes", (3,), torch.float32, False),
                                       ("edge: fp32 4096 x 1024, 16 MiB, over one workspace", (4096, 1024),
                                        torch.float32, False)):
        x = draw(shape, dtype)
        bitwise("full_mesh_ag_call", label, full_mesh_ag_call(ctx, x), all_gather_reference(ctx, x), True)
        if timed:
            gathered = torch.empty((w, *shape), dtype=dtype, device=dev)
            record("full_mesh_ag_call", "triton_dist_tpu/kernels/allgather.py:174",
                   lambda x=x: full_mesh_ag_call(ctx, x), lambda x=x: all_gather_reference(ctx, x),
                   lambda x=x, g=gathered: dist.all_gather_into_tensor(g, x, group=nccl),
                   all_gather_cost(nbytes(x), w))
    ctx.check_status()
    return entries


def standalone_host_ops(ctx) -> dict[str, int]:
    """5a' as a path: the host ops ``all_reduce``, ``all_gather`` and
    ``reduce_scatter`` driven once at the served sizes with AUTO, the launch
    counts reset just before and read just after: an all-reduce of a decode
    step's bf16 4 x 4096 (one-shot) and of a 1500-row fp32 message
    (two-shot: rows 21 and 20), an all-gather of a 32 KB shard (full mesh)
    and of a 6 MB one (ring), a reduce-scatter of the 1500-row message.
    Returns the counts, held to the routers' prediction."""
    import torch

    from triton_dist_tpu_torch.kernels import KERNELS, launch_counts, reset_launch_counts
    from triton_dist_tpu_torch.kernels.allgather import all_gather
    from triton_dist_tpu_torch.kernels.allreduce import all_reduce
    from triton_dist_tpu_torch.kernels.reduce_scatter import reduce_scatter

    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    small = torch.randn((4, 4096), generator=gen, device=dev).to(torch.bfloat16)
    big = torch.randn((1500, 4096), generator=gen, device=dev)
    shard = torch.randn((375, 4096), generator=gen, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    outs = [all_reduce(ctx, small), all_reduce(ctx, big), all_gather(ctx, small), all_gather(ctx, shard),
            reduce_scatter(ctx, big)]
    torch.cuda.synchronize()
    launches = launch_counts()
    want = {name: 0 for name in KERNELS}
    want.update(one_shot_ar_call=1, ring_rs_call=2, ring_ag_call=2, full_mesh_ag_call=1)
    if launches != want:
        raise AssertionError(f"host ops: launches {launches}, expected {want}")
    if [tuple(o.shape) for o in outs] != [(4, 4096), (1500, 4096), (16, 4096), (1500, 4096), (375, 4096)]:
        raise AssertionError(f"host ops: shapes {[tuple(o.shape) for o in outs]}")
    if not all(bool(torch.isfinite(o.float()).all()) for o in outs):
        raise AssertionError("host ops: non-finite results")
    ctx.check_status()
    rlog(ctx, f"5a' host ops (all_reduce x2, all_gather x2, reduce_scatter; AUTO): launches "
         f"{ {k: v for k, v in launches.items() if v} } as predicted")
    return launches


def abort_world4(ctx) -> None:
    """The abort tests, run last in the ranks (they leave the status words
    set): every rank but the last calls row 22 (5a'), then, with the status
    word cleared, row 27 (5i; its first wait on a peer is for the absent
    rank), with its waits bounded by 2 s; each call must end in a
    ``CollectiveAbort`` naming its phase (``ar_recv``, ``ag_kv_recv``) and
    the absent rank, not a hang."""
    import torch

    from triton_dist_tpu_torch.kernels import ag_attn_kernel, one_shot_ar_call
    from triton_dist_tpu_torch.shmem.symm import CollectiveAbort

    absent = ctx.world - 1
    ctx.heap.timeout_ns = int(2e9)
    if ctx.rank == absent:
        rlog(ctx, "abort test: this rank stays away")
        return
    q = torch.ones((1, 32, SP_AG_TOKENS, 128), dtype=torch.bfloat16, device=ctx.device)
    kv = torch.ones((1, 8, SP_AG_TOKENS, 128), dtype=torch.bfloat16, device=ctx.device)
    for label, phase, call in (
            ("row 22", "ar_recv",
             lambda: one_shot_ar_call(ctx, torch.ones((4, 4096), dtype=torch.bfloat16, device=ctx.device))),
            ("row 27", "ag_kv_recv", lambda: ag_attn_kernel(ctx, q, kv, kv))):
        ctx.heap.status.zero_()
        t0 = time.perf_counter()
        call()
        try:
            ctx.check_status()
        except CollectiveAbort as e:
            msg = str(e)
        else:
            raise AssertionError(f"abort test: {label} without rank {absent} ended without an abort")
        if f"'{phase}'" not in msg or f"rank {absent}" not in msg:
            raise AssertionError(f"abort test: the abort does not name the phase and the peer: {msg}")
        rlog(ctx, f"abort test {label}: {msg} ({time.perf_counter() - t0:.2f} s)")


def parity_world4(ctx) -> None:
    """5b: a small fp32 model at world 4, on the card and on the CPU (the
    plain versions over gloo) inside the same ranks, on ``dist``,
    ``dist_ar`` and ``xla``: greedy tokens equal, logits close. Prompts of
    2 x 132 and 132 tokens take rows 16, 17 and 18; every step takes 19."""
    import torch

    from triton_dist_tpu_torch.kernels import launch_counts, reset_launch_counts
    from triton_dist_tpu_torch.models import DenseLLM, Engine, ModelConfig, init_params, params_from_numpy
    from triton_dist_tpu_torch.runtime.mesh import all_gather

    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2, num_q_heads=8,
                      num_kv_heads=4, head_dim=64, dtype="float32")
    full = init_params(cfg, torch.Generator().manual_seed(SEED + 11), "cpu")
    arrays = {k: None if t is None else t.numpy() for k, t in vars(full).items()}
    cpu = ctx.on_cpu()
    m_gpu = DenseLLM(cfg, params_from_numpy(arrays, cfg, ctx.device, rank=ctx.rank, world=ctx.world), ctx=ctx)
    m_cpu = DenseLLM(cfg, params_from_numpy(arrays, cfg, "cpu", rank=ctx.rank, world=ctx.world), ctx=cpu)
    ids = torch.randint(0, cfg.vocab_size, (2, 132), generator=torch.Generator().manual_seed(SEED + 12))
    reset_launch_counts()
    errs, tokens = [], 0
    for backend in ("dist", "dist_ar", "xla"):
        e_gpu, e_cpu = Engine(m_gpu, backend=backend, max_len=160), Engine(m_cpu, backend=backend, max_len=160)
        lg_gpu = all_gather(ctx, m_gpu.prefill(ids, mode=e_gpu.prefill_mode)[0], 1)
        lg_cpu = all_gather(cpu, m_cpu.prefill(ids, mode=e_cpu.prefill_mode)[0], 1)
        errs.append(close(lg_gpu.cpu(), lg_cpu, FP32_LOGITS_TOL, FP32_LOGITS_TOL))
        tok_gpu, tok_cpu = e_gpu.serve(ids, gen_len=8), e_cpu.serve(ids, gen_len=8)
        c_gpu, c_cpu = e_gpu.alloc_slots(2), e_cpu.alloc_slots(2)
        t_gpu, t_cpu = [], []
        for slot, n in enumerate((132, 12)):
            t_gpu.append(e_gpu.prefill_into_slot(c_gpu, slot, ids[slot:slot + 1, :n])[0])
            t_cpu.append(e_cpu.prefill_into_slot(c_cpu, slot, ids[slot:slot + 1, :n])[0])
        rem = torch.tensor([6, 3], dtype=torch.int32)
        out_gpu = e_gpu.decode_steps(c_gpu, torch.stack(t_gpu), rem, 6)[0]
        out_cpu = e_cpu.decode_steps(c_cpu, torch.stack(t_cpu), rem, 6)[0]
        if not (torch.equal(tok_gpu.cpu(), tok_cpu) and torch.equal(out_gpu.cpu(), out_cpu)):
            raise AssertionError(f"world 4 {backend}: CUDA and CPU tokens differ:\ncuda {tok_gpu.tolist()} "
                                 f"{out_gpu.tolist()}\ncpu  {tok_cpu.tolist()} {out_cpu.tolist()}")
        tokens += tok_gpu.numel() + out_gpu.numel()
    ctx.check_status()
    counts = {k: v for k, v in launch_counts().items() if v}
    for name in ("ag_gemm_fused", "gemm_rs_fused", "gemm_ar_fused", "gemm_ar_ll"):
        if not counts.get(name):
            raise AssertionError(f"world 4 fp32 parity did not launch {name}: {counts}")
    rlog(ctx, f"parity fp32 world 4 (L=2, d=256, Hq=8, Hkv=4, D=64; dist, dist_ar, xla): first logits max|err| "
         f"{max(errs):.3e} (tol {FP32_LOGITS_TOL}); {tokens} tokens equal CUDA vs CPU; launches {counts}")


def serve_world4(ctx, steps: int) -> tuple[dict[str, int], dict[str, int]]:
    """5c: Qwen3-8B at full width and depth (bf16, random weights from one
    seed, each rank its shard) at world 4 through ``Engine(backend="dist")``: four requests
    into four slots, ``steps`` steps at B = 4, one ``serve``; then one
    ``dist_ar`` prefill of the longest prompt. Launch counts are read
    around exactly that run and must equal ``expected_tp_world4``. 5c': the
    same model on mega (``serve_tp_world4``: the four requests, then
    ``steps`` steps). Returns the two runs' counts."""
    import torch

    from triton_dist_tpu_torch.kernels import launch_counts, reset_launch_counts
    from triton_dist_tpu_torch.models import PRESETS, DenseLLM, Engine

    cfg = PRESETS["qwen3-8b"]
    dev = ctx.device
    t0 = time.perf_counter()
    model = DenseLLM(cfg, ctx=ctx, generator=torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    ctx.host_barrier()  # the ranks build at different speeds; the device waits start together
    n_params = sum(t.numel() for t in vars(model.params).values() if t is not None)
    rlog(ctx, f"qwen3-8b world 4: {cfg.num_layers} layers, {n_params / 1e9:.2f} B parameters on this rank, built in "
         f"{time.perf_counter() - t0:.1f} s")
    engine = Engine(model, backend="dist", max_len=MAX_LEN)
    tgen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def prompt(n, rows=1):
        return torch.randint(0, cfg.vocab_size, (rows, n), generator=tgen, device=dev)

    warm = engine.alloc_slots(4)
    tok, warm = engine.prefill_into_slot(warm, 0, prompt(400))
    engine.decode_steps(warm, torch.stack([tok] * 4), torch.tensor([2, 0, 0, 0]), 2)
    del warm
    prompts = [prompt(n) for n in W4_PROMPTS]
    serve_rows, serve_prompt, serve_gen = W4_SERVE
    serve_ids = prompt(serve_prompt, rows=serve_rows)
    cache = engine.alloc_slots(len(prompts))
    ar_engine = Engine(model, backend="dist_ar", max_len=MAX_LEN)
    ar_cache = ar_engine.alloc_slots(1)
    torch.cuda.synchronize()
    ctx.host_barrier()
    reset_launch_counts()
    ttft, tokens0 = [], []
    for slot, ids in enumerate(prompts):
        t0 = time.perf_counter()
        tok, cache = engine.prefill_into_slot(cache, slot, ids)
        tokens0.append(int(tok))
        ttft.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, last, cache, rem = engine.decode_steps(
        cache, torch.tensor(tokens0, dtype=torch.int32), torch.full((4,), steps), steps)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / steps
    t0 = time.perf_counter()
    served = engine.serve(serve_ids, gen_len=serve_gen)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ar_tok, _ = ar_engine.prefill_into_slot(ar_cache, 0, prompts[-1])
    ar_ttft = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()

    n_steps = steps + serve_gen - 1
    want = expected_tp_world4(cfg, ctx.world, [*W4_PROMPTS, serve_rows * serve_prompt], [W4_PROMPTS[-1]], n_steps,
                              mega=False)
    if launches != want:
        raise AssertionError(f"world 4: launches on the served path {launches}, expected {want}")
    for name, toks in (("decode_steps", out), ("serve", served)):
        if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
            raise AssertionError(f"world 4 {name} produced tokens outside the vocabulary: {toks.tolist()}")
    want_len = [n + steps for n in W4_PROMPTS]
    if cache.lengths.tolist() != want_len or rem.tolist() != [0] * 4:
        raise AssertionError(f"world 4 slot lengths {cache.lengths.tolist()} != {want_len}")
    step_logits = engine._decode(last, cache, cache.lengths)
    if not bool(torch.isfinite(step_logits).all()):
        raise AssertionError("world 4: non-finite logits")
    if not _same_on_every_rank(ctx, torch.cat([out.flatten(), served.flatten(), torch.tensor(tokens0, device=dev)])):
        raise AssertionError("world 4: the ranks sampled different tokens")
    ctx.check_status()
    rlog(ctx, "qwen3-8b world 4 [dist] TTFT " + ", ".join(f"prompt {n}: {t:.2f} ms" for n, t in zip(W4_PROMPTS, ttft))
         + f"; [dist_ar] prompt {W4_PROMPTS[-1]}: {ar_ttft:.2f} ms (first token {int(ar_tok)}, dist gave "
         f"{tokens0[-1]})")
    rlog(ctx, f"qwen3-8b world 4 [dist] decode_steps B=4, {steps} steps: {decode_ms:.2f} ms/step "
         f"({4 * 1e3 / decode_ms:.1f} tokens/s); serve B={serve_rows} {serve_prompt}+{serve_gen}: {serve_ms:.1f} ms")
    rlog(ctx, f"qwen3-8b world 4 launches ({len(W4_PROMPTS) + 1} dist prefills, 1 dist_ar prefill, {n_steps} steps): "
         f"{ {k: v for k, v in launches.items() if v} }; equal on every rank; peak device memory "
         f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    for label, fn, n_steps, unprofiled in (
            ("decode_steps B=4", lambda: engine.decode_steps(cache, last, torch.full((4,), 4), 4), 4, decode_ms),
            (f"prefill {W4_PROMPTS[2]} tokens", lambda: model.prefill(prompts[2]), 1, ttft[2])):
        ctx.host_barrier()
        wall, busy, families, n_kernels = profile_window(fn)
        if busy is None:
            rlog(ctx, f"world 4 profile {label}: device time not measured (no CUDA kernels recorded)")
            continue
        shares = ", ".join(f"{k} {v / n_steps:.3f} ms" for k, v in sorted(families.items(), key=lambda kv: -kv[1]))
        rlog(ctx, f"world 4 profile {label}: profiled wall {wall / n_steps:.2f} ms/step, device busy "
             f"{busy / n_steps:.3f} ms/step ({100 * busy / wall:.1f} %; unprofiled {unprofiled:.2f} ms/step), "
             f"{n_kernels / n_steps:.0f} kernels/step; by family: {shares}")
    mega_launches = serve_tp_world4(ctx, model, "qwen3-8b", "mega", steps)
    return launches, mega_launches


def _decode_hidden(engine, token, cache):
    """The final-normed hidden states of one more decode step on
    ``engine``'s backend (the mega step on mega); the caches take its row."""
    model = engine.model
    if engine.decode_mode != "mega":
        return model.decode_hidden(token, cache.k, cache.v, cache.lengths, mode=engine.decode_mode)
    x, _, _ = engine._mega_step(engine._mega_layers, model.params.embed[token.long()], cache.k, cache.v,
                                cache.lengths)
    return model.final_norm(x)


def parity_tp_world4(ctx) -> None:
    """5b': fp32 at world 4, on the card and on the CPU (the plain versions
    over gloo) inside the same ranks: ``test-dense`` on mega, and the
    ``test-moe`` shape with ff 64 (16 a rank: the fused MoE kernel takes ff
    in multiples of 8) as ``Qwen3MoE`` on ``dist``, ``dist_ar`` and mega.
    Greedy tokens equal, logits within ``FP32_LOGITS_TOL``, the decode's
    hidden states the same bits on every rank. Prompts of 2 x 72 tokens take
    the MoE rings (36 tokens a rank), the 72-token slot the chunked ring
    and the 12-token one the gathered tiny shard and the unchunked
    all-reduce; every decode step takes row 22."""
    import dataclasses

    import torch

    from triton_dist_tpu_torch.kernels import launch_counts, reset_launch_counts
    from triton_dist_tpu_torch.models import PRESETS, DenseLLM, Engine, Qwen3MoE, init_params, params_from_numpy
    from triton_dist_tpu_torch.runtime.mesh import all_gather

    cpu = ctx.on_cpu()
    ids = torch.randint(0, 256, (2, 72), generator=torch.Generator().manual_seed(SEED + 42))
    reset_launch_counts()
    errs, tokens = [], 0
    moe_cfg = dataclasses.replace(PRESETS["test-moe"], moe_intermediate_size=64)
    for cfg, cls, backends in ((PRESETS["test-dense"], DenseLLM, ("mega",)),
                               (moe_cfg, Qwen3MoE, ("dist", "dist_ar", "mega"))):
        full = init_params(cfg, torch.Generator().manual_seed(SEED + 41), "cpu")
        arrays = {k: None if t is None else t.numpy() for k, t in vars(full).items()}
        m_gpu = cls(cfg, params_from_numpy(arrays, cfg, ctx.device, rank=ctx.rank, world=ctx.world), ctx=ctx)
        m_cpu = cls(cfg, params_from_numpy(arrays, cfg, "cpu", rank=ctx.rank, world=ctx.world), ctx=cpu)
        for backend in backends:
            e_gpu, e_cpu = Engine(m_gpu, backend=backend, max_len=96), Engine(m_cpu, backend=backend, max_len=96)
            lg_gpu = all_gather(ctx, m_gpu.prefill(ids, mode=e_gpu.prefill_mode)[0], 1)
            lg_cpu = all_gather(cpu, m_cpu.prefill(ids, mode=e_cpu.prefill_mode)[0], 1)
            errs.append(close(lg_gpu.cpu(), lg_cpu, FP32_LOGITS_TOL, FP32_LOGITS_TOL))
            tok_gpu, tok_cpu = e_gpu.serve(ids, gen_len=6), e_cpu.serve(ids, gen_len=6)
            c_gpu, c_cpu = e_gpu.alloc_slots(2), e_cpu.alloc_slots(2)
            t_gpu, t_cpu = [], []
            for slot, n in enumerate((72, 12)):
                t_gpu.append(e_gpu.prefill_into_slot(c_gpu, slot, ids[slot:slot + 1, :n])[0])
                t_cpu.append(e_cpu.prefill_into_slot(c_cpu, slot, ids[slot:slot + 1, :n])[0])
            rem = torch.tensor([6, 3], dtype=torch.int32)
            out_gpu, last, _, _ = e_gpu.decode_steps(c_gpu, torch.stack(t_gpu), rem, 6)
            out_cpu = e_cpu.decode_steps(c_cpu, torch.stack(t_cpu), rem, 6)[0]
            if not (torch.equal(tok_gpu.cpu(), tok_cpu) and torch.equal(out_gpu.cpu(), out_cpu)):
                raise AssertionError(f"world 4 {cls.__name__} {backend}: CUDA and CPU tokens differ:\n"
                                     f"cuda {tok_gpu.tolist()} {out_gpu.tolist()}\n"
                                     f"cpu  {tok_cpu.tolist()} {out_cpu.tolist()}")
            tokens += tok_gpu.numel() + out_gpu.numel()
            if not _same_on_every_rank(ctx, _decode_hidden(e_gpu, last, c_gpu)):
                raise AssertionError(f"world 4 {cls.__name__} {backend}: the ranks' hidden states differ")
    ctx.check_status()
    counts = {k: v for k, v in launch_counts().items() if v}
    for name in ("one_shot_ar_call", "fused_moe_block", "fused_attn_back", "group_gemm_swiglu"):
        if not counts.get(name):
            raise AssertionError(f"world 4 fp32 parity (mega, TP_MoE) did not launch {name}: {counts}")
    rlog(ctx, f"parity fp32 world 4 (test-dense on mega; test-moe with ff 64 as Qwen3MoE on dist, dist_ar, mega): "
         f"first logits max|err| {max(errs):.3e} (tol {FP32_LOGITS_TOL}); {tokens} tokens equal CUDA vs CPU; decode "
         f"hidden states bitwise equal on every rank; launches {counts}")


def expected_tp_world4(cfg, world: int, dist_rows: list[int], dist_ar_rows: list[int], steps: int,
                       mega: bool) -> dict:
    """Launches of a world-4 run of a ``DenseLLM`` or ``Qwen3MoE`` (``TP_MoE``)
    through ``Engine``: prefills of m rows in ``dist`` mode (``dist_rows``)
    or in ``dist_ar`` mode (``dist_ar_rows``, the mega backend's prefill),
    then ``steps`` decode steps, on ``dist_ar`` or, with ``mega``, through
    the mega step. Per layer: in a ``dist`` prefill of m rows the wqkv and
    (dense) gate/up AG-GEMMs (row 16 above the AG crossover, else the ring)
    and the wo and (dense) down GEMM-RS (row 17 above the RS crossover,
    else the ring); in a ``dist_ar`` prefill or a decode step the wo and
    (dense) down GEMM-AR (18 or 19); a MoE block's
    route by mode and tokens (``TP_MoE.forward``): a ring (one grouped
    SwiGLU and one plain collective a chunk) or the unchunked grouped SwiGLU
    and ``all_reduce_shard`` (row 22; two-shot, rows 21 and 20, above 256
    KiB with a lead that splits over the ranks). A mega step: the three
    fused layer kernels, row 22 twice a layer (the attention's bf16 partial,
    the MLP's or MoE's fp32 one), one ``fused_norm_head``. Every plain
    collective is two barriers; every prefill and step gathers its logits."""
    import torch

    from triton_dist_tpu_torch.kernels import KERNELS
    from triton_dist_tpu_torch.kernels.allgather_gemm import AGGemmMethod, get_auto_ag_gemm_method
    from triton_dist_tpu_torch.kernels.allreduce import AllReduceMethod, get_auto_all_reduce_method
    from triton_dist_tpu_torch.kernels.gemm_allreduce import GemmARMethod, get_auto_gemm_ar_method
    from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import GemmRSMethod, get_auto_gemm_rs_method

    layers, d = cfg.num_layers, cfg.hidden_size
    n_qkv = (cfg.num_q_heads + 2 * cfg.num_kv_heads) * cfg.head_dim // world
    want = {name: 0 for name in KERNELS}
    plain = 0

    def gemm_ar(m, calls):
        fused = get_auto_gemm_ar_method(m, world) is GemmARMethod.PALLAS_FUSED
        want["gemm_ar_fused" if fused else "gemm_ar_ll"] += calls * layers

    def moe(t, mode):
        nonlocal plain
        if mode == "dist" and t < 8:  # the tiny shards gathered, then the replicated path
            plain += layers
            moe(t * world, "dist_ar")
        elif mode == "dist" or (t % world == 0 and t // world >= 8):  # a ring of world chunks
            want["group_gemm_swiglu"] += world * layers
            plain += world * layers
        else:
            want["group_gemm_swiglu"] += layers
            if get_auto_all_reduce_method(t * d * 4, world) is AllReduceMethod.TWO_SHOT and t % world == 0:
                want["ring_rs_call"] += layers
                want["ring_ag_call"] += layers
            else:
                want["one_shot_ar_call"] += layers

    for m in dist_rows:
        mlp_cols = [] if cfg.is_moe else [cfg.intermediate_size // world]
        for n in [n_qkv, *mlp_cols]:
            fused = get_auto_ag_gemm_method(m // world, d, n, torch.bfloat16, world) is AGGemmMethod.PALLAS_FUSED
            want["ag_gemm_fused"] += layers if fused else 0
            plain += 0 if fused else layers
        fused = get_auto_gemm_rs_method(m, world) is GemmRSMethod.PALLAS_FUSED
        rs_calls = 1 if cfg.is_moe else 2
        want["gemm_rs_fused"] += rs_calls * layers if fused else 0
        plain += (0 if fused else rs_calls * layers) + 2  # and the gathers of the rows and of the logits
        if cfg.is_moe:
            moe(m // world, "dist")
    for m in dist_ar_rows:
        gemm_ar(m, 1 if cfg.is_moe else 2)
        plain += 1
        if cfg.is_moe:
            moe(m, "dist_ar")
    want["flash_attention"] = layers * (len(dist_rows) + len(dist_ar_rows))
    plain += steps
    if mega:
        want.update(fused_ln_qkv_rope=layers * steps, fused_attn_back=layers * steps, fused_norm_head=steps)
        want["fused_moe_block" if cfg.is_moe else "fused_mlp_block"] = layers * steps
        want["one_shot_ar_call"] += 2 * layers * steps
    else:
        want["flash_decode"] = layers * steps
        gemm_ar(4, (1 if cfg.is_moe else 2) * steps)  # decode batches of at most 4 rows take row 19
        for _ in range(steps):
            if cfg.is_moe:
                moe(4, "dist_ar")
    want["barrier_all_on_device"] = 2 * plain
    return want


def _tp_profiles(ctx, label, runs) -> None:
    """The profile lines of §5 for ``runs``: (what, fn, steps, unprofiled ms)."""
    for what, fn, n_steps, unprofiled in runs:
        ctx.host_barrier()
        wall, busy, families, n_kernels = profile_window(fn)
        if busy is None:
            rlog(ctx, f"{label} profile {what}: device time not measured (no CUDA kernels recorded)")
            continue
        shares = ", ".join(f"{k} {v / n_steps:.3f} ms" for k, v in sorted(families.items(), key=lambda kv: -kv[1]))
        rlog(ctx, f"{label} profile {what}: profiled wall {wall / n_steps:.2f} ms/step, device busy "
             f"{busy / n_steps:.3f} ms/step ({100 * busy / wall:.1f} %; unprofiled {unprofiled:.2f} ms/step), "
             f"{n_kernels / n_steps:.0f} kernels/step; by family: {shares}")


def serve_tp_world4(ctx, model, label: str, backend: str, steps: int, serve=None) -> dict[str, int]:
    """``model`` (its ranks' shards, built) at world 4 through
    ``Engine(backend=...)``: the ``W4_PROMPTS`` requests into four slots,
    ``steps`` decode steps at B = 4 and, with ``serve`` (rows, prompt,
    gen), one ``serve``. Launch counts are read around exactly that run and
    must equal ``expected_tp_world4``; the tokens must be the same on every
    rank, the decode's hidden states too. Then the profile lines of one
    decode chunk (and, on ``dist``, of one prefill)."""
    import torch

    from triton_dist_tpu_torch.kernels import launch_counts, reset_launch_counts
    from triton_dist_tpu_torch.models import Engine

    cfg, dev = model.config, ctx.device
    engine = Engine(model, backend=backend, max_len=MAX_LEN)
    tgen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def prompt(n, rows=1):
        return torch.randint(0, cfg.vocab_size, (rows, n), generator=tgen, device=dev)

    warm = engine.alloc_slots(4)
    tok, warm = engine.prefill_into_slot(warm, 0, prompt(400))
    engine.decode_steps(warm, torch.stack([tok] * 4), torch.tensor([2, 0, 0, 0]), 2)
    del warm
    prompts = [prompt(n) for n in W4_PROMPTS]
    serve_ids = prompt(serve[1], rows=serve[0]) if serve else None
    cache = engine.alloc_slots(len(prompts))
    torch.cuda.synchronize()
    ctx.host_barrier()
    reset_launch_counts()
    ttft, tokens0 = [], []
    for slot, ids in enumerate(prompts):
        t0 = time.perf_counter()
        tok, cache = engine.prefill_into_slot(cache, slot, ids)
        tokens0.append(int(tok))
        ttft.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, last, cache, rem = engine.decode_steps(
        cache, torch.tensor(tokens0, dtype=torch.int32), torch.full((4,), steps), steps)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / steps
    served = torch.zeros(0, dtype=torch.int32, device=dev)
    if serve:
        t0 = time.perf_counter()
        served = engine.serve(serve_ids, gen_len=serve[2])
        torch.cuda.synchronize()
        serve_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()

    rows = list(W4_PROMPTS) + ([serve[0] * serve[1]] if serve else [])
    n_steps = steps + (serve[2] - 1 if serve else 0)
    mega = backend == "mega"
    want = expected_tp_world4(cfg, ctx.world, [] if mega else rows, rows if mega else [], n_steps, mega)
    if launches != want:
        raise AssertionError(f"{label} [{backend}]: launches on the served path {launches}, expected {want}")
    for name, toks in (("decode_steps", out), ("serve", served)):
        if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
            raise AssertionError(f"{label} [{backend}] {name} produced tokens outside the vocabulary: {toks.tolist()}")
    want_len = [n + steps for n in W4_PROMPTS]
    if cache.lengths.tolist() != want_len or rem.tolist() != [0] * 4:
        raise AssertionError(f"{label} [{backend}] slot lengths {cache.lengths.tolist()} != {want_len}")
    hidden = _decode_hidden(engine, last, cache)
    if not bool(torch.isfinite(hidden).all()):
        raise AssertionError(f"{label} [{backend}]: non-finite hidden states")
    if not _same_on_every_rank(ctx, hidden):
        raise AssertionError(f"{label} [{backend}]: the ranks' decode hidden states differ")
    if not _same_on_every_rank(ctx, torch.cat([out.flatten(), served.flatten(), torch.tensor(tokens0, device=dev)])):
        raise AssertionError(f"{label} [{backend}]: the ranks sampled different tokens")
    ctx.check_status()
    rlog(ctx, f"{label} world 4 [{backend}] TTFT " + ", ".join(f"prompt {n}: {t:.2f} ms" for n, t in
                                                               zip(W4_PROMPTS, ttft)))
    rlog(ctx, f"{label} world 4 [{backend}] decode_steps B=4, {steps} steps: {decode_ms:.2f} ms/step "
         f"({4 * 1e3 / decode_ms:.1f} tokens/s)" + (f"; serve B={serve[0]} {serve[1]}+{serve[2]}: {serve_ms:.1f} ms"
                                                  if serve else "")
         + f"; peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB on this rank")
    rlog(ctx, f"{label} world 4 [{backend}] launches ({len(rows)} prefills, {n_steps} steps): "
         f"{ {k: v for k, v in launches.items() if v} }, as predicted; equal on every rank; decode hidden states "
         "bitwise equal on every rank")
    runs = [("decode_steps B=4", lambda: engine.decode_steps(cache, last, torch.full((4,), 2), 2), 2, decode_ms)]
    if not mega:
        runs.append((f"prefill {W4_PROMPTS[2]} tokens", lambda: model.prefill(prompts[2]), 1, ttft[2]))
    _tp_profiles(ctx, f"{label} world 4 [{backend}]", runs)
    return launches


def serve_tp_moe_world4(ctx, steps: int) -> list[dict[str, int]]:
    """5h: Qwen3-30B-A3B at full width and depth as ``Qwen3MoE`` (``TP_MoE``:
    every rank holds every expert's ff / world columns; bf16, random
    weights from one seed) served at world 4 on ``dist`` (the 5c prompts in
    four slots, ``steps`` decode steps, one ``serve``) and then, on the same
    model, on mega. Returns the two runs' launch counts."""
    import torch

    from triton_dist_tpu_torch.models import PRESETS, Qwen3MoE

    cfg = PRESETS[TP_MOE_PRESET]
    dev = ctx.device
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = Qwen3MoE(cfg, ctx=ctx, generator=torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    ctx.host_barrier()
    n_params = sum(t.numel() for t in vars(model.params).values() if t is not None)
    rlog(ctx, f"{TP_MOE_PRESET} TP_MoE world 4: {cfg.num_layers} layers, {cfg.num_experts} experts of ff "
         f"{cfg.moe_intermediate_size // ctx.world} a rank, {n_params / 1e9:.2f} B parameters on this rank, built in "
         f"{time.perf_counter() - t0:.1f} s")
    runs = [serve_tp_world4(ctx, model, TP_MOE_PRESET, "dist", steps, serve=TP_MOE_SERVE),
            serve_tp_world4(ctx, model, TP_MOE_PRESET, "mega", steps)]
    return runs


def _routed_send(ctx, cfg, tokens: int, gen, replicated: bool = False):
    """The slot grid the served path sends for ``tokens`` random bf16 tokens
    a rank, routed top-k by a random router with capacity factor 2.0:
    (world, E_local·C, d), destination-major, and C. ``replicated``: the
    same tokens on every rank (the ``dist_ar`` route)."""
    import torch

    from triton_dist_tpu_torch.kernels.group_gemm import matmul_f32
    from triton_dist_tpu_torch.kernels.moe_utils import capacity_for, dispatch, make_routing_plan, topk_routing

    d, e, w = cfg.hidden_size, cfg.num_experts, ctx.world
    x_all = torch.randn((w, tokens, d), generator=gen, device=ctx.device).to(torch.bfloat16)
    x = x_all[0] if replicated else x_all[ctx.rank]
    router = (torch.randn((d, e), generator=gen, device=ctx.device) * 0.02).to(torch.bfloat16)
    idx, _ = topk_routing(matmul_f32(x, router), cfg.top_k)
    cap = capacity_for(tokens, cfg.top_k, e, 2.0)
    plan = make_routing_plan(idx, e, cap)
    return dispatch(x, plan).reshape(w, e // w * cap, d).contiguous(), cap


def check_ep_kernels(ctx, flush_buf, nccl) -> dict[str, dict]:
    """5d: rows 25 and 26 against their plain versions at the Qwen3-30B-A3B
    world-4 shapes of the served path and at the edges (bf16). Row 25 must
    equal the plain all-to-all bit for bit; row 26 is within the bf16
    tolerance of the plain dispatch, ``group_swiglu_reference`` and ``bmm``
    down in fp32, and return, and where every rank routes the same tokens
    every rank gets the same bits. Each kernel is timed beside its plain
    version, its bound and, when every rank has its own card, NCCL's
    all-to-all (row 26: NCCL all-to-all, ``bmm``, silu·mul, ``bmm``, NCCL
    all-to-all)."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from triton_dist_tpu_torch.kernels import all_to_all_kernel, fused_ep_kernel, fused_ep_reference
    from triton_dist_tpu_torch.kernels.ep_a2a import a2a_cost
    from triton_dist_tpu_torch.kernels.ep_fused import fused_ep_cost
    from triton_dist_tpu_torch.kernels.low_latency_a2a import quantize_fp8
    from triton_dist_tpu_torch.kernels.moe_utils import regroup_by_expert, ungroup_to_peers
    from triton_dist_tpu_torch.models import PRESETS
    from triton_dist_tpu_torch.runtime.mesh import all_to_all

    cfg = PRESETS[EP_PRESET]
    w, dev = ctx.world, ctx.device
    d, ff, e_local = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts // w
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)  # the same draws on every rank
    entries = {}

    # Row 25: the three legs of a decode step's low-latency route (B = 4:
    # C = 8), then the edges.
    send, cap = _routed_send(ctx, cfg, 4, gen)
    q, scale = quantize_fp8(send.reshape(-1, d))
    one, _ = _routed_send(ctx, cfg, 1, gen)
    zero_src = torch.randn((w, 24, 64), generator=gen, device=dev).to(torch.bfloat16)
    if ctx.rank == 1:
        zero_src.zero_()
    cases = (("decode fp8 payload (int8 view)", q.view(torch.int8).reshape(w, -1, d)),
             ("decode scales", scale.reshape(w, -1, 1)), ("decode combine leg bf16", send),
             ("T=1 combine leg", one), ("12-byte chunks", torch.randn((w, 3, 1), generator=gen, device=dev)),
             ("all-zero source (rank 1)", zero_src))
    for label, x in cases:
        got = all_to_all_kernel(ctx, x)
        plain = all_to_all(ctx, x)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.uint8), plain.view(torch.uint8)):
            raise AssertionError(f"all_to_all_kernel {label}: differs from the plain all-to-all")
        rlog(ctx, f"all_to_all_kernel {label} {tuple(x.shape)} {x.dtype}: bitwise equal to the plain all-to-all")

    def nccl_a2a(x):
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=nccl)
        return out

    entries["all_to_all_kernel"] = timed_entry(
        ctx, flush_buf, "all_to_all_kernel", "triton_dist_tpu_torch/csrc/ep_a2a.cu",
        "triton_dist_tpu/kernels/ep_a2a.py:46", lambda: all_to_all_kernel(ctx, send), lambda: all_to_all(ctx, send),
        (lambda: nccl_a2a(send)) if nccl is not None else None, a2a_cost(send, w), library_name="NCCL all_to_all")
    entries["all_to_all_kernel"]["max_abs_err"] = 0.0

    # Row 26: this rank's 32 experts at full width, random bf16.
    wg = (torch.randn((e_local, d, ff), generator=gen, device=dev) * d ** -0.5).to(torch.bfloat16)
    wu = (torch.randn((e_local, d, ff), generator=gen, device=dev) * d ** -0.5).to(torch.bfloat16)
    wd = (torch.randn((e_local, ff, d), generator=gen, device=dev) * ff ** -0.5).to(torch.bfloat16)
    err26 = 0.0
    # (label, tokens a rank, replicated, rank whose send is all zero, timed)
    for label, t, replicated, zero, timed in (("dist prefill S=384", 96, False, None, False),
                                             ("dist prefill S=776", 194, False, None, False),
                                             ("dist prefill S=1500", 375, False, None, True),
                                             (f"dist_ar prefill S={EP_AR_PROMPT}, replicated", EP_AR_PROMPT, True,
                                              None, False),
                                             ("edge T=1", 1, False, None, False),
                                             ("edge C=72", 575, False, None, False),
                                             ("edge all-zero source (rank 2)", 96, False, 2, False)):
        send, cap = _routed_send(ctx, cfg, t, gen, replicated)
        if zero == ctx.rank:
            send.zero_()
        got = fused_ep_kernel(ctx, send, wg, wu, wd, capacity=cap)
        plain = fused_ep_reference(ctx, send, wg, wu, wd, capacity=cap)
        torch.cuda.synchronize()
        err = close(got, plain, BF16_ATOL, BF16_RTOL)
        err26 = max(err26, err)
        same = ""
        if replicated:
            if not _same_on_every_rank(ctx, got):
                raise AssertionError(f"fused_ep_kernel {label}: the ranks' outputs differ")
            same = "; bitwise equal on every rank"
        rlog(ctx, f"fused_ep_kernel {label} (C {cap}, E_local {e_local}, d {d}, ff {ff}): max|err| {err:.3e}{same}")
        if timed:
            recv = all_to_all(ctx, send).reshape(w, e_local, cap, d)
            live = recv.abs().amax(dim=-1) > 0
            live_rows, live_experts = int(live.sum()), int(live.any(dim=2).any(dim=0).sum())

            def library(send=send, cap=cap):
                xs = regroup_by_expert(nccl_a2a(send), w, e_local, cap)
                y = torch.bmm(F.silu(torch.bmm(xs, wg)) * torch.bmm(xs, wu), wd)
                return nccl_a2a(ungroup_to_peers(y, w, e_local, cap).contiguous())

            entries["fused_ep_kernel"] = timed_entry(
                ctx, flush_buf, "fused_ep_kernel", "triton_dist_tpu_torch/csrc/ep_fused.cu",
                "triton_dist_tpu/kernels/ep_fused.py:50",
                lambda send=send, cap=cap: fused_ep_kernel(ctx, send, wg, wu, wd, capacity=cap),
                lambda send=send, cap=cap: fused_ep_reference(ctx, send, wg, wu, wd, capacity=cap),
                library if nccl is not None else None,
                fused_ep_cost(w, e_local, cap, d, ff, 2, live_rows, live_experts),
                library_name="NCCL all_to_all + bmm, silu*mul, bmm + NCCL all_to_all")
            rlog(ctx, f"fused_ep_kernel bound counts {live_rows} live rows of {w * e_local * cap} and "
                 f"{live_experts} live experts of {e_local}")
    entries["fused_ep_kernel"]["max_abs_err"] = err26
    ctx.check_status()
    return entries


def parity_ep_world4(ctx) -> None:
    """5e: the fp32 ``test-moe`` ``EPMoELLM`` at world 4 with the one-sided
    transport (rows 25 and 26), on the card and on the CPU (the plain
    versions over gloo) inside the same ranks, on ``xla``, ``dist`` and
    ``dist_ar``: greedy tokens equal, logits within ``FP32_LOGITS_TOL``; on
    ``dist`` and ``dist_ar`` the decode's hidden states are the same bits on
    every rank. Prompts of 2 x 72 tokens take row 26 (36 rows a rank in a
    dist prefill), the slots and every decode step row 25."""
    import torch

    from triton_dist_tpu_torch.kernels import launch_counts, reset_launch_counts
    from triton_dist_tpu_torch.models import PRESETS, Engine, EPMoELLM, init_params, params_from_numpy
    from triton_dist_tpu_torch.runtime.mesh import all_gather

    cfg = PRESETS["test-moe"]
    full = init_params(cfg, torch.Generator().manual_seed(SEED + 31), "cpu")
    arrays = {k: None if t is None else t.numpy() for k, t in vars(full).items()}
    cpu = ctx.on_cpu()

    def model(dev, c):
        params = params_from_numpy(arrays, cfg, dev, rank=ctx.rank, world=ctx.world, expert_parallel=True)
        return EPMoELLM(cfg, params, ctx=c, use_pallas_a2a=True)

    m_gpu, m_cpu = model(ctx.device, ctx), model("cpu", cpu)
    ids = torch.randint(0, cfg.vocab_size, (2, 72), generator=torch.Generator().manual_seed(SEED + 32))
    reset_launch_counts()
    errs, tokens = [], 0
    for backend in ("xla", "dist", "dist_ar"):
        e_gpu, e_cpu = Engine(m_gpu, backend=backend, max_len=96), Engine(m_cpu, backend=backend, max_len=96)
        lg_gpu = all_gather(ctx, m_gpu.prefill(ids, mode=e_gpu.prefill_mode)[0], 1)
        lg_cpu = all_gather(cpu, m_cpu.prefill(ids, mode=e_cpu.prefill_mode)[0], 1)
        errs.append(close(lg_gpu.cpu(), lg_cpu, FP32_LOGITS_TOL, FP32_LOGITS_TOL))
        tok_gpu, tok_cpu = e_gpu.serve(ids, gen_len=6), e_cpu.serve(ids, gen_len=6)
        c_gpu, c_cpu = e_gpu.alloc_slots(2), e_cpu.alloc_slots(2)
        t_gpu, t_cpu = [], []
        for slot, n in enumerate((72, 12)):
            t_gpu.append(e_gpu.prefill_into_slot(c_gpu, slot, ids[slot:slot + 1, :n])[0])
            t_cpu.append(e_cpu.prefill_into_slot(c_cpu, slot, ids[slot:slot + 1, :n])[0])
        rem = torch.tensor([6, 3], dtype=torch.int32)
        out_gpu, last, _, _ = e_gpu.decode_steps(c_gpu, torch.stack(t_gpu), rem, 6)
        out_cpu = e_cpu.decode_steps(c_cpu, torch.stack(t_cpu), rem, 6)[0]
        if not (torch.equal(tok_gpu.cpu(), tok_cpu) and torch.equal(out_gpu.cpu(), out_cpu)):
            raise AssertionError(f"EP world 4 {backend}: CUDA and CPU tokens differ:\ncuda {tok_gpu.tolist()} "
                                 f"{out_gpu.tolist()}\ncpu  {tok_cpu.tolist()} {out_cpu.tolist()}")
        tokens += tok_gpu.numel() + out_gpu.numel()
        if backend != "xla":
            hidden = m_gpu.decode_hidden(last, c_gpu.k, c_gpu.v, c_gpu.lengths, mode=e_gpu.decode_mode)
            if not _same_on_every_rank(ctx, hidden):
                raise AssertionError(f"EP world 4 {backend}: the ranks' hidden states differ")
    ctx.check_status()
    counts = {k: v for k, v in launch_counts().items() if v}
    for name in EP_KERNELS:
        if not counts.get(name):
            raise AssertionError(f"EP world 4 fp32 parity did not launch {name}: {counts}")
    rlog(ctx, f"parity fp32 EP world 4 (test-moe: 8 experts, 2 a rank; xla, dist, dist_ar): first logits max|err| "
         f"{max(errs):.3e} (tol {FP32_LOGITS_TOL}); {tokens} tokens equal CUDA vs CPU; decode hidden states "
         f"bitwise equal on every rank (dist, dist_ar); launches {counts}")


def expected_ep_world4(cfg, world: int, dist_rows: list[int], dist_ar_rows: list[int], steps: int,
                       batch: int) -> dict:
    """Launches of an expert-parallel world-4 run: the attention's as in
    ``expected_tp_world4`` (wqkv's AG-GEMM and wo's GEMM-RS in a dist prefill,
    wo's GEMM-AR in a dist_ar prefill and every decode step); per layer of
    every MoE call the route of its tokens a rank: the low-latency route's
    three all-to-alls (fp8 payload, scales, combine) and one grouped SwiGLU
    (row 8), or one fused EP call (row 26)."""
    import torch

    from triton_dist_tpu_torch.kernels import KERNELS
    from triton_dist_tpu_torch.kernels.allgather_gemm import AGGemmMethod, get_auto_ag_gemm_method
    from triton_dist_tpu_torch.kernels.gemm_allreduce import GemmARMethod, get_auto_gemm_ar_method
    from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import GemmRSMethod, get_auto_gemm_rs_method
    from triton_dist_tpu_torch.kernels.low_latency_a2a import EPMoEMethod, get_auto_ep_moe_method

    layers, d = cfg.num_layers, cfg.hidden_size
    n_qkv = (cfg.num_q_heads + 2 * cfg.num_kv_heads) * cfg.head_dim // world
    want = {name: 0 for name in KERNELS}

    def moe(t, calls):
        if get_auto_ep_moe_method(t, world) is EPMoEMethod.LOW_LATENCY:
            want["all_to_all_kernel"] += 3 * layers * calls
            want["group_gemm_swiglu"] += layers * calls
        else:
            want["fused_ep_kernel"] += layers * calls

    plain = steps  # each step's gather of the logits
    for m in dist_rows:
        fused = get_auto_ag_gemm_method(m // world, d, n_qkv, torch.bfloat16, world) is AGGemmMethod.PALLAS_FUSED
        want["ag_gemm_fused"] += layers if fused else 0
        plain += 0 if fused else layers
        fused = get_auto_gemm_rs_method(m, world) is GemmRSMethod.PALLAS_FUSED
        want["gemm_rs_fused"] += layers if fused else 0
        plain += (0 if fused else layers) + 2  # and the gathers of the rows and of the logits
        moe(m // world, 1)
    for m in dist_ar_rows:
        key = "gemm_ar_fused" if get_auto_gemm_ar_method(m, world) is GemmARMethod.PALLAS_FUSED else "gemm_ar_ll"
        want[key] += layers
        plain += 1
        moe(m, 1)
    want["gemm_ar_ll"] += layers * steps
    moe(batch, steps)
    want["flash_attention"] = layers * (len(dist_rows) + len(dist_ar_rows))
    want["flash_decode"] = layers * steps
    want["barrier_all_on_device"] = 2 * plain
    return want


def serve_ep_world4(ctx, steps: int) -> dict[str, int]:
    """5f: Qwen3-30B-A3B at full width and depth as ``EPMoELLM`` (bf16,
    random weights from one seed; each rank draws every layer's global
    expert slab and keeps its 32 whole experts) served at world 4 through
    ``Engine(backend="dist")`` with the one-sided transport: four requests
    into four slots, ``steps`` decode steps at B = 4, then one ``dist_ar``
    prefill of ``EP_AR_PROMPT`` tokens (row 26 on replicated tokens). Launch
    counts are read around exactly that run and must equal
    ``expected_ep_world4``."""
    import torch

    from triton_dist_tpu_torch.kernels import launch_counts, reset_launch_counts
    from triton_dist_tpu_torch.models import PRESETS, Engine, EPMoELLM

    cfg = PRESETS[EP_PRESET]
    dev = ctx.device
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = EPMoELLM(cfg, ctx=ctx, generator=torch.Generator(device=dev).manual_seed(SEED), use_pallas_a2a=True)
    torch.cuda.synchronize()
    ctx.host_barrier()
    n_params = sum(t.numel() for t in vars(model.params).values() if t is not None)
    rlog(ctx, f"{EP_PRESET} EP world 4: {cfg.num_layers} layers, {cfg.num_experts // ctx.world} of "
         f"{cfg.num_experts} experts a rank, {n_params / 1e9:.2f} B parameters on this rank, built in "
         f"{time.perf_counter() - t0:.1f} s; low_latency/fused crossover {model.ep_crossover_tokens()} tokens a rank")
    engine = Engine(model, backend="dist", max_len=MAX_LEN)
    ar_engine = Engine(model, backend="dist_ar", max_len=MAX_LEN)
    tgen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (1, n), generator=tgen, device=dev)

    warm = engine.alloc_slots(4)
    tok, warm = engine.prefill_into_slot(warm, 0, prompt(400))
    engine.decode_steps(warm, torch.stack([tok] * 4), torch.tensor([2, 0, 0, 0]), 2)
    del warm
    prompts = [prompt(n) for n in W4_PROMPTS]
    cache = engine.alloc_slots(len(prompts))
    ar_cache = ar_engine.alloc_slots(1)
    torch.cuda.synchronize()
    ctx.host_barrier()
    reset_launch_counts()
    ttft, tokens0 = [], []
    for slot, ids in enumerate(prompts):
        t0 = time.perf_counter()
        tok, cache = engine.prefill_into_slot(cache, slot, ids)
        tokens0.append(int(tok))
        ttft.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, last, cache, rem = engine.decode_steps(
        cache, torch.tensor(tokens0, dtype=torch.int32), torch.full((4,), steps), steps)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / steps
    ar_ids = prompts[W4_PROMPTS.index(EP_AR_PROMPT)]
    t0 = time.perf_counter()
    ar_tok, _ = ar_engine.prefill_into_slot(ar_cache, 0, ar_ids)
    ar_ttft = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()

    want = expected_ep_world4(cfg, ctx.world, list(W4_PROMPTS), [EP_AR_PROMPT], steps, len(prompts))
    if launches != want:
        raise AssertionError(f"EP world 4: launches on the served path {launches}, expected {want}")
    if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"EP world 4 decode_steps produced tokens outside the vocabulary: {out.tolist()}")
    want_len = [n + steps for n in W4_PROMPTS]
    if cache.lengths.tolist() != want_len or rem.tolist() != [0] * 4:
        raise AssertionError(f"EP world 4 slot lengths {cache.lengths.tolist()} != {want_len}")
    hidden = model.decode_hidden(last, cache.k, cache.v, cache.lengths)
    if not bool(torch.isfinite(hidden).all()):
        raise AssertionError("EP world 4: non-finite hidden states")
    if not _same_on_every_rank(ctx, hidden):
        raise AssertionError("EP world 4: the ranks' decode hidden states differ")
    if not _same_on_every_rank(ctx, torch.cat([out.flatten(), torch.tensor(tokens0 + [int(ar_tok)], device=dev)])):
        raise AssertionError("EP world 4: the ranks sampled different tokens")
    ctx.check_status()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    rlog(ctx, f"{EP_PRESET} EP world 4 [dist] TTFT " + ", ".join(
        f"prompt {n}: {t:.2f} ms" for n, t in zip(W4_PROMPTS, ttft))
        + f"; [dist_ar] prompt {EP_AR_PROMPT}: {ar_ttft:.2f} ms (first token {int(ar_tok)}, dist gave "
        f"{tokens0[W4_PROMPTS.index(EP_AR_PROMPT)]})")
    rlog(ctx, f"{EP_PRESET} EP world 4 [dist] decode_steps B=4, {steps} steps: {decode_ms:.2f} ms/step "
         f"({4 * 1e3 / decode_ms:.1f} tokens/s); peak device memory {peak:.2f} GiB on this rank")
    rlog(ctx, f"{EP_PRESET} EP world 4 launches ({len(W4_PROMPTS)} dist prefills, 1 dist_ar prefill, {steps} "
         f"steps): { {k: v for k, v in launches.items() if v} }, as predicted; equal on every rank")
    for label, fn, n_steps, unprofiled in (
            ("decode_steps B=4", lambda: engine.decode_steps(cache, last, torch.full((4,), 2), 2), 2, decode_ms),
            (f"prefill {W4_PROMPTS[2]} tokens", lambda: model.prefill(prompts[2]), 1, ttft[2])):
        ctx.host_barrier()
        wall, busy, families, n_kernels = profile_window(fn)
        if busy is None:
            rlog(ctx, f"EP world 4 profile {label}: device time not measured (no CUDA kernels recorded)")
            continue
        shares = ", ".join(f"{k} {v / n_steps:.3f} ms" for k, v in sorted(families.items(), key=lambda kv: -kv[1]))
        rlog(ctx, f"EP world 4 profile {label}: profiled wall {wall / n_steps:.2f} ms/step, device busy "
             f"{busy / n_steps:.3f} ms/step ({100 * busy / wall:.1f} %; unprofiled {unprofiled:.2f} ms/step), "
             f"{n_kernels / n_steps:.0f} kernels/step; by family: {shares}")
    return launches


# ------------------------------------------ 5g. training at world 4

def _tp_mlp_loss(ctx, x, ln, w_gu, w_down):
    """Tutorial 09's Megatron MLP on this rank's rows: RMSNorm (replicated
    weight) → ``ag_gemm_fn`` on [gate | up] → SwiGLU → ``gemm_rs_fn`` on down;
    this rank's share of the mean of out²."""
    import torch.nn.functional as F

    from triton_dist_tpu_torch.function import ag_gemm_fn, gemm_rs_fn
    from triton_dist_tpu_torch.kernels.norm_rope import rmsnorm

    ff = w_down.shape[0]
    gu = ag_gemm_fn(ctx, rmsnorm(x, ln, 1e-6), w_gu)
    a = (F.silu(gu[:, :ff].float()) * gu[:, ff:].float()).to(x.dtype)
    out = gemm_rs_fn(ctx, a, w_down)
    return (out.float() ** 2).sum() / (ctx.world * out.numel())


def _attn_block_loss(ctx, x, wqkv, wo, heads, attention):
    """One attention block on this rank's sequence shard: wqkv and wo
    replicated, RoPE at global positions, causal ``attention`` (the
    differentiable ``ring_attention_fn`` or ``ag_attention_fn``); this
    rank's share of the mean of out²."""
    import torch

    from triton_dist_tpu_torch.kernels.norm_rope import apply_rope

    hq, hkv, hd = heads
    s_loc = x.shape[0]
    pos = (torch.arange(s_loc, device=x.device) + ctx.rank * s_loc)[None]
    qkv = torch.matmul(x.float(), wqkv.float()).to(x.dtype).reshape(1, s_loc, hq + 2 * hkv, hd)
    q = apply_rope(qkv[:, :, :hq].transpose(1, 2), pos)
    k = apply_rope(qkv[:, :, hq:hq + hkv].transpose(1, 2), pos)
    o = attention(ctx, q, k, qkv[:, :, hq + hkv:].transpose(1, 2))
    out = torch.matmul(o.transpose(1, 2).reshape(s_loc, hq * hd).float(), wo.float())
    return (out ** 2).sum() / (ctx.world * out.numel())


def _ep_loss(ctx, x, w_router, wg, wu, wd, top_k):
    """``ep_moe_fused_fn`` on this rank's tokens (row 25 both ways, row 8);
    this rank's share of the mean of out²."""
    from triton_dist_tpu_torch.function import ep_moe_fused_fn

    out = ep_moe_fused_fn(ctx, x, w_router, wg, wu, wd, num_experts=ctx.world * wg.shape[0], top_k=top_k,
                          use_pallas_a2a=True)
    return (out.float() ** 2).sum() / (ctx.world * out.numel())


def _train_parts(ctx, dtype, small: bool):
    """The four world-4 training workloads as (label, loss_fn(ctx,
    *params), params on ``ctx``'s card, replicated flags): full width in
    bf16, or ``small`` (fp32) for the card-vs-CPU check. Replicated tensors
    come from one seed on every rank, sharded ones from a seed of the
    rank."""
    import functools

    import torch

    from triton_dist_tpu_torch.function import ag_attention_fn, ring_attention_fn
    from triton_dist_tpu_torch.models import PRESETS

    me, w = ctx.rank, ctx.world
    c8, cm = PRESETS["qwen3-8b"], PRESETS[EP_PRESET]

    dev = ctx.device

    def randn(seed, *shape, scale=1.0):
        g = torch.Generator(device=dev).manual_seed(SEED + seed)
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    if small:
        d, ff, m, heads, s_loc, s_ag = 256, 512, 96, (4, 2, 64), 64, 64
        de, e, ffe, t, top_k = 64, 8, 48, 16, 2
    else:
        d, ff, m, heads, s_loc, s_ag = c8.hidden_size, c8.intermediate_size, TRAIN_MLP_TOKENS, (
            c8.num_q_heads, c8.num_kv_heads, c8.head_dim), TRAIN_RING_TOKENS, SP_AG_TOKENS
        de, e, ffe, t, top_k = cm.hidden_size, cm.num_experts, cm.moe_intermediate_size, TRAIN_EP_TOKENS, cm.top_k
    hq, hkv, hd = heads
    fl = ff // w
    mlp = ("tp-mlp", _tp_mlp_loss,
           [randn(700 + me, m, d), torch.ones(d, dtype=dtype, device=dev),
            randn(710 + me, d, 2 * fl, scale=d ** -0.5), randn(720 + me, fl, d, scale=ff ** -0.5)],
           [False, True, False, False])
    ring = ("ring-attention", functools.partial(_attn_block_loss, heads=heads, attention=ring_attention_fn),
            [randn(730 + me, s_loc, d), randn(740, d, (hq + 2 * hkv) * hd, scale=d ** -0.5),
             randn(750, hq * hd, d, scale=(hq * hd) ** -0.5)],
            [False, True, True])
    ag = ("ag-attention", functools.partial(_attn_block_loss, heads=heads, attention=ag_attention_fn),
          [randn(810 + me, s_ag, d), randn(740, d, (hq + 2 * hkv) * hd, scale=d ** -0.5),
           randn(750, hq * hd, d, scale=(hq * hd) ** -0.5)],
          [False, True, True])
    el = e // w
    ep = ("ep-moe", functools.partial(_ep_loss, top_k=top_k),
          [randn(760 + me, t, de), randn(770, de, e, scale=de ** -0.5), randn(780 + me, el, de, ffe, scale=de ** -0.5),
           randn(790 + me, el, de, ffe, scale=de ** -0.5), randn(800 + me, el, ffe, de, scale=ffe ** -0.5)],
          [False, True, False, False, False])
    return [mlp, ring, ep, ag]


def _grads_of(ctx, loss_fn, params, replicated):
    """One backward on this rank; replicated tensors' gradients summed over
    the ranks (``mesh.psum``, rank order)."""
    from triton_dist_tpu_torch.runtime import mesh

    loss = loss_fn(ctx, *params)
    loss.backward()
    for p, rep in zip(params, replicated):
        if rep:
            p.grad = mesh.psum(ctx, p.grad.contiguous())
    return loss


def _psum_calls(t) -> int:
    """Plain collectives one ``mesh.psum`` of a CUDA tensor like ``t`` makes
    (a tensor larger than the plain slot goes in pieces along dim 0)."""
    from triton_dist_tpu_torch.shmem.symm import PLAIN_BYTES

    nbytes = t.numel() * t.element_size()
    if nbytes <= PLAIN_BYTES or t.shape[0] < 2:
        return 1
    return -(-t.shape[0] // max(1, PLAIN_BYTES // (nbytes // t.shape[0])))


def expected_train_world4(world: int, label: str, params, replicated) -> dict[str, int]:
    """Launches of a 5g workload: ``TRAIN_STEPS_W4`` steps and one more
    forward. TP MLP a step: row 16 (gate/up) and row 17 (down) forward, row
    17 in gate/up's backward (down's backward takes the plain ring, as in
    JAX). Ring a step: one row 1 and one row 5 call (two launches) per ring
    step. EP a step: row 25 twice forward and twice backward, row 8 once. AG
    a step: row 27 forward, row 5 (two launches) backward. Every plain
    collective is two barriers: the rings of the MLP's backward (three
    gathers), the ring's KV shifts (2·(world - 1) each way), the AG
    backward's reduce-scatters of dk and dv (``mesh.psum_scatter``, two),
    the sums of the replicated gradients (in pieces of the plain slot), of
    the loss and, once, of the squared norms."""
    from triton_dist_tpu_torch.kernels import KERNELS

    n = TRAIN_STEPS_W4
    want = {name: 0 for name in KERNELS}
    grad_sums = sum(_psum_calls(p) for p, r in zip(params, replicated) if r)
    # plain collectives: per step (the forward's and backward's, the
    # gradient sums, the loss), then the squared norms once, then the last
    # forward's and its loss
    if label == "tp-mlp":
        want.update(ag_gemm_fused=n + 1, gemm_rs_fused=2 * n + 1)
        fwd, bwd = 0, 3
    elif label == "ring-attention":
        want.update(flash_attention=world * (n + 1), flash_attention_bwd=2 * world * n)
        fwd = bwd = 2 * (world - 1)
    elif label == "ag-attention":
        want.update(ag_attn_kernel=n + 1, flash_attention_bwd=2 * n)
        fwd, bwd = 0, 2
    else:
        want.update(all_to_all_kernel=4 * n + 2, group_gemm_swiglu=n + 1)
        fwd = bwd = 0
    want["barrier_all_on_device"] = 2 * (n * (fwd + bwd + grad_sums + 1) + 1 + fwd + 1)
    return want


def train_world4(ctx) -> dict[str, int]:
    """5g: four training workloads at world 4 in the rank processes (the TP
    MLP, the causal ring, the EP MoE, the attention block through
    ``ag_attention_fn``). First,
    each at a small size in fp32 on the card and on the CPU (the same ranks,
    ``ctx.on_cpu()``): gradients within ``FP32_LOGITS_TOL`` of their largest
    (``close_scaled``: the losses are means). Then each at
    full width in bf16 for ``TRAIN_STEPS_W4`` SGD steps: the total loss (the
    sum of the ranks') falls at every step, the replicated gradients are the
    same bits on every rank, and the launches, read around each run, equal
    ``expected_train_world4``."""
    import torch

    from triton_dist_tpu_torch.kernels import KERNELS, launch_counts, reset_launch_counts
    from triton_dist_tpu_torch.runtime import mesh

    cpu_ctx = ctx.on_cpu()
    for label, loss_fn, p_gpu, rep in _train_parts(ctx, torch.float32, True):
        p_cpu = [t.detach().cpu().requires_grad_() for t in p_gpu]
        p_gpu = [t.requires_grad_() for t in p_gpu]
        _grads_of(ctx, loss_fn, p_gpu, rep)
        _grads_of(cpu_ctx, loss_fn, p_cpu, rep)
        err = max(close_scaled(a.grad.cpu(), b.grad, FP32_LOGITS_TOL) for a, b in zip(p_gpu, p_cpu))
        rlog(ctx, f"5g parity fp32 {label} (small): gradients card vs CPU max|err| {err:.3e} of max|grad| "
             f"(tol {FP32_LOGITS_TOL})")
    total = {name: 0 for name in KERNELS}
    for label, loss_fn, params, rep in _train_parts(ctx, torch.bfloat16, False):
        params = [p.requires_grad_() for p in params]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(ctx.device)
        ctx.host_barrier()
        reset_launch_counts()
        losses, walls = [], []
        for i in range(TRAIN_STEPS_W4):
            t0 = time.perf_counter()
            loss = _grads_of(ctx, loss_fn, params, rep)
            if i == 0:
                rates = _sgd_rates(params, lambda sq: mesh.psum(ctx, sq))
                same = all(_same_on_every_rank(ctx, p.grad) for p, r in zip(params, rep) if r)
                if not same:
                    raise AssertionError(f"5g {label}: the replicated gradients differ between the ranks")
            losses.append(float(mesh.psum(ctx, loss.detach().reshape(1))))
            _sgd(params, rates)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with torch.no_grad():
            losses.append(float(mesh.psum(ctx, loss_fn(ctx, *params).detach().reshape(1))))
        launches = launch_counts()
        ctx.check_status()
        want = expected_train_world4(ctx.world, label, params, rep)
        if launches != want:
            raise AssertionError(f"5g {label}: launches {launches}, expected {want}")
        if not all(math.isfinite(x) for x in losses) or not all(a > b for a, b in zip(losses, losses[1:])):
            raise AssertionError(f"5g {label}: the total loss did not fall at every step: {losses}")
        rlog(ctx, f"5g {label} (bf16, {TRAIN_STEPS_W4} SGD steps): total loss "
             + " -> ".join(f"{x:.6e}" for x in losses) + f"; step wall ms {[round(x, 2) for x in walls]}; "
             f"replicated gradients the same bits on every rank; launches "
             f"{ {k: v for k, v in launches.items() if v} } as predicted; peak "
             f"{torch.cuda.max_memory_allocated(ctx.device) / 2**30:.2f} GiB")
        ctx.host_barrier()
        wall, busy, families, n_kernels = profile_window(lambda: _grads_of(ctx, loss_fn, params, rep))
        for p in params:
            p.grad = None
        rlog(ctx, f"5g {label} profile: one step (forward, backward, gradient sums) wall {wall:.2f} ms, "
             + ("device time not measured (no CUDA kernels recorded)" if busy is None else
                f"device busy {busy:.3f} ms ({100 * busy / wall:.1f} %), {n_kernels} kernels; by family: "
                + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(families.items(), key=lambda kv: -kv[1]))))
        for name in KERNELS:
            total[name] += launches[name]
        del params
    return total


# ------------------------------- 5i. sequence-parallel attention at world 4

def _seq_shard(ctx, seed: int, shape, dim: int, dtype, scale: float = 1.0):
    """This rank's block along ``dim`` of a tensor every rank draws whole
    from one seed, on the card."""
    import torch

    g = torch.Generator(device=ctx.device).manual_seed(SEED + seed)
    full = torch.randn(shape, generator=g, device=ctx.device) * scale
    n = shape[dim] // ctx.world
    return full.narrow(dim, ctx.rank * n, n).contiguous().to(dtype)


def _sp_small_parity(ctx) -> None:
    """5i, small fp32 (Hq 4, Hkv 2, D 64, S_local 64; Ulysses Hq 8, Hkv 4):
    every sequence-parallel layer and function on the card against the CPU
    (``ctx.on_cpu()``, the plain versions over gloo) inside the same ranks,
    within ``FP32_LOGITS_TOL``: ``AGSPAttn`` on both routes (row 27, the
    ring), ``RingSPAttn`` causal and packed, ``UlyssesSPAttn`` on both
    transports, the four fused Ulysses GEMM-all-to-all functions and
    ``ag_attention_fn``'s gradients."""
    import torch

    from triton_dist_tpu_torch.function import ag_attention_fn
    from triton_dist_tpu_torch.kernels import sp as ksp
    from triton_dist_tpu_torch.layers import AGSPAttn, RingSPAttn, UlyssesSPAttn

    w, cpu, f32 = ctx.world, ctx.on_cpu(), torch.float32
    b, hq, hkv, s_loc, d = 1, 4, 2, 64, 64
    s = w * s_loc
    q, k, v = (_seq_shard(ctx, 900 + i, (b, h, s, d), 2, f32) for i, h in enumerate((hq, hkv, hkv)))
    qu, ku, vu = (_seq_shard(ctx, 903 + i, (b, s, h, d), 1, f32) for i, h in enumerate((8, 4, 4)))
    cu = (0, 100, 180, 250)  # three documents over the 256-token stream, 6 padding rows
    dm, m, kd, n = 256, 32, 64, 96
    gen = torch.Generator(device=ctx.device).manual_seed(SEED + 906)  # the same draws on every rank

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=ctx.device)

    x, wg = rnd(w, m, kd)[ctx.rank].contiguous(), rnd(kd, n)
    chunks, w2 = rnd(w, w, m, kd // w)[ctx.rank].contiguous(), rnd(kd, n)
    x3, wqkv = _seq_shard(ctx, 907, (b, s, dm), 1, f32), rnd(dm, 16 * d) * dm ** -0.5
    o_h, wo = rnd(w, b, s, 2, d)[ctx.rank].contiguous(), rnd(8 * d, dm) * (8 * d) ** -0.5
    cases = {
        "AGSPAttn (row 27)": lambda c, t: AGSPAttn(c)(*t[:3]),
        "AGSPAttn vmem_limit_mb=0 (the ring)": lambda c, t: AGSPAttn(c, vmem_limit_mb=0)(*t[:3]),
        "RingSPAttn causal": lambda c, t: RingSPAttn(c)(*t[:3]),
        "RingSPAttn packed": lambda c, t: RingSPAttn(c)(*t[:3], cu_seqlens=cu),
        "UlyssesSPAttn row 25": lambda c, t: UlyssesSPAttn(c, use_pallas_a2a=True)(*t[3:6]),
        "UlyssesSPAttn plain a2a": lambda c, t: UlyssesSPAttn(c)(*t[3:6]),
        "gemm_a2a_shard": lambda c, t: ksp.gemm_a2a_shard(c, t[6], t[7]),
        "a2a_gemm_shard": lambda c, t: ksp.a2a_gemm_shard(c, t[8], t[9]),
        "ulysses_qkv_gemm_a2a_shard": lambda c, t: torch.cat([y.flatten() for y in ksp.ulysses_qkv_gemm_a2a_shard(
            c, t[10], t[11], num_q_heads=8, num_kv_heads=4, head_dim=d)]),
        "ulysses_o_a2a_gemm_shard": lambda c, t: ksp.ulysses_o_a2a_gemm_shard(c, t[12], t[13]),
    }
    ins = (q, k, v, qu, ku, vu, x, wg, chunks, w2, x3, wqkv, o_h, wo)
    ins_cpu = tuple(t.cpu() for t in ins)
    errs = {}
    for label, f in cases.items():
        errs[label] = close(f(ctx, ins).cpu(), f(cpu, ins_cpu), FP32_LOGITS_TOL, FP32_LOGITS_TOL)
    c = rnd(b, hq, s_loc, d)
    grads = []
    for cx, leaves in ((ctx, (q, k, v)), (cpu, ins_cpu[:3])):
        leaves = [t.clone().requires_grad_() for t in leaves]
        (ag_attention_fn(cx, *leaves) * c.to(leaves[0].device)).sum().backward()
        grads.append([t.grad for t in leaves])
    errs["ag_attention_fn gradients (of max|grad|)"] = max(
        close_scaled(a.cpu(), b_, FP32_LOGITS_TOL) for a, b_ in zip(*grads))
    ctx.check_status()
    rlog(ctx, "5i parity fp32 (small), card vs CPU, max|err| (tol " + f"{FP32_LOGITS_TOL}): "
         + "; ".join(f"{k} {v_:.3e}" for k, v_ in errs.items()))


def expected_sp_world4(world: int) -> dict[str, dict[str, int]]:
    """Launches of each 5i layer call at full width. ``AGSPAttn`` at S_local
    384: row 27 once. The ring (``AGSPAttn`` at 1024, ``RingSPAttn``): row 1
    (row 4 packed) once a ring step, and two barriers for each of the
    2·(world - 1) KV shifts (``mesh.ppermute``, a plain collective).
    Ulysses: row 25 for q, k, v and the output, row 1 once. The fused
    projections: world - 1 shifts each."""
    ring = {"barrier_all_on_device": 4 * (world - 1)}
    return {
        f"AGSPAttn S_local {SP_AG_TOKENS}": {"ag_attn_kernel": 1},
        f"AGSPAttn S_local {SP_RING_TOKENS}": {"flash_attention": world, **ring},
        "RingSPAttn causal": {"flash_attention": world, **ring},
        "RingSPAttn packed": {"flash_attention_varlen": world, **ring},
        "UlyssesSPAttn row 25": {"all_to_all_kernel": 4, "flash_attention": 1},
        "ulysses_qkv_gemm_a2a_shard": {"barrier_all_on_device": 2 * (world - 1)},
        "ulysses_o_a2a_gemm_shard": {"barrier_all_on_device": 2 * (world - 1)},
    }


def sp_world4(ctx, flush_buf, nccl) -> tuple[dict[str, dict], dict[str, int]]:
    """5i: sequence-parallel attention at world 4. First the small fp32
    card-vs-CPU check (``_sp_small_parity``). Then at Qwen3-8B's attention
    width in bf16 (B 1): each layer call's output held against row 1 over
    the gathered whole sequence (row 4 for the packed ring; the plain
    all-gather and fp32 products for the projections) within ``1e-2 +
    2e-2·|ref|``, its launches, read around the call alone, equal to
    ``expected_sp_world4``, and one profile line each. Last, row 27 as a
    kernel entry at S_local 384 with residuals: against
    ``ag_attention_reference`` (o and lse within tolerance, k_full and v_full
    bitwise), timed beside its plain version, its bound and, with a card a
    rank, a separate NCCL group's ``all_gather_into_tensor`` of K and V plus
    SDPA under the rank's causal mask. Returns the entry and the sum of the
    layer calls' launches."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from triton_dist_tpu_torch.kernels import KERNELS, launch_counts, reset_launch_counts
    from triton_dist_tpu_torch.kernels import sp as ksp
    from triton_dist_tpu_torch.kernels.ag_attention import (
        ag_attention_cost,
        ag_attention_reference,
        ag_attention_supported,
        ag_attn_kernel,
    )
    from triton_dist_tpu_torch.kernels.flash_attn import flash_attention, flash_attention_varlen
    from triton_dist_tpu_torch.kernels.group_gemm import matmul_f32
    from triton_dist_tpu_torch.layers import AGSPAttn, RingSPAttn, UlyssesSPAttn
    from triton_dist_tpu_torch.models import PRESETS
    from triton_dist_tpu_torch.runtime import mesh

    _sp_small_parity(ctx)
    cfg = PRESETS["qwen3-8b"]
    w, me, bf = ctx.world, ctx.rank, torch.bfloat16
    hq, hkv, d, dm = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
    for s_loc, fits in ((SP_AG_TOKENS, True), (SP_RING_TOKENS, False), (SP_AG_TOKENS + 64, False)):
        if ag_attention_supported(w, 1, hq, hkv, s_loc, d, 2, with_residuals=True) != fits:
            raise AssertionError(f"5i: JAX's plan check at S_local {s_loc}: expected fits={fits}")

    def qkv_shards(seed, s_loc, layout="bhsd"):
        s = w * s_loc
        if layout == "bhsd":
            return tuple(_seq_shard(ctx, seed + i, (1, h, s, d), 2, bf) for i, h in enumerate((hq, hkv, hkv)))
        return tuple(_seq_shard(ctx, seed + i, (1, s, h, d), 1, bf) for i, h in enumerate((hq, hkv, hkv)))

    def row1_over_gathered(q, k, v):
        kf, vf = mesh.all_gather(ctx, k, dim=2), mesh.all_gather(ctx, v, dim=2)
        return flash_attention(q, kf, vf, causal=True, q_offset=me * q.shape[2], kv_offset=0)

    want_all = expected_sp_world4(w)
    total = {name: 0 for name in KERNELS}

    def run(label, call, reference, against="row 1 over the gathered sequence"):
        torch.cuda.synchronize()
        ctx.host_barrier()
        reset_launch_counts()
        got = call()
        torch.cuda.synchronize()
        launches = {k_: v_ for k_, v_ in launch_counts().items() if v_}
        if launches != want_all[label]:
            raise AssertionError(f"5i {label}: launches {launches}, expected {want_all[label]}")
        for name, n in launches.items():
            total[name] += n
        err = close(got, reference(), BF16_ATOL, BF16_RTOL)
        for _ in range(2):  # the profiler now and then records no kernel of a window: every rank once more
            ctx.host_barrier()
            wall, busy, families, n_kernels = profile_window(call)
            missed = [None] * w
            dist.all_gather_object(missed, busy is None, group=ctx.group)
            if not any(missed):
                break
        rlog(ctx, f"5i {label} (qwen3-8b attention, bf16): max|err| {err:.3e} against {against}; launches "
             f"{launches} as predicted; profile: wall {wall:.2f} ms, "
             + ("device time not measured (no CUDA kernels recorded)" if busy is None else
                f"device busy {busy:.3f} ms ({100 * busy / wall:.1f} %), {n_kernels} kernels; by family: "
                + ", ".join(f"{k_} {v_:.3f} ms" for k_, v_ in sorted(families.items(), key=lambda kv: -kv[1]))))

    ag_in = qkv_shards(910, SP_AG_TOKENS)
    run(f"AGSPAttn S_local {SP_AG_TOKENS}", lambda: AGSPAttn(ctx)(*ag_in), lambda: row1_over_gathered(*ag_in))
    ring_in = qkv_shards(920, SP_RING_TOKENS)
    run(f"AGSPAttn S_local {SP_RING_TOKENS}", lambda: AGSPAttn(ctx)(*ring_in), lambda: row1_over_gathered(*ring_in))
    run("RingSPAttn causal", lambda: RingSPAttn(ctx)(*ring_in), lambda: row1_over_gathered(*ring_in))

    def packed_reference():
        qf, kf, vf = (mesh.all_gather(ctx, t, dim=2)[0] for t in ring_in)
        rows = slice(me * SP_RING_TOKENS, (me + 1) * SP_RING_TOKENS)
        return flash_attention_varlen(qf, kf, vf, list(TRAIN_CU))[:, rows][None]

    run("RingSPAttn packed", lambda: RingSPAttn(ctx)(*ring_in, cu_seqlens=list(TRAIN_CU)), packed_reference,
        "row 4 over the gathered packed sequence")
    uly_in = qkv_shards(930, SP_RING_TOKENS, layout="bshd")

    def ulysses_reference():
        qf, kf, vf = (mesh.all_gather(ctx, t, dim=1).transpose(1, 2).contiguous() for t in uly_in)
        rows = slice(me * SP_RING_TOKENS, (me + 1) * SP_RING_TOKENS)
        return flash_attention(qf, kf, vf, causal=True)[:, :, rows].transpose(1, 2)

    run("UlyssesSPAttn row 25", lambda: UlyssesSPAttn(ctx, use_pallas_a2a=True)(*uly_in), ulysses_reference)
    # The fused projections on Qwen3-8B's shapes, wqkv and wo group-major.
    hq_l, hkv_l = hq // w, hkv // w
    cols = (hq_l + 2 * hkv_l) * d
    gen = torch.Generator(device=ctx.device).manual_seed(SEED + 940)  # the same draws on every rank
    wqkv = (torch.randn((dm, w * cols), generator=gen, device=ctx.device) * dm ** -0.5).to(bf)
    wo = (torch.randn((hq * d, dm), generator=gen, device=ctx.device) * (hq * d) ** -0.5).to(bf)
    x = _seq_shard(ctx, 941, (1, w * SP_RING_TOKENS, dm), 1, bf)

    def qkv_call():
        return torch.cat([t.flatten() for t in ksp.ulysses_qkv_gemm_a2a_shard(
            ctx, x, wqkv, num_q_heads=hq, num_kv_heads=hkv, head_dim=d)])

    def qkv_reference():
        xf = mesh.all_gather(ctx, x, dim=1)[0]
        y = matmul_f32(xf, wqkv[:, me * cols:(me + 1) * cols]).to(bf).reshape(1, -1, hq_l + 2 * hkv_l, d)
        return torch.cat([t.flatten() for t in (y[:, :, :hq_l], y[:, :, hq_l:hq_l + hkv_l], y[:, :, hq_l + hkv_l:])])

    run("ulysses_qkv_gemm_a2a_shard", qkv_call, qkv_reference, "the gathered x times wqkv's group (fp32)")
    o_h = _seq_shard(ctx, 942, (1, w * SP_RING_TOKENS, hq, d), 2, bf)  # this rank's head group, whole sequence

    def o_reference():
        o_all = mesh.all_gather(ctx, o_h, dim=2)[:, me * SP_RING_TOKENS:(me + 1) * SP_RING_TOKENS]
        return matmul_f32(o_all.reshape(SP_RING_TOKENS, hq * d), wo).to(bf)[None]

    run("ulysses_o_a2a_gemm_shard", lambda: ksp.ulysses_o_a2a_gemm_shard(ctx, o_h, wo), o_reference,
        "the gathered heads of this rank's rows times wo (fp32)")

    # Row 27 as a kernel entry.
    q, k, v = ag_in
    got = ag_attn_kernel(ctx, q, k, v, causal=True, return_residuals=True)
    want = ag_attention_reference(ctx, q, k, v, causal=True, return_residuals=True)
    torch.cuda.synchronize()
    err = close(got[0], want[0], BF16_ATOL, BF16_RTOL)
    lse_err = close(got[1][0], want[1][0], LSE_ATOL, 0.0)
    if not (torch.equal(got[1][1], want[1][1]) and torch.equal(got[1][2], want[1][2])):
        raise AssertionError("ag_attn_kernel: k_full, v_full differ from the plain all-gather")
    rlog(ctx, f"ag_attn_kernel S_local {SP_AG_TOKENS} (Hq {hq}, Hkv {hkv}, D {d}, causal, residuals): max|err| o "
         f"{err:.3e}, lse {lse_err:.3e}; k_full, v_full bitwise equal to the plain all-gather")
    keys = torch.arange(w * SP_AG_TOKENS, device=ctx.device)
    mask = keys[None, :] <= me * SP_AG_TOKENS + torch.arange(SP_AG_TOKENS, device=ctx.device)[:, None]

    def library():
        kv = []
        for t in (k, v):
            out = torch.empty((w, *t.shape[1:]), dtype=t.dtype, device=t.device)
            dist.all_gather_into_tensor(out, t, group=nccl)
            kv.append(out.transpose(0, 1).reshape(1, hkv, w * SP_AG_TOKENS, d))
        return F.scaled_dot_product_attention(q, *kv, attn_mask=mask, enable_gqa=True)

    entry = timed_entry(
        ctx, flush_buf, "ag_attn_kernel", "triton_dist_tpu_torch/csrc/ag_attention.cu",
        "triton_dist_tpu/kernels/ag_attention.py:48",
        lambda: ag_attn_kernel(ctx, q, k, v, causal=True, return_residuals=True),
        lambda: ag_attention_reference(ctx, q, k, v, causal=True, return_residuals=True),
        library if nccl is not None else None, ag_attention_cost(q, k, w, me, return_residuals=True),
        library_name="NCCL all_gather_into_tensor of K and V + SDPA")
    entry["max_abs_err"] = err
    ctx.check_status()
    return {"ag_attn_kernel": entry}, total


def _rank_main(rank: int, port: int, results, alone: str | None = None) -> None:
    """One rank of phase 5, in its own process: 5a-5h, 5i, 5g, then the abort
    tests (with ``alone``, "quant" or "sp": 5a-q or 5i alone). Any failure reaches the parent as an
    error and a nonzero exit."""
    import traceback

    try:
        import torch
        import torch.distributed as dist

        sys.path.insert(0, ROOT)
        from triton_dist_tpu_torch.runtime.mesh import initialize_distributed

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_num_threads(2)
        ctx = initialize_distributed(rank, WORLD, f"tcp://localhost:{port}")
        shared = torch.cuda.device_count() < WORLD
        rlog(ctx, f"card cuda:{ctx.device.index} of {torch.cuda.device_count()} "
             f"({'shared by the ranks' if shared else 'its own'})")
        nccl = None if shared else dist.new_group(backend="nccl")  # the yardstick's; the port never uses it
        flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=ctx.device)
        steps = EP_STEPS_SHARED if shared else EP_STEPS_OWN
        if alone is not None:
            if alone == "quant":
                entries = check_quant_collective_kernels(ctx, flush_buf, nccl)
                results.put((rank, "ok", {"entries": entries, "quant_op_launches": quant_host_ops(ctx)}))
            else:
                entries, sp_launches = sp_world4(ctx, flush_buf, nccl)
                results.put((rank, "ok", {"entries": entries, "sp_launches": sp_launches}))
            ctx.heap.close()
            dist.destroy_process_group()
            return
        t0 = time.perf_counter()
        entries = check_collective_kernels(ctx, flush_buf, nccl)
        rlog(ctx, f"5a (rows 16-19 and the barrier vs plain, timed): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        entries.update(check_quant_collective_kernels(ctx, flush_buf, nccl))
        quant_op_launches = quant_host_ops(ctx)
        rlog(ctx, f"5a-q (rows 16q-19q vs plain, timed; their entry points): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        entries.update(check_standalone_collectives(ctx, flush_buf, nccl))
        host_op_launches = standalone_host_ops(ctx)
        rlog(ctx, f"5a' (rows 20-22 vs plain, timed; the host ops): {time.perf_counter() - t0:.1f} s")
        del flush_buf
        t0 = time.perf_counter()
        parity_world4(ctx)
        rlog(ctx, f"5b (fp32 parity world 4, CUDA vs CPU): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        parity_tp_world4(ctx)
        rlog(ctx, f"5b' (fp32 parity world 4, mega and TP_MoE, CUDA vs CPU): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches, mega_launches = serve_world4(ctx, steps)
        rlog(ctx, f"5c, 5c' (qwen3-8b world 4, dist and mega): {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()  # 5c's model is gone before the EP phase loads
        t0 = time.perf_counter()
        flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=ctx.device)
        entries.update(check_ep_kernels(ctx, flush_buf, nccl))
        del flush_buf
        gc.collect()
        torch.cuda.empty_cache()
        rlog(ctx, f"5d (rows 25 and 26 vs plain, timed): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        parity_ep_world4(ctx)
        rlog(ctx, f"5e (fp32 EP parity world 4, CUDA vs CPU): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ep_launches = serve_ep_world4(ctx, steps)
        rlog(ctx, f"5f ({EP_PRESET} EP world 4): {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()  # 5f's model is gone before 5h loads
        t0 = time.perf_counter()
        tp_moe_launches, tp_moe_mega_launches = serve_tp_moe_world4(ctx, steps)
        rlog(ctx, f"5h ({TP_MOE_PRESET} TP_MoE world 4, dist and mega): {time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()  # 5h's model is gone before the training phase
        t0 = time.perf_counter()
        flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=ctx.device)
        sp_entries, sp_launches = sp_world4(ctx, flush_buf, nccl)
        entries.update(sp_entries)
        del flush_buf
        rlog(ctx, f"5i (sequence-parallel attention at world 4): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        train_launches = train_world4(ctx)
        rlog(ctx, f"5g (training at world 4): {time.perf_counter() - t0:.1f} s")
        ctx.host_barrier()
        abort_world4(ctx)
        ctx.host_barrier()
        results.put((rank, "ok", {"entries": entries, "launches": launches, "mega_launches": mega_launches,
                                  "host_op_launches": host_op_launches, "quant_op_launches": quant_op_launches,
                                  "ep_launches": ep_launches,
                                  "tp_moe_launches": tp_moe_launches, "tp_moe_mega_launches": tp_moe_mega_launches,
                                  "sp_launches": sp_launches, "train_launches": train_launches}))
        ctx.heap.close()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails the run
        log(f"[rank {rank}] failed:\n{traceback.format_exc()}")
        results.put((rank, "error", traceback.format_exc()))
        sys.stdout.flush()
        time.sleep(1)  # let the queue's feeder thread hand the error over
        os._exit(1)


def run_world4(timeout_s: float, alone: str | None = None) -> tuple[dict[str, dict], list[dict[str, int]]]:
    """Phase 5: four rank processes, rank r on card ``r % device_count``
    (the kernels are built already). Returns rank 0's kernel entries (the
    max |error| over the ranks) and the launch counts of its runs (5c, 5c',
    the host ops of 5a' and 5a-q, 5f, 5h on dist and on mega, 5i, 5g; with
    ``alone``, 5a-q's or 5i's alone). Raises if any rank fails or the phase
    outlives ``timeout_s``."""
    import multiprocessing as mp
    import queue
    import socket

    import torch

    shared = torch.cuda.device_count() < WORLD
    log(f"phase 5: {WORLD} ranks on {torch.cuda.device_count()} card(s): "
        + ", ".join(f"rank {r} -> cuda:{r % torch.cuda.device_count()}" for r in range(WORLD))
        + ("; the ranks share a card, which runs their contexts in turns" if shared else ""))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    spawn = mp.get_context("spawn")
    results = spawn.Queue()
    procs = [spawn.Process(target=_rank_main, args=(r, port, results, alone)) for r in range(WORLD)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.perf_counter() + timeout_s
    try:
        while len(got) < WORLD:
            try:
                rank, status, value = results.get(timeout=5)
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead or time.perf_counter() > deadline:
                    raise RuntimeError(f"phase 5: ranks exited {[p.exitcode for p in procs]} "
                                       f"(timeout {timeout_s} s)") from None
                continue
            if status != "ok":
                raise RuntimeError(f"phase 5: rank {rank} failed:\n{value}")
            got[rank] = value
        for p in procs:
            p.join(timeout=120)
        if any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"phase 5: rank exit codes {[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    keys = ("launches", "mega_launches", "host_op_launches", "quant_op_launches", "ep_launches", "tp_moe_launches",
            "tp_moe_mega_launches", "sp_launches", "train_launches")
    if alone is not None:
        keys = ({"quant": "quant_op_launches", "sp": "sp_launches"}[alone],)
    for key in keys:
        if any(got[r][key] != got[0][key] for r in got):
            raise AssertionError(f"phase 5: the ranks' launch counts differ ({key})")
    entries = got[0]["entries"]
    for name, e in entries.items():
        e["max_abs_err"] = max(got[r]["entries"][name]["max_abs_err"] for r in got)
    return entries, [got[0][key] for key in keys]


# ------------------------------------------------ 6. training at world 1

def train_world1(dev) -> dict[str, int]:
    """Phase 6: Qwen3-8B's attention block as a training step at full width
    (bf16, random weights from one seed): embed → RMSNorm → wqkv → RoPE →
    ``flash_attention_fn`` → wo, loss mean(out²), ``TRAIN_STEPS`` SGD
    steps on wqkv and wo at B 1, S ``TRAIN_S``; then as many through
    ``flash_attention_varlen_fn`` on the packed batch ``TRAIN_CU``. The loss
    falls at every step (the last one read by one more forward); launch
    counts, read around the two runs, equal one row 1 (row 4) forward and
    two row 5 (row 6) launches a step plus the last forward."""
    import torch

    from triton_dist_tpu_torch.function.training import attention_block_loss
    from triton_dist_tpu_torch.kernels import KERNELS, launch_counts, reset_launch_counts
    from triton_dist_tpu_torch.models import PRESETS

    cfg = PRESETS["qwen3-8b"]
    hq, hkv, hd, dm = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)

    def randn(*shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    embed = randn(cfg.vocab_size, dm, scale=0.02)
    ln1 = torch.ones(dm, dtype=torch.bfloat16, device=dev)
    w0 = (randn(dm, (hq + 2 * hkv) * hd, scale=dm ** -0.5), randn(hq * hd, dm, scale=(hq * hd) ** -0.5))
    tokens = torch.randint(0, cfg.vocab_size, (1, TRAIN_S), generator=gen, device=dev)
    total = {name: 0 for name in KERNELS}
    for label, cu, fwd, bwd in (("dense", None, "flash_attention", "flash_attention_bwd"),
                                ("packed", list(TRAIN_CU), "flash_attention_varlen", "flash_attention_varlen_bwd")):
        params = [w.clone().requires_grad_() for w in w0]

        def step():
            loss = attention_block_loss(embed, ln1, *params, tokens, cfg, cu_seqlens=cu)
            loss.backward()
            return loss

        step()  # warm-up (cuBLAS, the allocator), outside the counted run
        for p in params:
            p.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        losses, walls = [], []
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            loss = step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            rates = _sgd_rates(params) if i == 0 else rates
            losses.append(float(loss.detach()))
            _sgd(params, rates)
        with torch.no_grad():
            losses.append(float(attention_block_loss(embed, ln1, *params, tokens, cfg, cu_seqlens=cu)))
        launches = launch_counts()
        want = {name: 0 for name in KERNELS}
        want[fwd], want[bwd] = TRAIN_STEPS + 1, 2 * TRAIN_STEPS
        if launches != want:
            raise AssertionError(f"training {label}: launches {launches}, expected {want}")
        if not all(math.isfinite(x) for x in losses) or not all(a > b for a, b in zip(losses, losses[1:])):
            raise AssertionError(f"training {label}: the loss did not fall at every step: {losses}")
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        wall, busy, families, n_kernels = profile_window(step)
        for p in params:
            p.grad = None
        busy_txt = ("device time not measured (no CUDA kernels recorded)" if busy is None else
                    f"device busy {busy:.3f} ms ({100 * busy / wall:.1f} %), {n_kernels} kernels; by family: "
                    + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(families.items(), key=lambda kv: -kv[1])))
        log(f"training world 1 {label} (qwen3-8b attention block, B=1 S={TRAIN_S}"
            + (f" cu_seqlens {cu}" if cu else "") + f", bf16, SGD rates {rates}): loss "
            + " -> ".join(f"{x:.6e}" for x in losses) + f"; step wall ms {walls}; launches "
            f"{ {k: v for k, v in launches.items() if v} } as predicted; peak {peak:.2f} GiB")
        log(f"training world 1 {label} profile: one step wall {wall:.2f} ms, {busy_txt}")
        for name in KERNELS:
            total[name] += launches[name]
    return total


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

    alone = {"--quant-collectives": ("quant", QUANT_KERNELS), "--sequence-parallel": ("sp", SP_KERNELS)}
    if len(sys.argv) == 2 and sys.argv[1] in alone:
        # Phase 5a-q or 5i alone (at world 4): the four-card measurement,
        # which needs nothing else of the script.
        phase, names = alone[sys.argv[1]]
        entries, runs = run_world4(timeout_s=W4_TIMEOUT_S, alone=phase)
        print(json.dumps({"kernels": [dict(entries[name], launches=runs[0][name]) for name in names]}), flush=True)
        print(json.dumps({"ok": True, "device": device_report()}), flush=True)
        return 0
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > the 50 MB L2
    t_phase = time.perf_counter()
    entries = check_kernels(dev, flush_buf)
    entries.update(check_mega_kernels(dev, flush_buf))
    entries.update(check_paged_moe_kernels(dev, flush_buf))
    entries.update(check_quant_paged_kernel(dev, flush_buf))
    entries.update(check_training_kernels(dev, flush_buf))
    del flush_buf
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 2 (kernels vs plain, timed): {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    parity_fp32(dev)
    parity_grads_fp32(dev)
    log(f"phase 3 (fp32 parity, CUDA vs CPU): {time.perf_counter() - t_phase:.1f} s")

    # Qwen3-8B on the default backend, on mega and on mega through the pool:
    # one model object, the same requests; each run's counts are read around
    # that run alone.
    t_phase = time.perf_counter()
    model = build_full_width("qwen3-8b", DenseLLM, dev)
    runs = [serve_full_width(model, "qwen3-8b", "dist", dev, serve_rows=2, serve_prompt=128, serve_gen=16)]
    runs.append(serve_full_width(model, "qwen3-8b", "mega", dev, serve_rows=2, serve_prompt=128, serve_gen=16,
                                 profile_prefill=False))
    paged_launches, paged_engine, streams = serve_paged_full_width(model, "qwen3-8b", dev)
    runs.append(paged_launches)
    compare_first_step(model, dev, paged_engine)
    streams = {None: streams}
    for wire in QUANT_WIRES:  # item E: the same run through fp8 and int8 pools
        quant_launches, quant_engine, streams[wire] = serve_paged_full_width(model, "qwen3-8b", dev, quant=wire)
        runs.append(quant_launches)
        del quant_engine
    compare_quant_pools(model, "qwen3-8b", dev, paged_engine, streams)
    del model, paged_engine
    gc.collect()
    torch.cuda.empty_cache()
    log(f"qwen3-8b freed: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated; phase 4 qwen3-8b "
        f"{time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    model = build_full_width("qwen3-moe-30b-a3b", Qwen3MoE, dev)
    runs.append(serve_full_width(model, "qwen3-moe-30b-a3b", "dist", dev, serve_rows=8, serve_prompt=64,
                                 serve_gen=8))
    paged_launches, paged_engine, bf16_stream = serve_paged_full_width(model, "qwen3-moe-30b-a3b", dev)
    runs.append(paged_launches)
    quant_launches, quant_engine, fp8_stream = serve_paged_full_width(model, "qwen3-moe-30b-a3b", dev, quant="fp8")
    runs.append(quant_launches)
    del quant_engine
    compare_quant_pools(model, "qwen3-moe-30b-a3b", dev, paged_engine, {None: bf16_stream, "fp8": fp8_stream})
    del model, paged_engine
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 4 qwen3-moe-30b-a3b: {time.perf_counter() - t_phase:.1f} s")

    t_phase = time.perf_counter()
    w4_entries, w4_launches = run_world4(timeout_s=W4_TIMEOUT_S)
    entries.update(w4_entries)
    runs.extend(w4_launches)
    log(f"phase 5 (world 4): {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    runs.append(train_world1(dev))
    log(f"phase 6 (training at world 1): {time.perf_counter() - t_phase:.1f} s")

    # --------------------------------------------------------- 7. results
    kernels = []
    for name in ("flash_attention", *TRAIN_KERNELS, "flash_decode", "group_gemm_swiglu", *MEGA_KERNELS,
                 "paged_flash_decode", "paged_flash_decode_quant", "fused_moe_block", *COLLECTIVE_KERNELS,
                 *QUANT_KERNELS, *EP_KERNELS, *STANDALONE_KERNELS, *SP_KERNELS):
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

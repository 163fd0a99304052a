#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``triton_dist_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``triton_dist_tpu_torch/csrc`` and
then, on the card:

1. prints the card (``nvidia-smi`` name and power limit) and the build time;
2. holds each kernel against its plain PyTorch version at the shapes the
   served path gives it (bf16) and times kernel, plain version,
   ``scaled_dot_product_attention`` (the yardstick, never called by the
   port) and the card's bound for the same work;
3. serves a small fp32 model through ``Engine`` on CUDA and on the CPU
   (plain versions) and requires equal greedy tokens and close logits;
4. serves Qwen3-8B at full width and depth (36 layers, bf16, random
   weights from a seeded generator): four requests joined into four slots
   with ``prefill_into_slot`` and decoded together with ``decode_steps``,
   plus one batch-2 ``serve``, with the kernels' launch counts read around
   exactly that run;
5. prints one ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.

It exits nonzero and prints no result when CUDA is unavailable, when run
away from the repository, or when any phase fails.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): bf16 tensor cores
# and HBM3 bandwidth. The bound of a function is the larger of its FLOPs
# over the first and its bytes over the second.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# bf16 kernel vs plain version: both accumulate in fp32, but the kernel
# rounds P to bf16 against a running row max and sums in another order, and
# the output is rounded to bf16 (8 significant bits). |err| must stay within
# ATOL + RTOL·|plain|.
BF16_ATOL, BF16_RTOL = 1e-2, 2e-2
LSE_ATOL = 1e-3  # fp32 LSE from the same bf16 products, another summation order
# fp32 parity (phase 3): the same fp32 math on the card and on the CPU,
# summed in another order.
FP32_LOGITS_TOL = 5e-4

FLASH_PROMPTS = (96, 384, 777, 1500)
DECODE_STEPS = 32
MAX_LEN = 2048
SEED = 20261016


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def _family(kernel_name: str) -> str:
    if "flash_fwd" in kernel_name:
        return "flash_attention"
    if "flash_decode" in kernel_name:
        return "flash_decode"
    if any(w in kernel_name.lower() for w in ("gemm", "xmma", "cutlass", "nvjet", "sm90_")):
        return "matmul"
    return "other"


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
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, families = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no card, no run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch.nn.functional as F

    from triton_dist_tpu_torch.kernels import (
        _build,
        attention_reference,
        decode_reference,
        flash_attention,
        flash_decode,
        launch_counts,
        reset_launch_counts,
    )
    from triton_dist_tpu_torch.kernels.flash_attn import attention_bytes, attention_flops
    from triton_dist_tpu_torch.kernels.flash_decode import decode_bytes, decode_flops
    from triton_dist_tpu_torch.models import PRESETS, DenseLLM, DenseParams, Engine, ModelConfig, init_params
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

    def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
        """Median of per-launch CUDA-event times, L2 flushed before each."""
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
        err = (got.float() - want.float()).abs()
        bad = err > atol + rtol * want.float().abs()
        if bool(bad.any()) or not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"mismatch: max |err| {err.max().item():.3e}, "
                                 f"{int(bad.sum())} elements out of tolerance")
        return err.max().item()

    # ------------------------------------------- 2. kernels vs plain versions
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)

    cfg8b = PRESETS["qwen3-8b"]
    hq, hkv, d = cfg8b.num_q_heads, cfg8b.num_kv_heads, cfg8b.head_dim
    entries = {}

    # flash_attention: causal prefill at Sq = Sk in {1024, 777}; one chunk
    # continuation with offsets; one return_lse case.
    attn_cases = [
        ("causal-1024", 1024, 1024, {}, False),
        ("causal-777", 777, 777, {}, False),
        ("chunk-256@512", 256, 1024, dict(q_offset=512, kv_offset=0), False),
        ("causal-777-lse", 777, 777, {}, True),
    ]
    attn_err = 0.0
    for label, sq, sk, offs, with_lse in attn_cases:
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
        if label == "causal-1024":
            kernel_ms = time_ms(lambda: flash_attention(q, k, v, causal=True))
            plain_ms = time_ms(lambda: attention_reference(q, k, v, causal=True), iters=5)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True))
            b_ms, b_by = bound_ms(attention_flops(1, hq, sq, sk, d, causal=True),
                                  attention_bytes(q, k, v))
            entries["flash_attention"] = dict(
                name="flash_attention", route="cuda", source="triton_dist_tpu_torch/csrc/flash_attn.cu",
                replaces="triton_dist_tpu/kernels/flash_attn.py:43", ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            )
            log(f"flash_attention causal B=1 Hq={hq} Hkv={hkv} S=1024 D={d} bf16: kernel_ms {kernel_ms:.4f}, "
                f"plain_ms {plain_ms:.4f}, library_ms(SDPA) {lib_ms:.4f}, bound_ms {b_ms:.4f} ({b_by})")
    entries["flash_attention"]["max_abs_err"] = attn_err

    # flash_decode: B=4 over a 2048-row cache with ragged lengths.
    b, s = 4, MAX_LEN
    q = randn(b, hq, d)
    kc, vc = randn(b, hkv, s, d), randn(b, hkv, s, d)
    lengths = torch.tensor([1, 777, 1500, 2048], dtype=torch.int32, device=dev)
    got_o, got_lse = flash_decode(q, kc, vc, lengths, return_lse=True)
    want_o, want_lse = decode_reference(q, kc, vc, lengths, return_lse=True)
    torch.cuda.synchronize()
    dec_err = close(got_o, want_o, BF16_ATOL, BF16_RTOL)
    dec_lse_err = close(got_lse, want_lse, LSE_ATOL, 0.0)
    log(f"flash_decode B={b} lengths {lengths.tolist()}: max|o err| {dec_err:.3e}, max|lse err| {dec_lse_err:.3e}")
    kernel_ms = time_ms(lambda: flash_decode(q, kc, vc, lengths))
    plain_ms = time_ms(lambda: decode_reference(q, kc, vc, lengths), iters=5)
    mask = (torch.arange(s, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True))
    b_ms, b_by = bound_ms(decode_flops(q, kc, lengths), decode_bytes(q, kc, lengths))
    entries["flash_decode"] = dict(
        name="flash_decode", route="cuda", source="triton_dist_tpu_torch/csrc/flash_decode.cu",
        replaces="triton_dist_tpu/kernels/flash_decode.py:71", ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, max_abs_err=dec_err,
    )
    log(f"flash_decode B={b} Hq={hq} Hkv={hkv} S={s} D={d} bf16: kernel_ms {kernel_ms:.4f}, "
        f"plain_ms {plain_ms:.4f}, library_ms(SDPA) {lib_ms:.4f}, bound_ms {b_ms:.4f} ({b_by})")
    del q, kc, vc, got_o, got_lse, want_o, want_lse

    # ------------------------------------- 3. parity: CUDA vs CPU, small fp32
    small = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                        num_q_heads=8, num_kv_heads=2, head_dim=128, dtype="float32")
    p_cpu = init_params(small, torch.Generator().manual_seed(SEED), "cpu")
    p_gpu = DenseParams(**{k: None if t is None else t.to(dev) for k, t in vars(p_cpu).items()})
    m_cpu = DenseLLM(small, p_cpu, device="cpu")
    m_gpu = DenseLLM(small, p_gpu, device=dev)
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
    del m_cpu, m_gpu, p_cpu, p_gpu

    # ------------------------------------ 4. full width: Qwen3-8B, 36 layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = DenseLLM(cfg8b, generator=torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in vars(model.params).values() if t is not None)
    log(f"qwen3-8b: {cfg8b.num_layers} layers, {n_params / 1e9:.2f} B params bf16, "
        f"random init {time.perf_counter() - t0:.1f} s")
    engine = Engine(model, backend="dist", max_len=MAX_LEN)
    vocab = cfg8b.vocab_size
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
    serve_ids = prompt(128, rows=2)
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
    served = engine.serve(serve_ids, gen_len=16)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()

    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the served path: {launches}")
    for name, toks in (("decode_steps", out), ("serve", served)):
        if not bool(((toks >= 0) & (toks < vocab)).all()):
            raise AssertionError(f"{name} produced tokens outside the vocabulary: {toks.tolist()}")
    want_len = [n + DECODE_STEPS for n in FLASH_PROMPTS]
    if cache.lengths.tolist() != want_len or rem.tolist() != [0] * 4:
        raise AssertionError(f"slot lengths {cache.lengths.tolist()} != {want_len}")
    logits, _ = model.prefill(prompts[2])
    step_logits, _, _ = model.decode(last, cache.k, cache.v, cache.lengths)
    if not (bool(torch.isfinite(logits).all()) and bool(torch.isfinite(step_logits).all())):
        raise AssertionError("non-finite logits at full width")
    for n, t in zip(FLASH_PROMPTS, ttft):
        log(f"qwen3-8b request prompt={n}: TTFT {t:.2f} ms")
    log(f"qwen3-8b decode_steps B=4, {DECODE_STEPS} steps: {decode_ms:.2f} ms/step "
        f"({4 * 1e3 / decode_ms:.1f} tokens/s); serve B=2 128+16 tokens: {serve_ms:.1f} ms")
    log(f"qwen3-8b launches on the served path: {launches} "
        f"(flash_attention {cfg8b.num_layers} per prefill, flash_decode {cfg8b.num_layers} per decode step)")
    log(f"qwen3-8b peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"first tokens {tokens0}, decode row 0 {out[0, :8].tolist()}")

    # Where a step's time goes: one profiled prefill and one profiled
    # 4-step decode chunk, after the counted run.
    for label, fn, steps in (
        (f"prefill {FLASH_PROMPTS[2]} tokens", lambda: model.prefill(prompts[2]), 1),
        ("decode_steps B=4", lambda: engine.decode_steps(
            cache, last, torch.full((4,), 4), 4), 4),
    ):
        wall, busy, families, n_kernels = profile_window(fn)
        if busy is None:
            log(f"profile {label}: wall {wall / steps:.2f} ms/step, device time not measured "
                "(the profiler recorded no CUDA kernels)")
            continue
        shares = ", ".join(f"{k} {v / steps:.3f} ms" for k, v in
                           sorted(families.items(), key=lambda kv: -kv[1]))
        log(f"profile {label}: wall {wall / steps:.2f} ms/step, device busy {busy / steps:.2f} ms/step "
            f"({100 * busy / wall:.1f} %), {n_kernels / steps:.0f} kernels/step; "
            f"by kernel family per step: {shares}")

    # --------------------------------------------------------- 5. results
    kernels = []
    for name in ("flash_attention", "flash_decode"):
        e = dict(entries[name])
        e["launches"] = launches[name]
        kernels.append({k: e[k] for k in ("name", "route", "source", "replaces", "launches",
                                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device_report()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card (a CUDA kernel has no interpret mode); they
skip without one. On a machine with a card and without JAX, run them
without the JAX test substrate:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: fp32 inputs run the SIMT kernels against fp32 plain versions
in another summation order (``1e-4``); bf16 inputs round P and the output
to bf16 (8 significant bits), so ``|err| <= 1e-2 + 2e-2·|plain|``.
"""

import pytest
import torch
from test_torch_tp_ranks import Ranks

from triton_dist_tpu_torch import function as fn
from triton_dist_tpu_torch.kernels import (
    attention_bwd_reference,
    attention_reference,
    decode_reference,
    flash_attention,
    flash_attention_bwd,
    flash_attention_varlen,
    flash_attention_varlen_bwd,
    flash_decode,
    group_gemm_swiglu,
    group_swiglu_reference,
    paged_decode_quant_reference,
    paged_decode_reference,
    paged_flash_decode,
    paged_flash_decode_quant,
    varlen_bwd_reference,
    varlen_reference,
)
from triton_dist_tpu_torch.kernels import mega_decode as mk
from triton_dist_tpu_torch.kernels.flash_attn import NEG_INF
from triton_dist_tpu_torch.kernels.flash_decode import gather_paged_kv
from triton_dist_tpu_torch.kernels.mega_moe import fused_moe_block, moe_block_reference
from triton_dist_tpu_torch.models.kv_cache import NULL_BLOCK
from triton_dist_tpu_torch.models import PRESETS, DenseLLM, DenseParams, Engine, Qwen3MoE, init_params
from triton_dist_tpu_torch.models.quant import QuantPool, dequantize_kv, quantize_kv_rows

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 2e-2)}
DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["fp32", "bf16"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda", 0)


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _assert_close(got, want, dtype, what=None):
    atol, rtol = TOL[dtype]
    msg = None if what is None else (lambda m: f"{what}: {m}")
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol, msg=msg)


# (b, hq, hkv, sq, sk, d, causal, q_offset, kv_offset)
ATTN_CASES = {
    "causal-square-g1-d128": (2, 4, 4, 128, 128, 128, True, None, None),
    "causal-ragged-g4-d128": (1, 8, 2, 77, 77, 128, True, None, None),
    "causal-sq<sk-g8-d64": (1, 16, 2, 40, 200, 64, True, None, None),
    "causal-sq>sk-g2-d32": (1, 4, 2, 70, 30, 32, True, None, None),
    "noncausal-g2-d64": (2, 4, 2, 33, 95, 64, False, None, None),
    "offset-chunk-g4-d128": (1, 8, 2, 64, 256, 128, True, 100, 0),
    "offset-empty-rows-g4-d32": (1, 8, 2, 48, 96, 32, True, 0, 30),
    # Qwen3-30B-A3B at world 4: 8 q heads and 1 kv head a rank
    "causal-30b-world4-g8-hkv1-d128": (1, 8, 1, 96, 96, 128, True, None, None),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("case", list(ATTN_CASES), ids=list(ATTN_CASES))
def test_flash_attention_kernel_vs_plain(cuda, case, dtype):
    """Each case with o alone and with o and lse, one launch each."""
    b, hq, hkv, sq, sk, d, causal, q_offset, kv_offset = ATTN_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(sum(map(ord, case)))
    q = _randn(gen, (b, hq, sq, d), dtype, cuda)
    k, v = _randn(gen, (b, hkv, sk, d), dtype, cuda), _randn(gen, (b, hkv, sk, d), dtype, cuda)
    for return_lse in (False, True):
        kw = dict(causal=causal, return_lse=return_lse, q_offset=q_offset, kv_offset=kv_offset)
        before = flash_attention.launches
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        want = attention_reference(q, k, v, **kw)
        if return_lse:
            _assert_close(got[0], want[0], dtype, "o+lse: o")
            torch.testing.assert_close(got[1], want[1], atol=1e-3, rtol=1e-5)
        else:
            _assert_close(got, want, dtype, "o")


# (hq, hkv, t, d, cu_seqlens, q_offset, kv_offset): packed streams with a
# padding tail, one sequence longer than a tile, ring-step offsets (a shard
# of a longer stream; a step above the diagonal sees no key).
VARLEN_CASES = {
    "pad-tail-g2-d32": (4, 2, 96, 32, [0, 24, 56, 80], None, None),
    "long-seq-g4-d128": (8, 2, 200, 128, [0, 130, 131, 190], None, None),
    "no-pad-g1-d64": (4, 4, 128, 64, [0, 64, 100, 128], None, None),
    "ring-step-g2-d128": (4, 2, 64, 128, [0, 40, 150, 256], 128, 64),
    "ring-skipped-g2-d64": (4, 2, 64, 64, [0, 40, 150, 256], 64, 128),
}


def _varlen_inputs(case, dtype, device):
    hq, hkv, t, d, cu, q_offset, kv_offset = VARLEN_CASES[case]
    gen = torch.Generator(device=device).manual_seed(sum(map(ord, case)))
    q = _randn(gen, (hq, t, d), dtype, device)
    k, v = _randn(gen, (hkv, t, d), dtype, device), _randn(gen, (hkv, t, d), dtype, device)
    return q, k, v, cu, dict(q_offset=q_offset, kv_offset=kv_offset)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("case", list(VARLEN_CASES), ids=list(VARLEN_CASES))
def test_flash_attention_varlen_kernel_vs_plain(cuda, case, dtype):
    """Row 4: o and LSE against the plain version; padding rows and rows
    that see no key exactly 0 with lse NEG_INF."""
    q, k, v, cu, offs = _varlen_inputs(case, dtype, cuda)
    before = flash_attention_varlen.launches
    got_o, got_lse = flash_attention_varlen(q, k, v, cu, return_lse=True, **offs)
    torch.cuda.synchronize()
    assert flash_attention_varlen.launches == before + 1
    want_o, want_lse = varlen_reference(q, k, v, cu, return_lse=True, **offs)
    _assert_close(got_o, want_o, dtype)
    empty = want_lse == NEG_INF
    assert torch.equal(got_lse[empty], want_lse[empty])
    assert torch.equal(got_o[empty], torch.zeros_like(got_o[empty]))
    torch.testing.assert_close(got_lse[~empty], want_lse[~empty], atol=1e-3, rtol=1e-5)


# (b, hq, hkv, sq, sk, d, causal, q_offset, kv_offset, with dlse)
BWD_CASES = {
    "causal-square-g4-d128": (1, 8, 2, 128, 128, 128, True, None, None, False),
    "causal-ragged-g1-d64": (2, 4, 4, 77, 77, 64, True, None, None, False),
    "causal-sq<sk-end-aligned-g2-d32": (1, 4, 2, 64, 128, 32, True, None, None, False),
    "noncausal-g2-d64": (1, 4, 2, 33, 95, 64, False, None, None, False),
    "ring-step-dlse-g4-d128": (1, 8, 2, 64, 64, 128, True, 128, 64, True),
    "ring-diagonal-dlse-g2-d32": (1, 4, 2, 96, 96, 32, True, 96, 96, True),
    "whole-masked-step-g2-d64": (1, 4, 2, 64, 64, 64, True, 0, 128, True),
}


def _bwd_inputs(case, dtype, device):
    b, hq, hkv, sq, sk, d, causal, q_offset, kv_offset, with_dlse = BWD_CASES[case]
    gen = torch.Generator(device=device).manual_seed(sum(map(ord, case)))
    q = _randn(gen, (b, hq, sq, d), dtype, device)
    k, v = _randn(gen, (b, hkv, sk, d), dtype, device), _randn(gen, (b, hkv, sk, d), dtype, device)
    kw = dict(causal=causal, q_offset=q_offset, kv_offset=kv_offset)
    o, lse = attention_reference(q, k, v, return_lse=True, **kw)
    do = _randn(gen, (b, hq, sq, d), dtype, device)
    dlse = torch.randn((b, hq, sq), generator=gen, device=device) if with_dlse else None
    return (q, k, v, o, lse, do), dict(kw, dlse=dlse)


def _assert_grads(got, want, dtype):
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g.float()).all())
        _assert_close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("case", list(BWD_CASES), ids=list(BWD_CASES))
def test_flash_attention_bwd_kernel_vs_plain(cuda, case, dtype):
    """Row 5: (dq, dk, dv) against the plain version; a step that sees no
    key gives exact zeros; a second call gives the same bits (no atomics)."""
    args, kw = _bwd_inputs(case, dtype, cuda)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 2
    _assert_grads(got, attention_bwd_reference(*args, **kw), dtype)
    again = flash_attention_bwd(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if case.startswith("whole-masked"):
        assert all(not bool(g.any()) for g in got)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("case", list(VARLEN_CASES), ids=list(VARLEN_CASES))
def test_flash_attention_varlen_bwd_kernel_vs_plain(cuda, case, dtype):
    """Row 6: (dq, dk, dv) against the plain version with a nonzero dlse;
    padding rows' dq exactly 0; a second call gives the same bits."""
    q, k, v, cu, offs = _varlen_inputs(case, dtype, cuda)
    o, lse = varlen_reference(q, k, v, cu, return_lse=True, **offs)
    gen = torch.Generator(device=cuda).manual_seed(7)
    do = _randn(gen, q.shape, dtype, cuda)
    dlse = torch.randn(lse.shape, generator=gen, device=cuda)
    before = flash_attention_varlen_bwd.launches
    got = flash_attention_varlen_bwd(q, k, v, o, lse, do, cu, dlse=dlse, **offs)
    torch.cuda.synchronize()
    assert flash_attention_varlen_bwd.launches == before + 2
    _assert_grads(got, varlen_bwd_reference(q, k, v, o, lse, do, cu, dlse=dlse, **offs), dtype)
    again = flash_attention_varlen_bwd(q, k, v, o, lse, do, cu, dlse=dlse, **offs)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    empty = lse == NEG_INF
    assert not bool(got[0][empty].any())


def _grads(loss_fn, *leaves):
    leaves = [t.detach().clone().requires_grad_() for t in leaves]
    loss_fn(*leaves).backward()
    return [t.grad for t in leaves]


def test_autograd_functions_vs_plain(cuda):
    """Each attention autograd function's gradients (rows 1 + 5, 4 + 6)
    against autograd through the plain forward on the same card, fp32 (the
    point is the algorithm: autograd of the plain forward does not round p
    and ds to bf16 as the backward kernels and their plain versions do, so
    bf16 is held kernel against plain backward above); the LSE outputs
    carry a cotangent too."""
    dtype = torch.float32
    gen = torch.Generator(device=cuda).manual_seed(11)
    q = _randn(gen, (1, 8, 96, 64), dtype, cuda)
    k, v = _randn(gen, (1, 2, 96, 64), dtype, cuda), _randn(gen, (1, 2, 96, 64), dtype, cuda)
    c = _randn(gen, (1, 8, 96, 64), dtype, cuda)
    cl = torch.randn((1, 8, 96), generator=gen, device=cuda)

    def dense(attn):
        return lambda q_, k_, v_: (attn(q_, k_, v_).float() * c.float()).sum()

    _assert_grads(_grads(dense(lambda *a: fn.flash_attention_fn(*a, True)), q, k, v),
                  _grads(dense(lambda *a: attention_reference(*a, causal=True)), q, k, v), dtype)

    def with_lse(attn):
        def loss(q_, k_, v_):
            o, lse = attn(q_, k_, v_)
            return (o.float() * c.float()).sum() + (lse * cl).sum()
        return loss

    _assert_grads(_grads(with_lse(lambda *a: fn.flash_attention_lse_fn(*a, 32, 0, True)), q, k, v),
                  _grads(with_lse(lambda *a: attention_reference(*a, return_lse=True, q_offset=32, kv_offset=0)),
                         q, k, v), dtype)
    cu = [0, 30, 64, 90]
    qp, kp, vp = q[0], k[0], v[0]

    def packed(attn):
        def loss(q_, k_, v_):
            o, lse = attn(q_, k_, v_)
            return (o.float() * c[0].float()).sum() + (torch.where(lse > NEG_INF, lse, 0.0) * cl[0]).sum()
        return loss

    _assert_grads(_grads(packed(lambda *a: fn.flash_attention_varlen_lse_fn(*a, cu, 0, 0)), qp, kp, vp),
                  _grads(packed(lambda *a: varlen_reference(*a, cu, return_lse=True)), qp, kp, vp), dtype)
    _assert_grads(_grads(lambda *a: (fn.flash_attention_varlen_fn(*a, cu).float() * c[0].float()).sum(), qp, kp, vp),
                  _grads(lambda *a: (varlen_reference(*a, cu).float() * c[0].float()).sum(), qp, kp, vp), dtype)


def test_training_step_on_cuda_matches_cpu(cuda):
    """One fp32 ``test-dense`` attention-block step (dense and packed):
    gradients on the card within 5e-4 of the CPU's (of their largest: the
    loss is a mean), and the loss falls."""
    from triton_dist_tpu_torch.function.training import attention_block_loss

    cfg = PRESETS["test-dense"]
    p = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 40), generator=torch.Generator().manual_seed(4))
    for cu in (None, [0, 12, 30, 37]):
        runs = []
        for dev in ("cpu", cuda):
            leaves = [t.to(dev) for t in (p.wqkv[0], p.wo[0])]
            loss_fn = lambda wqkv, wo: attention_block_loss(p.embed.to(dev), p.ln1[0].to(dev), wqkv, wo,
                                                            tokens.to(dev), cfg, cu_seqlens=cu)
            grads = _grads(loss_fn, *leaves)
            loss0 = loss_fn(*leaves).item()
            loss1 = loss_fn(*[w - 0.5 * g for w, g in zip(leaves, grads)]).item()
            runs.append((grads, loss0, loss1))
        (g_cpu, l0, l1), (g_gpu, m0, m1) = runs
        for a, b in zip(g_gpu, g_cpu):
            torch.testing.assert_close(a.cpu(), b, atol=5e-4 * b.abs().max().item(), rtol=5e-4)
        assert m1 < m0 and abs(m0 - l0) < 5e-4


# (b, hq, hkv, s, d, lengths)
DECODE_CASES = {
    "g4-d128": (4, 32, 8, 512, 128, [1, 100, 512, 300]),
    "g1-d64": (3, 4, 4, 300, 64, [299, 0, 1]),
    "g2-d32": (2, 8, 4, 64, 32, [64, 33]),
    "g8-d128-len>s": (2, 16, 2, 96, 128, [96, 500]),
    "30b-world4-g8-hkv1-d128": (4, 8, 1, 512, 128, [1, 96, 384, 512]),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("case", list(DECODE_CASES), ids=list(DECODE_CASES))
def test_flash_decode_kernel_vs_plain(cuda, case, dtype):
    b, hq, hkv, s, d, lengths = DECODE_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(sum(map(ord, case)))
    q = _randn(gen, (b, hq, d), dtype, cuda)
    kc, vc = _randn(gen, (b, hkv, s, d), dtype, cuda), _randn(gen, (b, hkv, s, d), dtype, cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = flash_decode.launches
    got_o, got_lse = flash_decode(q, kc, vc, lens, return_lse=True)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    want_o, want_lse = decode_reference(q, kc, vc, lens, return_lse=True)
    _assert_close(got_o, want_o, dtype)
    torch.testing.assert_close(got_lse, want_lse, atol=1e-3, rtol=1e-5)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 4, 8, 64, device=cuda)
    k = torch.zeros(1, 2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, k)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(), k[..., :48].contiguous())
    kc = torch.zeros(1, 2, 16, 64, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        flash_decode(q[:, :, 0].contiguous(), kc, kc, torch.ones(1, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="group"):
        flash_decode(torch.zeros(1, 6, 64, device=cuda), kc, kc, torch.ones(1, dtype=torch.int32, device=cuda))


def test_engine_on_cuda_matches_cpu(cuda):
    """test-dense (fp32, D = 32, group 2): greedy streams through the CUDA
    kernels equal the plain versions' on the CPU."""
    cfg = PRESETS["test-dense"]
    p_cpu = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    p_gpu = DenseParams(**{k: None if t is None else t.to(cuda) for k, t in vars(p_cpu).items()})
    ids = torch.tensor([[3, 17, 42, 7, 99, 5, 23, 11], [1, 2, 3, 4, 5, 6, 7, 8]])
    want = Engine(DenseLLM(cfg, p_cpu, device="cpu"), max_len=32).serve(ids, gen_len=8)
    got = Engine(DenseLLM(cfg, p_gpu, device=cuda), max_len=32).serve(ids, gen_len=8)
    torch.testing.assert_close(got.cpu(), want, atol=0, rtol=0)


# (E, d, f): test-moe's experts and Qwen3-30B-A3B's.
SWIGLU_SIZES = {"test": (8, 64, 48), "served": (128, 2048, 768)}


@pytest.mark.parametrize("c", [8, 24, 104])
@pytest.mark.parametrize("size", list(SWIGLU_SIZES))
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_group_gemm_swiglu_kernel_vs_plain(cuda, dtype, size, c):
    """C = 8 is every decode step (half of each 16-row mma tile masked);
    24 and 104 are ragged against the kernel's 64-row tiles."""
    e, d, f = SWIGLU_SIZES[size]
    gen = torch.Generator(device=cuda).manual_seed(c + d)
    x = _randn(gen, (e, c, d), dtype, cuda)
    wg = (torch.randn((e, d, f), generator=gen, device=cuda) * d ** -0.5).to(dtype)
    wu = (torch.randn((e, d, f), generator=gen, device=cuda) * d ** -0.5).to(dtype)
    before = group_gemm_swiglu.launches
    got = group_gemm_swiglu(x, wg, wu)
    torch.cuda.synchronize()
    assert group_gemm_swiglu.launches == before + 1
    assert got.shape == (e, c, f) and got.dtype == dtype
    _assert_close(got, group_swiglu_reference(x, wg, wu), dtype)


def test_group_gemm_swiglu_raises_on_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(4, 8, 64, device=cuda)
    w = torch.zeros(4, 64, 48, device=cuda)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        group_gemm_swiglu(x.half(), w.half(), w.half())
    with pytest.raises(ValueError, match="do not fit"):
        group_gemm_swiglu(x, w[:, :32].contiguous(), w[:, :32].contiguous())
    with pytest.raises(ValueError, match="bad shapes"):
        group_gemm_swiglu(x, w, w[..., :40].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        group_gemm_swiglu(x.transpose(1, 2).contiguous().transpose(1, 2), w, w)
    with pytest.raises(ValueError, match="multiples of 8"):
        xb, wb = x[..., :60].bfloat16().contiguous(), w[:, :60].bfloat16().contiguous()
        group_gemm_swiglu(xb, wb, wb)


def test_moe_engine_on_cuda_matches_cpu(cuda):
    """test-moe (fp32, 8 experts, top-2): greedy streams through the CUDA
    kernels equal the plain versions' on the CPU, in batch 2 (decode takes
    the T < 8 branch) and batch 8 (decode takes ``tp_moe_ar_shard``)."""
    cfg = PRESETS["test-moe"]
    p_cpu = init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    p_gpu = DenseParams(**{k: None if t is None else t.to(cuda) for k, t in vars(p_cpu).items()})
    ids = torch.randint(0, cfg.vocab_size, (8, 12), generator=torch.Generator().manual_seed(5))
    for rows in (2, 8):
        want = Engine(Qwen3MoE(cfg, p_cpu, device="cpu"), max_len=32).serve(ids[:rows], gen_len=8)
        got = Engine(Qwen3MoE(cfg, p_gpu, device=cuda), max_len=32).serve(ids[:rows], gen_len=8)
        torch.testing.assert_close(got.cpu(), want, atol=0, rtol=0)


# ------------------------------------------------- the mega decode kernels

# (d, ff, hq, hkv, hd, V): test-dense's widths and Qwen3-8B's.
MEGA_SIZES = {"test": (64, 128, 8, 4, 32, 256), "qwen3-8b": (4096, 12288, 32, 8, 128, 151936)}
MEGA_ROWS = [1, 4, 8]


def _weight(gen, shape, dtype, device):
    return (torch.randn(shape, generator=gen, device=device) * shape[0] ** -0.5).to(dtype)


def _norm_weight(gen, n, dtype, device):
    return (torch.rand(n, generator=gen, device=device) + 0.5).to(dtype)


def _counted(fn, *args, **kwargs):
    before = fn.launches
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    return out


# The four fused mega kernels below run each of MEGA_ROWS rows in turn,
# each row count on inputs of its own seed.


@pytest.mark.parametrize("size", list(MEGA_SIZES))
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_fused_ln_qkv_rope_kernel_vs_plain(cuda, dtype, size):
    d, _, hq, hkv, hd, _ = MEGA_SIZES[size]
    for b in MEGA_ROWS:
        gen = torch.Generator(device=cuda).manual_seed(b + d)
        x = _randn(gen, (b, d), dtype, cuda)
        ln_w = _norm_weight(gen, d, dtype, cuda)
        qn, kn = _norm_weight(gen, hd, dtype, cuda), _norm_weight(gen, hd, dtype, cuda)
        wqkv = _weight(gen, (d, (hq + 2 * hkv) * hd), dtype, cuda)
        pos = torch.tensor([0, 1, 777, 2047, 5, 100, 1500, 9][:b], dtype=torch.int32, device=cuda)
        kw = dict(num_q_heads=hq, num_kv_heads=hkv, head_dim=hd, rope_theta=1e6, eps=1e-6)
        got = _counted(mk.fused_ln_qkv_rope, x, ln_w, wqkv, qn, kn, pos, **kw)
        want = mk.ln_qkv_rope_reference(x, ln_w, wqkv, qn, kn, pos, **kw)
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.is_contiguous()
            _assert_close(g, w, dtype, f"b={b}")


@pytest.mark.parametrize("size", list(MEGA_SIZES))
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_fused_attn_back_kernel_vs_plain(cuda, dtype, size):
    """Lengths 0, S - 1 and S (the full cache, where nothing is spliced)
    among the rows, against the plain splice → decode → o-projection."""
    d, _, hq, hkv, hd, _ = MEGA_SIZES[size]
    s = 128 if size == "test" else 2048
    for b in MEGA_ROWS:
        gen = torch.Generator(device=cuda).manual_seed(b + d + 1)
        q = _randn(gen, (b, hq, hd), dtype, cuda)
        kn, vn = _randn(gen, (b, hkv, hd), dtype, cuda), _randn(gen, (b, hkv, hd), dtype, cuda)
        kc, vc = _randn(gen, (b, hkv, s, hd), dtype, cuda), _randn(gen, (b, hkv, s, hd), dtype, cuda)
        wo = _weight(gen, (hq * hd, d), dtype, cuda)
        lengths = torch.tensor([0, s - 1, s, 17, 1, s // 2, 3, s - 2][:b], dtype=torch.int32, device=cuda)
        k_before, v_before = kc.clone(), vc.clone()
        got = _counted(mk.fused_attn_back, q, kn, vn, kc, vc, lengths, wo)
        assert got.dtype == torch.float32 and got.shape == (b, d)
        assert torch.equal(kc, k_before) and torch.equal(vc, v_before)  # the caches are only read
        _assert_close(got, mk.attn_back_reference(q, kn, vn, kc, vc, lengths, wo), dtype, f"b={b}")


@pytest.mark.parametrize("size", list(MEGA_SIZES))
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_fused_mlp_block_kernel_vs_plain(cuda, dtype, size):
    d, ff, *_ = MEGA_SIZES[size]
    for b in MEGA_ROWS:
        gen = torch.Generator(device=cuda).manual_seed(b + d + 2)
        x = _randn(gen, (b, d), dtype, cuda)
        ln_w = _norm_weight(gen, d, dtype, cuda)
        wg, wu = _weight(gen, (d, ff), dtype, cuda), _weight(gen, (d, ff), dtype, cuda)
        wd = _weight(gen, (ff, d), dtype, cuda)
        for residual in (False, True):
            got = _counted(mk.fused_mlp_block, x, ln_w, wg, wu, wd, residual=residual)
            assert got.dtype == dtype
            want = mk.mlp_block_reference(x, ln_w, wg, wu, wd, residual=residual)
            _assert_close(got, want, dtype, f"b={b} residual={residual}")


@pytest.mark.parametrize("size", list(MEGA_SIZES))
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_fused_norm_head_kernel_vs_plain(cuda, dtype, size):
    d, *_, vocab = MEGA_SIZES[size]
    for b in MEGA_ROWS:
        gen = torch.Generator(device=cuda).manual_seed(b + d + 3)
        x = _randn(gen, (b, d), dtype, cuda)
        nw = _norm_weight(gen, d, dtype, cuda)
        head = _weight(gen, (d, vocab), dtype, cuda)
        got = _counted(mk.fused_norm_head, x, nw, head)
        assert got.dtype == torch.float32 and got.shape == (b, vocab)
        _assert_close(got, mk.norm_head_reference(x, nw, head), dtype, f"b={b}")


def test_mega_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(2, 64, device=cuda)
    w = torch.zeros(64, 128, device=cuda)
    nw = torch.ones(64, device=cuda)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        mk.fused_norm_head(x.half(), nw.half(), w.half())
    with pytest.raises(ValueError, match="one device"):
        mk.fused_norm_head(x, nw.cpu(), w)
    with pytest.raises(ValueError, match="contiguous"):
        mk.fused_norm_head(x, nw, w.t().contiguous().t())
    with pytest.raises(ValueError, match="must be"):
        mk.fused_mlp_block(x, nw, w, w, w.t().contiguous().bfloat16())
    with pytest.raises(ValueError, match="at most 8 rows"):
        mk.fused_mlp_block(torch.zeros(9, 64, device=cuda), nw, w, w, w.t().contiguous())
    q = torch.zeros(2, 8, 32, device=cuda)
    kv = torch.zeros(2, 4, 32, device=cuda)
    cache = torch.zeros(2, 4, 16, 32, device=cuda)
    wo = torch.zeros(256, 64, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        mk.fused_attn_back(q, kv, kv, cache, cache, torch.ones(2, dtype=torch.int64, device=cuda), wo)
    with pytest.raises(ValueError, match="bad shapes"):
        mk.fused_attn_back(q, kv, kv, cache, cache, torch.ones(2, dtype=torch.int32, device=cuda), wo[:128])
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        mk.fused_ln_qkv_rope(x, nw, torch.zeros(512, 64, device=cuda).t(), nw[:32], nw[:32], pos,
                             num_q_heads=8, num_kv_heads=4, head_dim=32)


def test_mega_engine_on_cuda_matches_cpu(cuda):
    """test-dense (fp32): the mega backend's greedy streams through the CUDA
    kernels equal the plain versions' on the CPU, in serve and in a slot
    decode with a free slot."""
    cfg = PRESETS["test-dense"]
    p_cpu = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    p_gpu = DenseParams(**{k: None if t is None else t.to(cuda) for k, t in vars(p_cpu).items()})
    m_cpu, m_gpu = DenseLLM(cfg, p_cpu, device="cpu"), DenseLLM(cfg, p_gpu, device=cuda)
    ids = torch.tensor([[3, 17, 42, 7, 99, 5, 23, 11], [1, 2, 3, 4, 5, 6, 7, 8]])
    want = Engine(m_cpu, backend="mega", max_len=32).serve(ids, gen_len=8)
    got = Engine(m_gpu, backend="mega", max_len=32).serve(ids, gen_len=8)
    torch.testing.assert_close(got.cpu(), want, atol=0, rtol=0)
    outs = []
    for model in (m_cpu, m_gpu):
        engine = Engine(model, backend="mega", max_len=32)
        cache = engine.alloc_slots(3)
        t0, cache = engine.prefill_into_slot(cache, 0, ids[:1])
        t2, cache = engine.prefill_into_slot(cache, 2, ids[1:, :5])
        tokens = torch.stack([t0, t0, t2])
        out, _, cache, _ = engine.decode_steps(cache, tokens, torch.tensor([5, 0, 3]), 5)
        outs.append((out.cpu(), cache.lengths.cpu()))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=0, rtol=0)
    assert outs[1][1].tolist() == outs[0][1].tolist() == [8 + 5, 0, 5 + 3]


# ------------------------------------- the paged walk and the routed experts

def _paged_case(gen, dtype, device, hkv, bs=16, mb=128, hq=32, d=128):
    """A shuffled pool: lengths 0, 1, bs - 1, bs, S = mb·bs and two ragged
    ones; each sequence owns distinct blocks, NULL past its chain."""
    lengths = torch.tensor([0, 1, bs - 1, bs, mb * bs, 777, 1500], dtype=torch.int32)
    b = lengths.numel()
    nb = 1 + b * mb
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(hkv)) + 1
    tables = perm.reshape(b, mb).to(torch.int32)
    for i, n in enumerate(lengths.tolist()):
        tables[i, -(-n // bs):] = NULL_BLOCK
    q = _randn(gen, (b, hq, d), dtype, device)
    kp, vp = _randn(gen, (nb, hkv, bs, d), dtype, device), _randn(gen, (nb, hkv, bs, d), dtype, device)
    return q, kp, vp, tables.to(device), lengths.to(device)


@pytest.mark.parametrize("hkv", [4, 8])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_paged_flash_decode_kernel_vs_plain(cuda, dtype, hkv):
    """The table walk against its plain version, and bitwise against the
    padded-cache kernel on the gathered view (the same sweep, partition and
    order); a sequence with no key gives o = 0, lse = -1e30."""
    gen = torch.Generator(device=cuda).manual_seed(hkv)
    q, kp, vp, tables, lengths = _paged_case(gen, dtype, cuda, hkv)
    o, lse = _counted(paged_flash_decode, q, kp, vp, tables, lengths, return_lse=True)
    want_o, want_lse = paged_decode_reference(q, kp, vp, tables, lengths, return_lse=True)
    _assert_close(o, want_o, dtype)
    torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
    assert not o[0].any() and (lse[0] == -1e30).all()
    ref_o, ref_lse = flash_decode(q, gather_paged_kv(kp, tables), gather_paged_kv(vp, tables), lengths,
                                  return_lse=True)
    assert torch.equal(o, ref_o) and torch.equal(lse, ref_lse)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("wire", ["int8", "fp8"])
def test_paged_flash_decode_quant_kernel_vs_plain(cuda, wire, dtype):
    """Row 3b on a quantized pool (lengths 0, 1, bs - 1, bs, S and two
    ragged ones, NULL tails) against its plain version, and bitwise against
    row 3 on the pool dequantized to q's dtype, at GQA groups 1, 4 and 8."""
    for hq, hkv in ((8, 8), (32, 8), (32, 4)):
        gen = torch.Generator(device=cuda).manual_seed(hq + hkv)
        q, kp, vp, tables, lengths = _paged_case(gen, dtype, cuda, hkv, hq=hq)
        (kq, ks), (vq, vs) = quantize_kv_rows(kp, wire), quantize_kv_rows(vp, wire)
        pk, pv = QuantPool(kq, ks, wire), QuantPool(vq, vs, wire)
        o, lse = _counted(paged_flash_decode_quant, q, kq, vq, tables, lengths, k_scale=ks, v_scale=vs,
                          return_lse=True)
        want_o, want_lse = paged_decode_quant_reference(q, kq, vq, tables, lengths, k_scale=ks, v_scale=vs,
                                                        return_lse=True)
        group = f"hq={hq} hkv={hkv}"
        _assert_close(o, want_o, dtype, group)
        torch.testing.assert_close(lse, want_lse, atol=1e-3, rtol=0)
        assert not o[0].any() and (lse[0] == -1e30).all(), group
        kd, vd = dequantize_kv(kq, ks, dtype), dequantize_kv(vq, vs, dtype)
        ref_o, ref_lse = paged_flash_decode(q, kd, vd, tables, lengths, return_lse=True)
        assert torch.equal(o, ref_o) and torch.equal(lse, ref_lse), group
        before = paged_flash_decode.launches
        assert torch.equal(paged_flash_decode(q, pk, pv, tables, lengths), o), group  # QuantPool operands: row 3b
        assert paged_flash_decode.launches == before


def test_paged_flash_decode_quant_raises_on_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(2, 8, 32, device=cuda)
    pool = torch.zeros(5, 4, 16, 32, device=cuda).to(torch.int8)
    sc = torch.ones(5, 4, 16, 1, device=cuda)
    tables = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
    lengths = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int8 or float8_e4m3fn"):
        paged_flash_decode_quant(q, pool.float(), pool.float(), tables, lengths, k_scale=sc, v_scale=sc)
    with pytest.raises(ValueError, match="scale pools"):
        paged_flash_decode_quant(q, pool, pool, tables, lengths, k_scale=sc[..., 0], v_scale=sc)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        paged_flash_decode_quant(q.half(), pool, pool, tables, lengths, k_scale=sc, v_scale=sc)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        paged_flash_decode(q, pool, pool, tables, lengths, v_scale=sc)


@pytest.mark.parametrize("c", [8, 16])
@pytest.mark.parametrize("size", ["test", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_fused_moe_block_kernel_vs_plain(cuda, dtype, size, c):
    """Capacity-padded panels with empty experts and zero padding rows."""
    e, d, ff = (8, 64, 48) if size == "test" else (128, 2048, 768)
    gen = torch.Generator(device=cuda).manual_seed(c + d)
    xe = _randn(gen, (e, c, d), dtype, cuda)
    fill = torch.randint(0, c + 1, (e,), generator=torch.Generator().manual_seed(c)).to(cuda)
    fill[1::3] = 0  # empty experts
    xe *= (torch.arange(c, device=cuda)[None, :] < fill[:, None])[..., None].to(dtype)
    # Each expert's weights scaled by its fan-in, as the model's are.
    wg, wu, wd = ((torch.randn(shape, generator=gen, device=cuda) * shape[1] ** -0.5).to(dtype)
                  for shape in ((e, d, ff), (e, d, ff), (e, ff, d)))
    got = _counted(fused_moe_block, xe, wg, wu, wd)
    assert got.dtype == torch.float32 and got.shape == (e, c, d)
    _assert_close(got, moe_block_reference(xe, wg, wu, wd), dtype)
    assert not got[1::3].any()


def test_paged_and_moe_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(2, 8, 32, device=cuda)
    pool = torch.zeros(5, 4, 16, 32, device=cuda)
    tables = torch.zeros(2, 2, dtype=torch.int32, device=cuda)
    lengths = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        paged_flash_decode(q, pool, pool, tables.long(), lengths)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        paged_flash_decode(q.half(), pool.half(), pool.half(), tables, lengths)
    with pytest.raises(ValueError, match="contiguous"):
        paged_flash_decode(q, pool, pool, tables.t().contiguous().t(), lengths)
    with pytest.raises(ValueError, match="one device"):
        paged_flash_decode(q, pool, pool, tables.cpu(), lengths)
    xe = torch.zeros(8, 8, 64, device=cuda)
    w = torch.zeros(8, 64, 48, device=cuda)
    wd = torch.zeros(8, 48, 64, device=cuda)
    with pytest.raises(ValueError, match="share a dtype"):
        fused_moe_block(xe, w, w, wd.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        fused_moe_block(xe, w, w, wd.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="bad shapes"):
        fused_moe_block(xe, w, w, wd[:, :40])


@pytest.mark.parametrize("preset", ["test-dense", "test-moe"])
def test_paged_mega_engine_on_cuda_matches_cpu(cuda, preset):
    """The paged mega step (pool write, table walk, the routed experts for
    test-moe) on the card gives the CPU plain path's tokens, slot 1 free."""
    _paged_serve_card_vs_cpu(cuda, preset, None, "mega")


@pytest.mark.parametrize("quant,backend", [("int8", "mega"), ("fp8", "mega"), ("fp8", "dist")])
def test_quant_paged_engine_on_cuda_matches_cpu(cuda, quant, backend):
    """``test-dense`` through a quantized pool (row 3b on mega, the gather
    bounce on dist) on the card gives the CPU plain path's tokens."""
    _paged_serve_card_vs_cpu(cuda, "test-dense", quant, backend)


def _paged_serve_card_vs_cpu(cuda, preset, quant, backend):
    cfg = PRESETS[preset]
    cls = Qwen3MoE if cfg.is_moe else DenseLLM
    p_cpu = init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    p_gpu = DenseParams(**{k: None if t is None else t.to(cuda) for k, t in vars(p_cpu).items()})
    outs = []
    for model in (cls(cfg, p_cpu, device="cpu"), cls(cfg, p_gpu, device=cuda)):
        engine = Engine(model, backend=backend, max_len=32)
        paged = engine.alloc_paged(3, block_size=8, num_blocks=16, quant=quant)
        tokens = []
        for slot, (ids, chain) in enumerate((([3, 17, 42, 7, 99, 5, 23, 11, 2], [5, 2]), ([], []),
                                             ([8, 1, 6, 4], [9, 3]))):
            if not ids:
                tokens.append(0)
                continue
            kb, vb = engine.paged_kbuf_zeros(len(ids))
            logits, kb, vb = engine.prefill_chunk(kb, vb, torch.tensor([ids]), 0, len(ids) - 1)
            row = torch.zeros(paged.max_blocks, dtype=torch.int32)
            row[:len(chain)] = torch.tensor(chain)
            engine.complete_paged_prefill(paged, kb, vb, row, 0)
            paged.tables[slot] = row
            paged.lengths[slot] = len(ids)
            tokens.append(int(logits.argmax()))
        out, _, paged, _ = engine.decode_steps_paged(paged, torch.tensor(tokens), torch.tensor([6, 0, 4]), 6)
        outs.append((out.cpu(), paged.lengths.cpu().tolist(), paged.k.dtype))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=0, rtol=0)
    assert outs[1][1] == outs[0][1] == [9 + 6, 0, 4 + 4]
    assert outs[1][2] == outs[0][2] == (torch.float32 if quant is None else torch.int8 if quant == "int8"
                                        else torch.float8_e4m3fn)


# --------------------------------------------- world 4: rows 16-19, aborts

WORLD = 4


@pytest.fixture(scope="module")
def cuda_ranks(tmp_path_factory):
    """Four rank processes on the available cards (rank r on card r %
    count: four ranks share one card when there is one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    ranks = Ranks(tmp_path_factory.mktemp("tp_cuda") / "store", WORLD, device="cuda")
    yield ranks
    ranks.close()


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_collective_kernels_world4_vs_plain(cuda_ranks, dtype):
    """Rows 16-19 at the edges (one row, ragged shards, 65 rows, m = 3, a
    ragged K of 96) against their plain versions; rows 18 and 19 give the
    same bits on every rank; row 27 (a ragged 40-row shard with GQA 2, and
    B 2 with GQA 4; causal or not; with and without residuals) against
    ``ag_attention_reference``, its gathered K and V bitwise; each call
    counts one launch."""
    atol, rtol = TOL[dtype]
    got = cuda_ranks.ok("cuda_kernels", dict(dtype=str(dtype).split(".")[1], seed=5, atol=atol, rtol=rtol))
    for rank, res in enumerate(got):
        for case, (err, within, same) in res["cases"].items():
            assert within, f"rank {rank} {case}: max |err| {err}"
            assert same in (None, True), f"rank {rank} {case}: the ranks' outputs differ"
        assert res["launches"] == {"ag_gemm_fused": 4, "gemm_rs_fused": 2, "gemm_ar_fused": 2, "gemm_ar_ll": 4,
                                   "ag_attn_kernel": 8}


@pytest.mark.parametrize("wire", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_quant_collective_kernels_world4_vs_plain(cuda_ranks, dtype, wire):
    """Rows 16q-19q (a quantized A) at the edges against their plain
    versions, bitwise against the unquantized kernels on the dequantized A;
    rows 18q and 19q the same bits on every rank; each call counts one
    launch."""
    atol, rtol = TOL[dtype]
    got = cuda_ranks.ok("cuda_quant_kernels", dict(dtype=str(dtype).split(".")[1], wire=wire, seed=7, atol=atol,
                                                   rtol=rtol))
    for rank, res in enumerate(got):
        for case, (err, within, bitwise, same) in res["cases"].items():
            assert within, f"rank {rank} {case}: max |err| {err}"
            assert bitwise, f"rank {rank} {case}: not the unquantized kernel's bits on the dequantized A"
            assert same in (None, True), f"rank {rank} {case}: the ranks' outputs differ"
        assert res["launches"] == {"ag_gemm_fused_quant": 4, "gemm_rs_fused_quant": 2, "gemm_ar_fused_quant": 2,
                                   "gemm_ar_ll_quant": 4}


def test_stalled_peer_ends_in_a_named_collective_abort(cuda, tmp_path):
    """A rank that never arrives: the others' bounded waits expire and
    ``check_status`` raises ``CollectiveAbort`` naming the phase and the
    peer, instead of hanging."""
    ranks = Ranks(tmp_path / "store", WORLD, device="cuda")
    try:
        got = ranks.ok("stall", dict(absent=WORLD - 1, timeout_s=2.0))
    finally:
        ranks.close()
    assert got[WORLD - 1] is None
    for msg in got[:WORLD - 1]:
        assert msg is not None and msg.startswith("CollectiveAbort"), msg
        assert "'ar_recv'" in msg and f"rank {WORLD - 1}" in msg, msg


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_ep_kernels_world4_vs_plain(cuda_ranks, dtype):
    """Row 25 bitwise equal to the plain all-to-all (bf16, the fp8 payload
    as int8, the scales' 4-byte rows, 12-byte chunks, an all-zero source);
    row 26 within tolerance of its plain version (one and two row tiles,
    an all-zero source) and, when every rank sends the same slots, the same
    bits on every rank; rows 16-19 at Qwen3-30B-A3B's world-4 shapes."""
    atol, rtol = TOL[dtype]
    got = cuda_ranks.ok("cuda_ep_kernels", dict(dtype=str(dtype).split(".")[1], seed=7, atol=atol, rtol=rtol))
    for rank, res in enumerate(got):
        for case, (err, within, same) in res["cases"].items():
            assert within, f"rank {rank} {case}: max |err| {err}"
            assert same in (None, True), f"rank {rank} {case}: the ranks' outputs differ"
        assert res["launches"] == {"all_to_all_kernel": 6, "fused_ep_kernel": 4, "ag_gemm_fused": 2,
                                   "gemm_rs_fused": 1, "gemm_ar_fused": 1, "gemm_ar_ll": 1}


def test_stalled_peer_ends_the_ep_all_to_all_in_a_named_abort(cuda, tmp_path):
    """Row 25 with a rank that never arrives ends in ``CollectiveAbort``
    naming the all-to-all's phase and the peer."""
    ranks = Ranks(tmp_path / "store", WORLD, device="cuda")
    try:
        got = ranks.ok("stall", dict(absent=WORLD - 1, timeout_s=2.0, op="a2a"))
    finally:
        ranks.close()
    assert got[WORLD - 1] is None
    for msg in got[:WORLD - 1]:
        assert msg is not None and msg.startswith("CollectiveAbort"), msg
        assert "'a2a_recv'" in msg and f"rank {WORLD - 1}" in msg, msg


# --------------------------------------- world 4: rows 20-22, their aborts

def test_standalone_collectives_world4_vs_plain(cuda_ranks):
    """Rows 20 (ring and full mesh), 21 and 22 bitwise equal to their plain
    versions at the edges (one row, a ragged lead, 12 bytes, bf16, a message
    over one workspace); row 22 the same bits on every rank; row 23 bitwise
    equal to ``ppermute`` at Qwen3-8B's prefill and decode handoffs for
    offsets +1 and -1 over the ``pp`` axis of a 2 x 2 layout and over all
    four ranks and over one workspace, its autograd backward the shift by
    -offset, and its wrapper refusing empty and strided tensors; each call
    counts one launch, row 23 one a workspace half."""
    got = cuda_ranks.ok("cuda_collectives", dict(seed=9))
    for rank, res in enumerate(got):
        for case, (equal, same) in res["cases"].items():
            assert equal, f"rank {rank} {case}: the kernel's bits differ from the plain version's"
            assert same in (None, True), f"rank {rank} {case}: the ranks' outputs differ"
        assert res["launches"] == {"ring_ag_call": 6, "full_mesh_ag_call": 6, "ring_rs_call": 3,
                                   "one_shot_ar_call": 6, "p2p_kernel": 14}


@pytest.mark.parametrize("op,phase", [("one_shot", "ar_recv"), ("ring_rs", "rs_recv")])
def test_stalled_peer_ends_rows_21_22_in_a_named_abort(cuda, tmp_path, op, phase):
    """Rows 22 and 21 with a rank that never arrives end in
    ``CollectiveAbort`` naming the phase (row 22: and the absent peer; the
    ring names the neighbour each rank waited for)."""
    ranks = Ranks(tmp_path / "store", WORLD, device="cuda")
    try:
        got = ranks.ok("stall", dict(absent=WORLD - 1, timeout_s=2.0, op=op))
    finally:
        ranks.close()
    assert got[WORLD - 1] is None
    for rank, msg in enumerate(got[:WORLD - 1]):
        assert msg is not None and msg.startswith("CollectiveAbort"), msg
        peer = WORLD - 1 if op == "one_shot" else (rank - 1) % WORLD
        assert f"'{phase}'" in msg and f"rank {peer}" in msg, msg

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

from triton_dist_tpu_torch.kernels import (
    attention_reference,
    decode_reference,
    flash_attention,
    flash_decode,
    group_gemm_swiglu,
    group_swiglu_reference,
)
from triton_dist_tpu_torch.models import PRESETS, DenseLLM, DenseParams, Engine, Qwen3MoE, init_params

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


def _assert_close(got, want, dtype):
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


# (b, hq, hkv, sq, sk, d, causal, q_offset, kv_offset)
ATTN_CASES = {
    "causal-square-g1-d128": (2, 4, 4, 128, 128, 128, True, None, None),
    "causal-ragged-g4-d128": (1, 8, 2, 77, 77, 128, True, None, None),
    "causal-sq<sk-g8-d64": (1, 16, 2, 40, 200, 64, True, None, None),
    "causal-sq>sk-g2-d32": (1, 4, 2, 70, 30, 32, True, None, None),
    "noncausal-g2-d64": (2, 4, 2, 33, 95, 64, False, None, None),
    "offset-chunk-g4-d128": (1, 8, 2, 64, 256, 128, True, 100, 0),
    "offset-empty-rows-g4-d32": (1, 8, 2, 48, 96, 32, True, 0, 30),
}


@pytest.mark.parametrize("return_lse", [False, True], ids=["o", "o+lse"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("case", list(ATTN_CASES), ids=list(ATTN_CASES))
def test_flash_attention_kernel_vs_plain(cuda, case, dtype, return_lse):
    b, hq, hkv, sq, sk, d, causal, q_offset, kv_offset = ATTN_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(sum(map(ord, case)))
    q = _randn(gen, (b, hq, sq, d), dtype, cuda)
    k, v = _randn(gen, (b, hkv, sk, d), dtype, cuda), _randn(gen, (b, hkv, sk, d), dtype, cuda)
    kw = dict(causal=causal, return_lse=return_lse, q_offset=q_offset, kv_offset=kv_offset)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = attention_reference(q, k, v, **kw)
    if return_lse:
        _assert_close(got[0], want[0], dtype)
        torch.testing.assert_close(got[1], want[1], atol=1e-3, rtol=1e-5)
    else:
        _assert_close(got, want, dtype)


# (b, hq, hkv, s, d, lengths)
DECODE_CASES = {
    "g4-d128": (4, 32, 8, 512, 128, [1, 100, 512, 300]),
    "g1-d64": (3, 4, 4, 300, 64, [299, 0, 1]),
    "g2-d32": (2, 8, 4, 64, 32, [64, 33]),
    "g8-d128-len>s": (2, 16, 2, 96, 128, [96, 500]),
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

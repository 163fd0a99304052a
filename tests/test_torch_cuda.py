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
    paged_decode_reference,
    paged_flash_decode,
)
from triton_dist_tpu_torch.kernels import mega_decode as mk
from triton_dist_tpu_torch.kernels.flash_decode import gather_paged_kv
from triton_dist_tpu_torch.kernels.mega_moe import fused_moe_block, moe_block_reference
from triton_dist_tpu_torch.models.kv_cache import NULL_BLOCK
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


@pytest.mark.parametrize("b", MEGA_ROWS)
@pytest.mark.parametrize("size", list(MEGA_SIZES))
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_fused_ln_qkv_rope_kernel_vs_plain(cuda, dtype, size, b):
    d, _, hq, hkv, hd, _ = MEGA_SIZES[size]
    gen = torch.Generator(device=cuda).manual_seed(b + d)
    x = _randn(gen, (b, d), dtype, cuda)
    ln_w, qn, kn = _norm_weight(gen, d, dtype, cuda), _norm_weight(gen, hd, dtype, cuda), _norm_weight(gen, hd, dtype, cuda)
    wqkv = _weight(gen, (d, (hq + 2 * hkv) * hd), dtype, cuda)
    pos = torch.tensor([0, 1, 777, 2047, 5, 100, 1500, 9][:b], dtype=torch.int32, device=cuda)
    kw = dict(num_q_heads=hq, num_kv_heads=hkv, head_dim=hd, rope_theta=1e6, eps=1e-6)
    got = _counted(mk.fused_ln_qkv_rope, x, ln_w, wqkv, qn, kn, pos, **kw)
    want = mk.ln_qkv_rope_reference(x, ln_w, wqkv, qn, kn, pos, **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.is_contiguous()
        _assert_close(g, w, dtype)


@pytest.mark.parametrize("b", MEGA_ROWS)
@pytest.mark.parametrize("size", list(MEGA_SIZES))
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_fused_attn_back_kernel_vs_plain(cuda, dtype, size, b):
    """Lengths 0, S - 1 and S (the full cache, where nothing is spliced)
    among the rows, against the plain splice → decode → o-projection."""
    d, _, hq, hkv, hd, _ = MEGA_SIZES[size]
    s = 128 if size == "test" else 2048
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
    _assert_close(got, mk.attn_back_reference(q, kn, vn, kc, vc, lengths, wo), dtype)


@pytest.mark.parametrize("b", MEGA_ROWS)
@pytest.mark.parametrize("size", list(MEGA_SIZES))
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_fused_mlp_block_kernel_vs_plain(cuda, dtype, size, b):
    d, ff, *_ = MEGA_SIZES[size]
    gen = torch.Generator(device=cuda).manual_seed(b + d + 2)
    x = _randn(gen, (b, d), dtype, cuda)
    ln_w = _norm_weight(gen, d, dtype, cuda)
    wg, wu, wd = _weight(gen, (d, ff), dtype, cuda), _weight(gen, (d, ff), dtype, cuda), _weight(gen, (ff, d), dtype, cuda)
    for residual in (False, True):
        got = _counted(mk.fused_mlp_block, x, ln_w, wg, wu, wd, residual=residual)
        assert got.dtype == dtype
        _assert_close(got, mk.mlp_block_reference(x, ln_w, wg, wu, wd, residual=residual), dtype)


@pytest.mark.parametrize("b", MEGA_ROWS)
@pytest.mark.parametrize("size", list(MEGA_SIZES))
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_fused_norm_head_kernel_vs_plain(cuda, dtype, size, b):
    d, *_, vocab = MEGA_SIZES[size]
    gen = torch.Generator(device=cuda).manual_seed(b + d + 3)
    x = _randn(gen, (b, d), dtype, cuda)
    nw = _norm_weight(gen, d, dtype, cuda)
    head = _weight(gen, (d, vocab), dtype, cuda)
    got = _counted(mk.fused_norm_head, x, nw, head)
    assert got.dtype == torch.float32 and got.shape == (b, vocab)
    _assert_close(got, mk.norm_head_reference(x, nw, head), dtype)


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
    cfg = PRESETS[preset]
    cls = Qwen3MoE if cfg.is_moe else DenseLLM
    p_cpu = init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    p_gpu = DenseParams(**{k: None if t is None else t.to(cuda) for k, t in vars(p_cpu).items()})
    outs = []
    for model in (cls(cfg, p_cpu, device="cpu"), cls(cfg, p_gpu, device=cuda)):
        engine = Engine(model, backend="mega", max_len=32)
        paged = engine.alloc_paged(3, block_size=8, num_blocks=16)
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
        outs.append((out.cpu(), paged.lengths.cpu().tolist()))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=0, rtol=0)
    assert outs[1][1] == outs[0][1] == [9 + 6, 0, 4 + 4]

"""The port's mega decode backend held against the JAX package at
tensor-parallel world 1: the fused kernels' plain versions (what a CPU
tensor runs) against the JAX functions, the task graph's plans, and
``Engine(backend="mega")`` on the ``test-dense`` and ``test-moe`` presets
(fp32). The paged step, and ``Qwen3MoE`` served on mega, are held in
``test_torch_paged.py`` (one JAX engine per preset serves both).

The JAX side runs on a 1-device CPU mesh, its Pallas kernels in interpret
mode; the port runs with ``device="cpu"``. Inputs come from numpy seeds,
weights from JAX ``init_params`` through the port's weight bridge.
Tolerances: fp32 summed in another order, ``rtol = atol = 1e-4``; bf16
rounds at the same points but may land one bf16 step apart, ``2e-2``;
plans and greedy token streams must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.megakernel import ModelBuilder as JModelBuilder
from triton_dist_tpu.megakernel import kernels as jmk
from triton_dist_tpu.models import PRESETS as JPRESETS
from triton_dist_tpu.models import DenseLLM as JDenseLLM
from triton_dist_tpu.models import Engine as JEngine
from triton_dist_tpu_torch.kernels import decode_reference, paged_flash_decode
from triton_dist_tpu_torch.kernels.group_gemm import matmul_f32
from triton_dist_tpu_torch.megakernel import ModelBuilder, kernels as mk
from triton_dist_tpu_torch.models import PRESETS, DenseLLM, Engine, Qwen3MoE, init_params, params_from_numpy

torch.set_num_threads(2)  # six test workers share the host

TOL = {"fp32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
IDS = [[3, 17, 42, 7, 99, 5, 23, 11]]
CFG = PRESETS["test-dense"]  # d 64, ff 128, GQA 8/4, hd 32
MOE = PRESETS["test-moe"]  # the same attention; 8 experts, top-2, ff 48
S = 128


def _pair(a: np.ndarray, dt: str):
    """The same values as a JAX array and a torch tensor of dtype ``dt``
    (both round fp32 to bf16 to nearest even)."""
    return jnp.asarray(a, JDT[dt]), torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dt])


def _close(got: torch.Tensor, want, dt: str):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dt])


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_ln_qkv_rope_vs_jax(dt):
    rng = np.random.default_rng(0)
    b, d, hq, hkv, hd = 2, CFG.hidden_size, CFG.num_q_heads, CFG.num_kv_heads, CFG.head_dim
    args = [
        rng.standard_normal((b, d)).astype(np.float32),
        (rng.random(d) + 0.5).astype(np.float32),
        (rng.standard_normal((d, (hq + 2 * hkv) * hd)) * d ** -0.5).astype(np.float32),
        (rng.random(hd) + 0.5).astype(np.float32),
        (rng.random(hd) + 0.5).astype(np.float32),
    ]
    pos = np.asarray([3, 97], np.int32)
    ja, ta = zip(*(_pair(a, dt) for a in args))
    kw = dict(num_q_heads=hq, num_kv_heads=hkv, head_dim=hd, rope_theta=CFG.rope_theta, eps=CFG.rms_eps)
    want = jmk.fused_ln_qkv_rope(*ja, jnp.asarray(pos), **kw)
    got = mk.fused_ln_qkv_rope(*ta, torch.from_numpy(pos), **kw)
    for g, w in zip(got, want):
        assert g.dtype == TDT[dt] and g.is_contiguous()
        _close(g, w, dt)


def _attn_back_inputs(dt: str, seed: int):
    rng = np.random.default_rng(seed)
    b, hq, hkv, hd = 2, CFG.num_q_heads, CFG.num_kv_heads, CFG.head_dim
    arrays = [
        rng.standard_normal((b, hq, hd)),
        rng.standard_normal((b, hkv, hd)),
        rng.standard_normal((b, hkv, hd)),
        rng.standard_normal((b, hkv, S, hd)),
        rng.standard_normal((b, hkv, S, hd)),
        rng.standard_normal((hq * hd, CFG.hidden_size)) * 0.1,
    ]
    return zip(*(_pair(a.astype(np.float32), dt) for a in arrays))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_attn_back_vs_jax(dt):
    """Empty cache, a mid append, the last free row, and the full cache
    (length == S), where the new row is dropped."""
    ja, ta = _attn_back_inputs(dt, 1)
    for lengths in ([0, S - 1], [S, 17]):
        lens = np.asarray(lengths, np.int32)
        want = jmk.fused_attn_back(*ja[:5], jnp.asarray(lens), ja[5])
        got = mk.fused_attn_back(*ta[:5], torch.from_numpy(lens), ta[5])
        assert got.dtype == torch.float32
        _close(got, want, dt)


def test_attn_back_equals_its_composition():
    """The plain fused back-leg is the splice, the decode and one fp32
    product (the contract JAX holds for its kernel)."""
    _, (q, kn, vn, kc, vc, wo) = _attn_back_inputs("fp32", 2)
    b = q.shape[0]
    for lengths in ([0, S - 1], [S, 17]):
        lens = torch.tensor(lengths, dtype=torch.int32)
        kc2, vc2 = kc.clone(), vc.clone()
        for i, n in enumerate(lengths):
            if n < S:
                kc2[i, :, n], vc2[i, :, n] = kn[i], vn[i]
        want = matmul_f32(decode_reference(q, kc2, vc2, lens + 1).reshape(b, -1), wo)
        torch.testing.assert_close(mk.fused_attn_back(q, kn, vn, kc, vc, lens, wo), want,
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_mlp_block_vs_jax(dt):
    rng = np.random.default_rng(3)
    b, d, ff = 3, CFG.hidden_size, CFG.intermediate_size
    args = [
        rng.standard_normal((b, d)).astype(np.float32),
        (rng.random(d) + 0.5).astype(np.float32),
        (rng.standard_normal((d, ff)) * d ** -0.5).astype(np.float32),
        (rng.standard_normal((d, ff)) * d ** -0.5).astype(np.float32),
        (rng.standard_normal((ff, d)) * ff ** -0.5).astype(np.float32),
    ]
    ja, ta = zip(*(_pair(a, dt) for a in args))
    for residual in (False, True):
        want = jmk.fused_mlp_block(*ja, eps=CFG.rms_eps, residual=residual)
        got = mk.fused_mlp_block(*ta, eps=CFG.rms_eps, residual=residual)
        assert got.dtype == TDT[dt]
        _close(got, want, dt)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_norm_head_vs_jax(dt):
    rng = np.random.default_rng(4)
    b, d, v = 4, CFG.hidden_size, CFG.vocab_size
    args = [
        rng.standard_normal((b, d)).astype(np.float32),
        (rng.random(d) + 0.5).astype(np.float32),
        (rng.standard_normal((d, v)) * d ** -0.5).astype(np.float32),
    ]
    ja, ta = zip(*(_pair(a, dt) for a in args))
    want = jmk.fused_norm_head(*ja, eps=CFG.rms_eps)
    got = mk.fused_norm_head(*ta, eps=CFG.rms_eps)
    assert got.dtype == torch.float32
    _close(got, want, dt)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_moe_block_vs_jax(dt):
    """The routed-experts panels at test-moe sizes, capacity 8: expert 0
    holds three tokens, expert 5 one, the rest none (zero rows, as the
    dispatch pads them); the padded rows give zeros."""
    rng = np.random.default_rng(6)
    e, cap, d, ff = MOE.num_experts, 8, MOE.hidden_size, MOE.moe_intermediate_size
    xe = np.zeros((e, cap, d), np.float32)
    xe[0, :3] = rng.standard_normal((3, d))
    xe[5, :1] = rng.standard_normal((1, d))
    args = [xe, *(rng.standard_normal(s) * s[-2] ** -0.5 for s in ((e, d, ff), (e, d, ff), (e, ff, d)))]
    ja, ta = zip(*(_pair(a.astype(np.float32), dt) for a in args))
    want = jmk.fused_moe_block(*ja)
    got = mk.fused_moe_block(*ta)
    assert got.dtype == torch.float32 and got.shape == (e, cap, d)
    _close(got, want, dt)
    assert not got[1:5].any() and not got[0, 3:].any() and got[0, :3].abs().sum() > 0


def test_moe_block_cost_counts_live_experts():
    """The routed-experts bound counts the weights of the experts that hold
    a token, and 6·d·ff FLOPs per nonzero row: an all-zero panel gives
    y = 0 without its expert's weights."""
    from triton_dist_tpu_torch.kernels.mega_moe import moe_block_cost

    e, cap, d, ff = MOE.num_experts, 8, MOE.hidden_size, MOE.moe_intermediate_size
    xe = torch.zeros((e, cap, d), dtype=torch.bfloat16)
    xe[0, :3], xe[5, :1] = 1.0, -2.0
    flops, nbytes = moe_block_cost(xe, torch.empty((e, d, ff), dtype=torch.bfloat16))
    assert flops == 6 * 4 * d * ff
    assert nbytes == 2 * (e * cap * d + 3 * 2 * d * ff) + 4 * e * cap * d


@pytest.mark.parametrize("policy", ["static", "cost", "scoreboard"])
def test_step_plan_equals_jax(policy):
    want = JModelBuilder(JPRESETS["test-dense"], world=1, schedule_policy=policy).build_step_fn(2).plan
    mb = ModelBuilder(CFG, schedule_policy=policy)
    got = mb.build_step_fn(2).plan
    assert got == want
    assert mb.graph.stats["policy"] == policy
    if policy == "scoreboard":  # layer 0's cache scatter waits behind layer 1's front
        assert got.index("cache_update@0→standalone_cache_update") > got.index("attn_front@1→fused_attn_front")


@pytest.mark.parametrize("policy", ["static", "cost", "scoreboard"])
def test_moe_step_plan_equals_jax(policy):
    """test-moe: under every policy each layer's moe task lowers to the
    routed-experts kernel, as in JAX."""
    want = JModelBuilder(JPRESETS["test-moe"], world=1, schedule_policy=policy).build_step_fn(2).plan
    got = ModelBuilder(MOE, schedule_policy=policy).build_step_fn(2).plan
    assert got == want
    assert "moe_block@0→fused_moe_ex" in got and "moe_block@1→fused_moe_ex" in got


def _random_layer(rng):
    d, hq, hkv, hd, ff = CFG.hidden_size, CFG.num_q_heads, CFG.num_kv_heads, CFG.head_dim, CFG.intermediate_size
    shapes = {"ln1": (d,), "wqkv": (d, (hq + 2 * hkv) * hd), "q_norm": (hd,), "k_norm": (hd,),
              "wo": (hq * hd, d), "ln2": (d,), "mlp_gate": (d, ff), "mlp_up": (d, ff), "mlp_down": (ff, d)}
    return {k: torch.from_numpy((rng.standard_normal(s) * 0.1).astype(np.float32)) for k, s in shapes.items()}


def test_pinned_flash_decode_lowers_standalone():
    """pin_standalone("flash_decode") breaks the attn_back chain in both
    packages; the port's pinned layer agrees with its fused one."""
    def pinned(builder):
        builder.make_attn_front()
        builder.make_attn_back()
        builder.make_mlp_block()
        builder.graph.pin_standalone("flash_decode")
        return builder.build_layer_fn()

    fused = ModelBuilder(CFG).build_layer_fn()
    assert "attn_back→fused_attn_back_ex" in fused.plan
    pin = pinned(ModelBuilder(CFG))
    assert pin.plan == pinned(JModelBuilder(JPRESETS["test-dense"], world=1)).plan
    assert "flash_decode→standalone_flash_decode" in pin.plan
    assert not any("fused_attn_back" in p for p in pin.plan)

    rng = np.random.default_rng(7)
    lp = _random_layer(rng)
    b, hkv, hd = 2, CFG.num_kv_heads, CFG.head_dim
    x = torch.from_numpy(rng.standard_normal((b, CFG.hidden_size)).astype(np.float32))
    ks = torch.from_numpy(rng.standard_normal((1, b, hkv, 32, hd)).astype(np.float32))
    vs = torch.from_numpy(rng.standard_normal((1, b, hkv, 32, hd)).astype(np.float32))
    lengths = torch.tensor([3, 17], dtype=torch.int32)
    x_f, k_f, v_f = fused(lp, x, ks.clone(), vs.clone(), 0, lengths)
    x_p, k_p, v_p = pin(lp, x, ks.clone(), vs.clone(), 0, lengths)
    torch.testing.assert_close(x_f, x_p, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(k_f, k_p, rtol=0, atol=0)
    torch.testing.assert_close(v_f, v_p, rtol=0, atol=0)
    assert not torch.equal(k_f, ks)  # the new rows were written


def _moe_layer(rng):
    d, hq, hkv, hd = MOE.hidden_size, MOE.num_q_heads, MOE.num_kv_heads, MOE.head_dim
    e, ff = MOE.num_experts, MOE.moe_intermediate_size
    shapes = {"ln1": (d,), "wqkv": (d, (hq + 2 * hkv) * hd), "q_norm": (hd,), "k_norm": (hd,),
              "wo": (hq * hd, d), "ln2": (d,), "router": (d, e), "mlp_gate": (e, d, ff),
              "mlp_up": (e, d, ff), "mlp_down": (e, ff, d)}
    lp = {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in shapes.items()}
    for k in ("ln1", "q_norm", "k_norm", "ln2"):
        lp[k] += 1.0
    return {k: torch.from_numpy(v) for k, v in lp.items()}


def test_pinned_moe_lowers_standalone():
    """The moe task lowers through the routed-experts kernel;
    pin_standalone("moe") falls back to TP_MoE in both packages, with the
    same layer result."""
    def pinned(builder):
        builder.make_attn_front()
        builder.make_attn_back()
        builder.make_moe_block()
        builder.graph.pin_standalone("moe")
        return builder.build_layer_fn()

    fused = ModelBuilder(MOE).build_layer_fn()
    assert "moe_block→fused_moe_ex" in fused.plan
    assert fused.plan == JModelBuilder(JPRESETS["test-moe"], world=1).build_layer_fn().plan
    pin = pinned(ModelBuilder(MOE))
    assert pin.plan == pinned(JModelBuilder(JPRESETS["test-moe"], world=1)).plan
    assert "moe→standalone_moe" in pin.plan

    rng = np.random.default_rng(11)
    lp = _moe_layer(rng)
    b, s, hkv, hd = 2, 16, MOE.num_kv_heads, MOE.head_dim
    x = torch.from_numpy((rng.standard_normal((b, MOE.hidden_size)) * 0.5).astype(np.float32))
    ks, vs = torch.zeros((1, b, hkv, s, hd)), torch.zeros((1, b, hkv, s, hd))
    lengths = torch.tensor([3, 7], dtype=torch.int32)
    x_f, k_f, v_f = fused(lp, x, ks.clone(), vs.clone(), 0, lengths)
    x_p, k_p, v_p = pin(lp, x, ks.clone(), vs.clone(), 0, lengths)
    torch.testing.assert_close(x_f, x_p, rtol=1e-5, atol=1e-6)
    assert torch.equal(k_f, k_p) and torch.equal(v_f, v_p)


@pytest.fixture(scope="module")
def models():
    from triton_dist_tpu.runtime.mesh import initialize_distributed
    from triton_dist_tpu.runtime.platform import cpu_mesh

    mesh = cpu_mesh((1,), ("tp",))
    ctx = initialize_distributed(devices=list(mesh.devices.flat), axis_names=("tp",), set_default=False)
    jmodel = JDenseLLM(JPRESETS["test-dense"], ctx, key=jax.random.PRNGKey(1))
    arrays = {f.name: None if getattr(jmodel.params, f.name) is None
              else np.asarray(getattr(jmodel.params, f.name)) for f in dataclasses.fields(jmodel.params)}
    tmodel = DenseLLM(CFG, params_from_numpy(arrays, CFG, "cpu"), device="cpu")
    return JEngine(jmodel, backend="mega", max_len=32), tmodel


def test_mega_serve_equals_jax_mega_and_dist(models):
    jeng, tmodel = models
    want = np.asarray(jeng.serve(jnp.asarray(IDS, jnp.int32), gen_len=6))
    engine = Engine(tmodel, backend="mega", max_len=32)
    assert engine.prefill_mode == "dist_ar" and engine.decode_mode == "mega"
    got = engine.serve(torch.tensor(IDS), gen_len=6)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(Engine(tmodel, backend="dist", max_len=32).serve(torch.tensor(IDS), 6).numpy(),
                                  want)
    assert engine.kv_cache.lengths.tolist() == [len(IDS[0]) + 6 - 1]


def test_mega_slot_decode_equals_jax(models):
    """Three slots, slot 1 never joined (free): it re-feeds its token, emits
    -1 and keeps its length, as in JAX."""
    jeng, tmodel = models
    prompts = {0: [5, 9, 13, 2, 77], 2: [3, 17, 42, 7, 99, 5, 23, 11]}
    remaining = np.asarray([4, 0, 2], np.int32)
    chunk = 4

    jcache = jeng.alloc_slots(3)
    teng = Engine(tmodel, backend="mega", max_len=32)
    tcache = teng.alloc_slots(3)
    jtok, ttok = [0, 0, 0], [0, 0, 0]
    for slot, ids in prompts.items():
        t0, jcache = jeng.prefill_into_slot(jcache, slot, jnp.asarray([ids], jnp.int32))
        jtok[slot] = int(t0)
        t0, tcache = teng.prefill_into_slot(tcache, slot, torch.tensor([ids]))
        ttok[slot] = int(t0)
    assert ttok == jtok
    jout, jlast, jcache, jrem = jeng.decode_steps(jcache, jnp.asarray(jtok, jnp.int32),
                                                  jnp.asarray(remaining), chunk)
    tout, tlast, tcache, trem = teng.decode_steps(tcache, torch.tensor(ttok, dtype=torch.int32),
                                                  torch.from_numpy(remaining), chunk)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
    np.testing.assert_array_equal(trem.numpy(), np.asarray(jrem))
    assert tcache.lengths.tolist() == np.asarray(jcache.lengths).tolist() == [5 + 4, 0, 8 + 2]
    assert (tout[1] == -1).all() and (tout[2, 2:] == -1).all()
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), **TOL["fp32"])


def test_unported_mega_paths_raise():
    """What the port still leaves out raises, naming its ROADMAP item,
    rather than falling back to another path: prefix seeding (item A), the
    speculative verify step (item C). A quantized walk given one scale pool
    and not the other raises ``ValueError``, as JAX's assert does."""
    model = Qwen3MoE(MOE, init_params(MOE, torch.Generator().manual_seed(0), "cpu"), device="cpu")
    engine = Engine(model, backend="mega", max_len=32)
    paged = engine.alloc_paged(2, block_size=8, num_blocks=8)
    q = torch.zeros(2, MOE.num_q_heads, MOE.head_dim)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        paged_flash_decode(q, paged.k[0], paged.v[0], paged.tables, paged.lengths, k_scale=paged.k[0])
    with pytest.raises(NotImplementedError, match="item A"):
        engine.paged_seed_kbuf(paged, paged.tables[0], 8, 12)
    with pytest.raises(NotImplementedError, match="item C"):
        ModelBuilder(MOE).build_verify_fn(MOE.num_layers, 4)
    with pytest.raises(NotImplementedError, match="item C"):
        engine.spec_decode_steps_paged(paged, None, paged.lengths, paged.lengths, 2, 4)

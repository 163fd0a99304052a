"""The port's MoE path held against the JAX package at tensor-parallel
world 1: routing (``topk_routing``, ``make_routing_plan``, ``dispatch``,
``combine``), the grouped gate/up SwiGLU (its plain version, which is what a
CPU tensor runs), ``TP_MoE`` in each of its three modes, and
``Qwen3MoE`` on the ``test-moe`` preset (fp32) through ``Engine``.

The JAX side runs on a 1-device CPU mesh, its Pallas kernel in interpret
mode; the port runs with ``device="cpu"``. Inputs come from numpy seeds,
weights from JAX ``init_params`` through the port's weight bridge.
Tolerance: fp32 summed in another order, ``rtol = atol = 1e-4``; routing
plans, dispatched buffers and greedy token streams must be equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.kernels import moe_utils as jmoe
from triton_dist_tpu.kernels.group_gemm import group_gemm_swiglu as jax_group_gemm_swiglu
from triton_dist_tpu.layers.tp import MOE_CAPACITY_FACTOR as JMOE_CAPACITY_FACTOR
from triton_dist_tpu.layers.tp import TP_MoE as JTP_MoE
from triton_dist_tpu.models import PRESETS as JPRESETS
from triton_dist_tpu.models import Engine as JEngine
from triton_dist_tpu.models import Qwen3MoE as JQwen3MoE
from triton_dist_tpu_torch.kernels import group_gemm_swiglu
from triton_dist_tpu_torch.kernels.moe_utils import (
    capacity_for,
    combine,
    dispatch,
    make_routing_plan,
    topk_routing,
)
from triton_dist_tpu_torch.layers import MOE_CAPACITY_FACTOR, TP_MoE
from triton_dist_tpu_torch.models import PRESETS, Engine, Qwen3MoE, init_params, params_from_numpy

# Six test workers share the host with the JAX suite: keep torch's intra-op
# pool small.
torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
IDS = [[3, 17, 42, 7, 99, 5, 23, 11, 64, 2]]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def moe_models():
    from triton_dist_tpu.runtime.mesh import initialize_distributed
    from triton_dist_tpu.runtime.platform import cpu_mesh

    mesh = cpu_mesh((1,), ("tp",))
    ctx = initialize_distributed(devices=list(mesh.devices.flat), axis_names=("tp",),
                                 set_default=False)
    jmodel = JQwen3MoE(JPRESETS["test-moe"], ctx, key=jax.random.PRNGKey(2))
    arrays = {f.name: np.asarray(getattr(jmodel.params, f.name))
              for f in dataclasses.fields(jmodel.params)}
    cfg = PRESETS["test-moe"]
    tmodel = Qwen3MoE(cfg, params_from_numpy(arrays, cfg, "cpu"), device="cpu")
    return jmodel, tmodel


@pytest.fixture(scope="module")
def moe_engines(moe_models):
    """One JAX and one port ``Engine`` shared by the engine tests, so each
    JAX program compiles once per shape for the whole module."""
    jmodel, tmodel = moe_models
    return JEngine(jmodel, backend="dist", max_len=32), Engine(tmodel, backend="dist", max_len=32)


@pytest.mark.parametrize("tokens,want", [(1, 8), (4, 8), (96, 16), (384, 56), (777, 104), (1500, 192)])
def test_capacity_for_the_served_shapes(tokens, want):
    """Qwen3-30B-A3B (E = 128, top-8, factor 2.0): the port and JAX agree."""
    assert capacity_for(tokens, 8, 128, MOE_CAPACITY_FACTOR) == want
    assert jmoe.capacity_for(tokens, 8, 128, JMOE_CAPACITY_FACTOR) == want


def _router_logits(case: str) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "random":
        return rng.standard_normal((16, 8)).astype(np.float32)
    if case == "tie":
        # Rows with equal probabilities: top-k must prefer the lower expert id.
        x = rng.standard_normal((6, 8)).astype(np.float32)
        x[0] = 0.0
        x[1, [1, 4, 6]] = 3.0
        x[2, [2, 7]] = x[2].max() + 1.0
        x[3, :] = 1.5
        x[3, 5] = 2.0
        return x
    # "overflow": expert 3 wins every one of 40 tokens; with top-2 of 8
    # experts the capacity is 24, so 16 assignments to expert 3 are dropped.
    x = rng.standard_normal((40, 8)).astype(np.float32)
    x[:, 3] += 20.0
    return x


@functools.partial(jax.jit, static_argnums=(3, 4))
def _jax_route(logits, x, y, k, cap):
    """The JAX side of one routing case as one program (op-by-op dispatch
    would compile every primitive on its own): top-k, the plan's arrays,
    the dispatched buffer and the fp32 combine of ``y``."""
    t, e = logits.shape
    idx, w = jmoe.topk_routing(logits, k)
    plan = jmoe.make_routing_plan(idx, e, cap)
    out = jmoe.combine(y, plan, w, t, out_dtype=jnp.float32)
    return idx, w, (plan.slot, plan.keep, plan.token_of_slot), jmoe.dispatch(x, plan), out


@pytest.mark.parametrize("case", ["random", "tie", "overflow"])
def test_routing_dispatch_combine_vs_jax(case):
    logits = _router_logits(case)
    t, e, k = logits.shape[0], logits.shape[1], 2
    cap = capacity_for(t, k, e, MOE_CAPACITY_FACTOR)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((t, 32)).astype(np.float32)
    y = rng.standard_normal((e, cap, 32)).astype(np.float32)
    y[0, 0] = np.inf  # slot 0, which every dropped assignment aliases
    j_idx, j_w, j_plan, j_xe, want = _jax_route(jnp.asarray(logits), jnp.asarray(x),
                                                jnp.asarray(y), k, cap)

    idx, w = topk_routing(_t(logits), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(w.numpy(), np.asarray(j_w), **TOL)

    plan = make_routing_plan(idx, e, cap)
    assert plan.capacity == cap and plan.num_experts == e
    for name, j_arr in zip(("slot", "keep", "token_of_slot"), j_plan):
        np.testing.assert_array_equal(getattr(plan, name).numpy(), np.asarray(j_arr))
    if case == "overflow":
        assert cap == 24
        assert (idx[:, 0] == 3).all()
        assert int((~plan.keep).sum()) == 40 - cap
        # FIFO: the first 24 tokens keep expert 3, the last 16 lose it.
        assert plan.keep[:cap, 0].all() and not plan.keep[cap:, 0].any()
    if case == "tie":
        assert idx[0].tolist() == [0, 1] and idx[1].tolist() == [1, 4]
        assert idx[2].tolist() == [2, 7] and idx[3].tolist() == [5, 0]

    np.testing.assert_array_equal(dispatch(_t(x), plan).numpy(), np.asarray(j_xe))
    got = combine(_t(y), plan, w, t, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if case == "overflow":
        assert np.isfinite(got.numpy()[cap:]).all()  # dropped, not 0 × inf


@pytest.mark.parametrize("c", [8, 24])
def test_group_gemm_swiglu_vs_jax(c):
    e, d, f = 8, 64, 48  # test-moe's experts
    rng = np.random.default_rng(c)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    wg = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    wu = (rng.standard_normal((e, d, f)) / np.sqrt(d)).astype(np.float32)
    want = jax_group_gemm_swiglu(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu))
    before = group_gemm_swiglu.launches
    got = group_gemm_swiglu(_t(x), _t(wg), _t(wu))
    assert group_gemm_swiglu.launches == before  # a CPU tensor launches nothing
    assert got.shape == (e, c, f) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _layer0_moe(jmodel):
    c, p = jmodel.config, jmodel.params
    return JTP_MoE(w_router=p.router[0], w_gate=p.mlp_gate[0], w_up=p.mlp_up[0],
                   w_down=p.mlp_down[0], top_k=c.top_k, capacity_factor=JMOE_CAPACITY_FACTOR,
                   axis="tp", mesh_axes=jmodel.ctx.axis_names)


@pytest.mark.parametrize("tokens", [5, 16])
@pytest.mark.parametrize("mode", ["dist", "dist_ar", "xla"])
def test_tp_moe_vs_jax(moe_models, mode, tokens):
    jmodel, tmodel = moe_models
    tmoe = tmodel.layers[0][3]
    assert isinstance(tmoe, TP_MoE) and MOE_CAPACITY_FACTOR == JMOE_CAPACITY_FACTOR
    x = np.random.default_rng(tokens).standard_normal((tokens, jmodel.config.hidden_size))
    x = x.astype(np.float32)
    fn = jax.jit(jax.shard_map(lambda m, x_: m(x_, mode=mode), mesh=jmodel.ctx.mesh,
                               in_specs=(P(), P()), out_specs=P(), check_vma=False))
    want = fn(_layer0_moe(jmodel), jnp.asarray(x))
    got = tmoe(_t(x), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_qwen3moe_prefill_vs_jax(moe_models, moe_engines):
    jmodel, tmodel = moe_models
    jeng, _ = moe_engines
    want_logits, want_k, want_v = jeng._prefill(jmodel.params, jnp.asarray(IDS, jnp.int32))
    got_logits, (got_k, got_v) = tmodel.prefill(torch.tensor(IDS))
    assert got_logits.dtype == torch.float32 and got_logits.shape == (1, 256)
    for g, w in ((got_logits, want_logits), (got_k, want_k), (got_v, want_v)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_qwen3moe_engine_serve_greedy_equals_jax(moe_engines):
    jeng, teng = moe_engines
    want = np.asarray(jeng.serve(jnp.asarray(IDS, jnp.int32), gen_len=6))
    got = teng.serve(torch.tensor(IDS), gen_len=6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_qwen3moe_slots_prefill_and_decode_steps_equal_jax(moe_engines):
    """A 5-token prompt (prefill's T < 8 branch) and a 10-token one (the
    ``tp_moe_rs_shard`` branch) joined into two slots, then decoded
    together (the unchunked T < 8 decode branch)."""
    jeng, teng = moe_engines
    prompts = [[5, 9, 13, 2, 77], IDS[0]]
    remaining = np.asarray([3, 2], np.int32)
    jcache, tcache = jeng.alloc_slots(2), teng.alloc_slots(2)
    jtok, ttok = [], []
    for slot, ids in enumerate(prompts):
        t0, jcache = jeng.prefill_into_slot(jcache, slot, jnp.asarray([ids], jnp.int32))
        jtok.append(int(t0))
        t0, tcache = teng.prefill_into_slot(tcache, slot, torch.tensor([ids]))
        ttok.append(int(t0))
    assert ttok == jtok
    jout, _, jcache, _ = jeng.decode_steps(jcache, jnp.asarray(jtok, jnp.int32),
                                           jnp.asarray(remaining), 3)
    tout, _, tcache, _ = teng.decode_steps(tcache, torch.tensor(ttok, dtype=torch.int32),
                                           torch.from_numpy(remaining), 3)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tcache.lengths.numpy(), np.asarray(jcache.lengths))
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), **TOL)


def test_moe_weights_bridge_and_init():
    cfg = PRESETS["test-moe"]
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    L, e, d, ffe = cfg.num_layers, cfg.num_experts, cfg.hidden_size, cfg.moe_intermediate_size
    assert p.mlp_gate.shape == (L, e, d, ffe) and p.mlp_down.shape == (L, e, ffe, d)
    assert p.router.shape == (L, d, e)
    assert abs(p.router.std().item() - 0.02) < 0.004
    assert abs(p.mlp_down.std().item() - ffe ** -0.5) < 0.02
    arrays = {k: None if v is None else v.numpy() for k, v in vars(p).items()}
    back = params_from_numpy(arrays, cfg, "cpu")
    assert torch.equal(back.router, p.router) and torch.equal(back.mlp_up, p.mlp_up)
    arrays["mlp_gate"] = arrays["mlp_gate"][:, :-1]
    with pytest.raises(ValueError, match="mlp_gate"):
        params_from_numpy(arrays, cfg, "cpu")
    with pytest.raises(ValueError, match="MoE config"):
        Qwen3MoE(PRESETS["test-dense"], device="cpu")

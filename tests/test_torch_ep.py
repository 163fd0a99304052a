"""The port's expert-parallel MoE on the CPU, held against the JAX package.

Four rank processes (``tests/test_torch_tp_ranks.py``: ``gloo`` over a file
store, one torch thread each, importing only the port) are started once for
the module; on CPU tensors every kernel wrapper runs its plain version. This
process computes the JAX side on a 4-device CPU mesh under ``shard_map``
with JAX's plain transport (``use_pallas=False``): JAX's one-sided Pallas
all-to-all does not lower on every CPU jax ('semaphore_read'). JAX's fused
EP kernel (``_fused_ep_kernel``) does run here in the generic interpreter,
so ``ep_moe_fused_kernel_shard`` and ``fused_dispatch_mlp_shard`` are held
against it. The port runs each route with its one-sided transport on
(``use_pallas=True``: rows 25 and 26's plain versions) and off.

The model-level references: JAX's ``xla`` engine for the port's ``xla``
engine; for the port's ``dist`` and ``dist_ar`` engines a JAX ``EPMoELLM``
whose MoE calls take the port engine's route (``_RouteAs``) while its dense
parts run JAX's ``xla`` mode (JAX's own ``dist`` engines at world 4 need
Pallas collective matmuls); at world 1 JAX's ``dist`` engine.

Inputs are standard normals made with numpy. Tolerances: fp32 summed in
another order, ``1e-5`` per function and ``1e-4`` for a model's logits;
token streams, capacity drops, all-to-all outputs and the fp8 payload
bytes and scales are compared exactly.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from test_torch_tp_ranks import Ranks

from triton_dist_tpu.kernels import ep_a2a as jep
from triton_dist_tpu.kernels import ep_fused as jfused
from triton_dist_tpu.kernels import low_latency_a2a as jll
from triton_dist_tpu.kernels import moe_utils as jmu
from triton_dist_tpu.models import PRESETS as JPRESETS
from triton_dist_tpu.models import Engine as JEngine
from triton_dist_tpu.models.moe import EPMoELLM as JEPMoELLM
from triton_dist_tpu_torch.kernels import ep_fused, low_latency_a2a, moe_utils
from triton_dist_tpu_torch.models import PRESETS, Engine, EPMoELLM, params_from_numpy

torch.set_num_threads(2)  # six test workers share the host

WORLD = 4
OP_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
CFG = PRESETS["test-moe"]
D, E, FF, K = CFG.hidden_size, CFG.num_experts, CFG.moe_intermediate_size, CFG.top_k
E_LOCAL = E // WORLD
# Tokens per rank on both sides of the crossover (32).
T_SIDES = (8, 40)


@pytest.fixture(scope="module", autouse=True)
def _single_device_kernels():
    """JAX builds without the TPU interpret classes run the Pallas kernels
    (``group_gemm_swiglu``, ``_fused_ep_kernel``) in the generic HLO
    interpreter, as ``tests/test_moe_ep.py`` does."""
    from triton_dist_tpu.runtime.platform import tpu_interpret_available

    if tpu_interpret_available():
        yield
        return
    prev = os.environ.get("TDT_INTERPRET_FALLBACK")
    os.environ["TDT_INTERPRET_FALLBACK"] = "1"
    jax.clear_caches()
    yield
    if prev is None:
        os.environ.pop("TDT_INTERPRET_FALLBACK", None)
    else:
        os.environ["TDT_INTERPRET_FALLBACK"] = prev
    jax.clear_caches()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(tmp_path_factory.mktemp("ep") / "store", WORLD)
    yield r
    r.close()


@pytest.fixture(scope="module")
def mesh4():
    from triton_dist_tpu.runtime.mesh import initialize_distributed
    from triton_dist_tpu.runtime.platform import cpu_mesh

    m = cpu_mesh((WORLD,), ("tp",))
    return initialize_distributed(devices=list(m.devices.flat), axis_names=("tp",), set_default=False)


def _smap(ctx, fn, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=ctx.mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False))


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _routing(rng, t):
    """(T, K) distinct experts per token and (T, K) weights, for WORLD ranks."""
    idx = np.stack([np.stack([rng.permutation(E)[:K] for _ in range(t)]) for _ in range(WORLD)]).astype(np.int32)
    return idx, _f32(rng, WORLD, t, K)


def _experts(rng):
    return {"w_router": _f32(rng, D, E), "w_gate": _f32(rng, E, D, FF, scale=D ** -0.5),
            "w_up": _f32(rng, E, D, FF, scale=D ** -0.5), "w_down": _f32(rng, E, FF, D, scale=FF ** -0.5)}


def _local(w, r):
    """Rank r's whole experts of an (E, ...) slab."""
    return w[r * E_LOCAL:(r + 1) * E_LOCAL]


def _rank_weights(ws, r):
    return {"w_router": ws["w_router"], **{k: _local(ws[k], r) for k in ("w_gate", "w_up", "w_down")}}


# ------------------------------------------------------------- host-only parts


def test_regroup_and_ungroup_equal_jax():
    rng = np.random.default_rng(0)
    recv = _f32(rng, WORLD, E_LOCAL * 8, D)
    got = moe_utils.regroup_by_expert(torch.from_numpy(recv), WORLD, E_LOCAL, 8)
    want = np.asarray(jmu.regroup_by_expert(jnp.asarray(recv), WORLD, E_LOCAL, 8))
    np.testing.assert_array_equal(got.numpy(), want)
    back = moe_utils.ungroup_to_peers(got, WORLD, E_LOCAL, 8)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jmu.ungroup_to_peers(jnp.asarray(want), WORLD, E_LOCAL, 8)))
    np.testing.assert_array_equal(back.numpy(), recv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_payload_and_scales_bitwise_equal_jax(dtype):
    rng = np.random.default_rng(1)
    x = _f32(rng, 64, D, scale=3.0)
    x[5] = 0.0  # a zero row: scale 1
    x[9, :3] = [1e-30, -448.0 * 7, 0.5]  # tiny, large and exact values
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jll.quantize_fp8(jx)
    tq, ts = low_latency_a2a.quantize_fp8(tx)
    np.testing.assert_array_equal(tq.view(torch.uint8).numpy(), np.asarray(jq).view(np.uint8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = low_latency_a2a.dequantize_fp8(tq, ts, torch.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jll.dequantize_fp8(jq, js, jnp.float32)))


def test_routers_and_route_rule_equal_jax():
    for world in (1, 2, 4, 8):
        for t in (1, 4, 31, 32, 33, 96, 384, 1500):
            assert low_latency_a2a.get_auto_ep_moe_method(t, world).value == \
                jll.get_auto_ep_moe_method(t, world).value, (t, world)
    for world, cap, d, ff, combine, fp8 in ((4, 48, 2048, 768, True, False), (4, 2000, 2048, 768, True, False),
                                           (4, 8, 64, 48, False, True), (8, 4096, 4096, 1536, False, False)):
        assert ep_fused.fused_moe_supported(world, cap, d, ff, 2, combine=combine, wire_fp8=fp8) == \
            jfused.fused_moe_supported(world, cap, d, ff, 2, combine=combine, wire_fp8=fp8)


# ------------------------------------------------------------ world 4, by function


@pytest.mark.parametrize("shape,dtype", [((WORLD, 24, 16), np.float32), ((WORLD, 16, 64), np.int8),
                                         ((WORLD, 6, 1), np.float32)], ids=["f32", "int8", "scales"])
def test_all_to_all_single_shard_equals_jax(ranks, mesh4, shape, dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((WORLD, *shape)) * 50).astype(dtype)
    fn = lambda xs: jep.all_to_all_single_shard(xs[0], axis="tp", use_pallas=False)[None]  # noqa: E731
    want = np.asarray(_smap(mesh4, fn, (P("tp"),), P("tp"))(x))
    for use_pallas in (True, False):
        got = ranks.ok("ep_op", [dict(op="a2a", x=x[r], use_pallas=use_pallas) for r in range(WORLD)])
        for r in range(WORLD):
            np.testing.assert_array_equal(got[r], want[r], err_msg=f"use_pallas={use_pallas}")
            np.testing.assert_array_equal(got[r], x[:, r])  # out[p] = rank p's chunk for me


def _jax_dispatch_combine(mesh4, x, idx, w, scale, cap, ll):
    """JAX dispatch → per-expert scale → combine under shard_map, plain
    transport (``ll``: the fp8-wire low-latency pair)."""
    def fn(x_, i_, w_, s_):
        kw = dict(num_experts=E, capacity=cap, axis="tp", use_pallas=False)
        if ll:
            disp = jll.ll_dispatch_shard(x_[0], i_[0], wire_fp8=True, **kw)
            out = jll.ll_combine_shard(disp.expert_inputs * s_[:, None, None], disp, w_[0], axis="tp",
                                       use_pallas=False)
        else:
            disp = jep.ep_dispatch_shard(x_[0], i_[0], **kw)
            out = jep.ep_combine_shard(disp.expert_inputs * s_[:, None, None], disp, w_[0], axis="tp",
                                       use_pallas=False)
        return disp.expert_inputs[None], out[None]

    res = _smap(mesh4, fn, (P("tp"), P("tp"), P("tp"), P("tp")), (P("tp"), P("tp")))(x, idx, w, scale)
    return [np.asarray(a) for a in res]


@pytest.mark.parametrize("ll", [False, True], ids=["plain", "low_latency_fp8"])
@pytest.mark.parametrize("t", T_SIDES)
def test_dispatch_combine_equal_jax(ranks, mesh4, t, ll):
    """``ep_dispatch_shard``/``ep_combine_shard`` and the fp8-wire
    ``ll_dispatch_shard``/``ll_combine_shard`` (a capacity of 8 drops
    assignments at T = 40): the plain panels exactly, the combine within
    1e-5. The fp8 panels are held within 1e-5: under ``jit`` XLA turns the
    scale's division by 448 into a product with float32(1/448), one ulp
    off in some scales, while the port divides as ``quantize_fp8`` reads
    (its bits equal JAX's op-by-op ``quantize_fp8``, above)."""
    rng = np.random.default_rng(3 + t)
    x = _f32(rng, WORLD, t, D)
    idx, w = _routing(rng, t)
    scale = (1.0 + np.arange(E, dtype=np.float32))  # expert e scales its rows by e + 1
    cap = 8
    want_in, want_out = _jax_dispatch_combine(mesh4, x, idx, w, scale, cap, ll)
    op = "ll_dispatch_combine" if ll else "dispatch_combine"
    for use_pallas in (True, False):
        got = ranks.ok("ep_op", [dict(op=op, x=x[r], idx=idx[r], w=w[r], scale=_local(scale, r), num_experts=E,
                                      capacity=cap, use_pallas=use_pallas, wire_fp8=True) for r in range(WORLD)])
        for r in range(WORLD):
            if ll:
                np.testing.assert_allclose(got[r]["expert_inputs"], want_in[r], **OP_TOL, err_msg=f"rank {r}")
                # the same slots hold tokens: capacity drops are equal
                np.testing.assert_array_equal(got[r]["expert_inputs"] != 0, want_in[r] != 0)
            else:
                np.testing.assert_array_equal(got[r]["expert_inputs"], want_in[r], err_msg=f"rank {r}")
            np.testing.assert_allclose(got[r]["out"], want_out[r], **OP_TOL, err_msg=f"rank {r}")


def _jax_moe(mesh4, fn, x, ws):
    specs = (P("tp"), P(), P("tp"), P("tp"), P("tp"))
    return np.asarray(_smap(mesh4, lambda x_, *w_: fn(x_[0], *w_)[None], specs, P("tp"))(
        x, ws["w_router"], ws["w_gate"], ws["w_up"], ws["w_down"]))


@pytest.mark.parametrize("t", T_SIDES)
def test_ep_moe_ll_shard_equals_jax(ranks, mesh4, t):
    rng = np.random.default_rng(10 + t)
    x, ws = _f32(rng, WORLD, t, D), _experts(rng)
    kw = dict(num_experts=E, top_k=K, capacity_factor=2.0)
    want = _jax_moe(mesh4, lambda *a: jll.ep_moe_ll_shard(*a, **kw, axis="tp", use_pallas=False), x, ws)
    for use_pallas in (True, False):
        got = ranks.ok("ep_op", [dict(op="ll_moe", x=x[r], **_rank_weights(ws, r), top_k=K, num_experts=E,
                                      capacity_factor=2.0, use_pallas=use_pallas, wire_fp8=True)
                                 for r in range(WORLD)])
        np.testing.assert_allclose(np.stack(got), want, **OP_TOL)


@pytest.mark.parametrize("variant", ["combine_in_kernel", "two_step", "fp8_wire"])
def test_ep_moe_fused_kernel_shard_equals_jax_kernel(ranks, mesh4, variant):
    """The port's ``ep_moe_fused_kernel_shard`` (row 26's plain version, or
    26b's) against JAX's, which runs its Pallas kernel here."""
    t = 40
    rng = np.random.default_rng(20)
    x, ws = _f32(rng, WORLD, t, D), _experts(rng)
    kw = dict(num_experts=E, top_k=K, capacity_factor=2.0)
    vkw = {"combine_in_kernel": dict(combine_in_kernel=True, wire_fp8=False),
           "two_step": dict(combine_in_kernel=False, wire_fp8=False),
           "fp8_wire": dict(combine_in_kernel=True, wire_fp8=True)}[variant]
    want = _jax_moe(mesh4, lambda *a: jfused.ep_moe_fused_kernel_shard(*a, **kw, **vkw, axis="tp",
                                                                        mesh_axes=("tp",)), x, ws)
    got = ranks.ok("ep_op", [dict(op="fused_moe", x=x[r], **_rank_weights(ws, r), top_k=K, num_experts=E,
                                  capacity_factor=2.0, use_pallas=True, **vkw) for r in range(WORLD)])
    np.testing.assert_allclose(np.stack(got), want, **OP_TOL)


@pytest.mark.parametrize("combine", [True, False], ids=["mlp_combine", "mlp"])
def test_fused_dispatch_mlp_shards_equal_jax_kernel(ranks, mesh4, combine):
    """``fused_dispatch_mlp_combine_shard`` (row 26) and
    ``fused_dispatch_mlp_shard`` (26b) on a slot grid with empty slots."""
    cap = 8
    rng = np.random.default_rng(30)
    send = _f32(rng, WORLD, WORLD, E_LOCAL * cap, D)
    send[:, :, 5:cap] = 0.0  # the empty slots of expert 0
    ws = _experts(rng)
    jfn = jfused.fused_dispatch_mlp_combine_shard if combine else jfused.fused_dispatch_mlp_shard
    specs = (P("tp"), P("tp"), P("tp"), P("tp"))
    want = np.asarray(_smap(mesh4, lambda s, g, u, dn: jfn(s[0], g, u, dn, capacity=cap, axis="tp",
                                                            mesh_axes=("tp",))[None], specs, P("tp"))(
        send, ws["w_gate"], ws["w_up"], ws["w_down"]))
    got = ranks.ok("ep_op", [dict(op="fused_mlp_combine" if combine else "fused_mlp", send=send[r],
                                  **_rank_weights(ws, r), capacity=cap, wire_fp8=False) for r in range(WORLD)])
    np.testing.assert_allclose(np.stack(got), want, **OP_TOL)


# ------------------------------------------------------------ world 4, the model


@pytest.fixture(scope="module")
def jmodel(mesh4):
    return JEPMoELLM(JPRESETS["test-moe"], mesh4, key=jax.random.PRNGKey(3), use_pallas_a2a=False)


@pytest.fixture(scope="module")
def arrays(jmodel):
    return {f.name: None if getattr(jmodel.params, f.name) is None else np.asarray(getattr(jmodel.params, f.name))
            for f in dataclasses.fields(jmodel.params)}


def test_params_from_numpy_takes_the_jax_ep_shards(jmodel, arrays, mesh4):
    devices = list(mesh4.mesh.devices.flat)
    for rank in range(WORLD):
        params = params_from_numpy(arrays, CFG, "cpu", rank=rank, world=WORLD, expert_parallel=True)
        for f in dataclasses.fields(jmodel.params):
            jarr = getattr(jmodel.params, f.name)
            shard = next(s for s in jarr.addressable_shards if s.device == devices[rank])
            np.testing.assert_array_equal(getattr(params, f.name).numpy(), np.asarray(shard.data), err_msg=f.name)


@pytest.mark.parametrize("t", T_SIDES)
@pytest.mark.parametrize("mode", ["xla", "dist", "dist_ar"])
def test_ep_mlp_routes_equal_jax(ranks, mesh4, jmodel, arrays, mode, t):
    """``EPMoELLM._ep_mlp(lp, x, mode)`` of layer 1: ``dist`` takes each
    rank's T rows, ``xla`` and ``dist_ar`` the same T rows on every rank."""
    rng = np.random.default_rng(40 + t)
    p = jmodel.params
    lp = [p.router[1], p.mlp_gate[1], p.mlp_up[1], p.mlp_down[1]]
    sharded = mode == "dist"
    x = _f32(rng, WORLD * t if sharded else t, D)

    def fn(r, g, u, dn, x_):
        y = jmodel._ep_mlp({"router": r, "mlp_gate": g, "mlp_up": u, "mlp_down": dn}, x_, mode)
        return y if sharded else y[None]

    want = np.asarray(_smap(mesh4, fn, (P(), P("tp"), P("tp"), P("tp"), P("tp") if sharded else P()), P("tp"))(
        *lp, x))
    want = want.reshape(WORLD, t, D)
    for use_pallas in (True, False):
        got = ranks.ok("ep_mlp", [dict(arrays=arrays, layer=1, x=x[r * t:(r + 1) * t] if sharded else x, mode=mode,
                                       use_pallas_a2a=use_pallas) for r in range(WORLD)])
        np.testing.assert_allclose(np.stack(got), want, **OP_TOL, err_msg=f"use_pallas_a2a={use_pallas}")


# Prompts of 136 tokens (34 rows a rank in a dist prefill, 136 replicated:
# above the crossover, the fused route) and of 12 or 16 (below it, the
# fp8-wire low-latency route, as every decode step is). The port's dist
# engine serves DIST_PROMPTS, its dist_ar engine DIST_AR_PROMPTS, so one
# _RouteAs engine tells their prefills apart by length and compiles one
# decode program for both.
DIST_PROMPTS = [list(np.random.default_rng(7).integers(0, 256, 136)), [5, 9, 13, 2, 77, 1, 8, 200, 31, 4, 6, 90]]
DIST_AR_PROMPTS = [list(np.random.default_rng(8).integers(0, 256, 132)), list(range(40, 56))]
REMAINING, CHUNK, MAX_LEN = [4, 2], 4, 160


class _RouteAs(JEPMoELLM):
    """JAX ``EPMoELLM`` on its ``xla`` engine whose MoE calls take the routes
    of the port's ``dist`` and ``dist_ar`` engines: a prefill of a
    ``DIST_PROMPTS`` length runs each rank's 1/world of the rows in
    ``dist`` mode and gathers the outputs, as the port's ``dist`` prefill
    does; every other call (the ``dist_ar`` prefills, every decode step)
    runs the replicated tokens in ``dist_ar`` mode."""

    _phase = "prefill"

    def prefill_shard(self, p, tokens, mode):
        self._phase = ("dist" if tokens.shape[0] * tokens.shape[1] in {len(q) for q in DIST_PROMPTS}
                       else "dist_ar")
        return super().prefill_shard(p, tokens, mode)

    def decode_shard(self, *args, **kwargs):
        self._phase = "dist_ar"
        return super().decode_shard(*args, **kwargs)

    def _ep_mlp(self, lp, x, mode):
        if self._phase == "dist":
            chunk = x.shape[0] // self.world
            me = jax.lax.axis_index(self.axis)
            y = super()._ep_mlp(lp, jax.lax.dynamic_slice(x, (me * chunk, 0), (chunk, x.shape[1])), "dist")
            return jax.lax.all_gather(y, self.axis, axis=0, tiled=True)
        return super()._ep_mlp(lp, x, "dist_ar")


def _jax_run(eng, params, prompts):
    """The first logits of the shorter prompt's prefill, then both prompts
    through ``prefill_into_slot`` and ``decode_steps``."""
    logits = np.asarray(eng._prefill(params, jnp.asarray([prompts[1]], jnp.int32))[0])
    cache = eng.alloc_slots(len(prompts))
    first = []
    for slot, p in enumerate(prompts):
        t0, cache = eng.prefill_into_slot(cache, slot, jnp.asarray([p], jnp.int32))
        first.append(int(t0))
    out, _, cache, _ = eng.decode_steps(cache, jnp.asarray(first, jnp.int32), jnp.asarray(REMAINING, jnp.int32),
                                        CHUNK)
    return {"logits": logits, "first": first, "out": np.asarray(out), "lengths": np.asarray(cache.lengths)}


@pytest.fixture(scope="module")
def route_as_engine(mesh4, jmodel):
    ref = _RouteAs(JPRESETS["test-moe"], mesh4, params=jmodel.params, use_pallas_a2a=False)
    return JEngine(ref, backend="xla", max_len=MAX_LEN)


@pytest.mark.parametrize("backend", ["xla", "dist", "dist_ar"])
def test_engine_world4_equals_jax(ranks, jmodel, arrays, route_as_engine, backend):
    prompts = DIST_AR_PROMPTS if backend == "dist_ar" else DIST_PROMPTS
    if backend == "xla":
        want = _jax_run(JEngine(jmodel, backend="xla", max_len=MAX_LEN), jmodel.params, prompts)
    else:
        want = _jax_run(route_as_engine, jmodel.params, prompts)
    got = ranks.ok("serve", dict(arrays=arrays, backend=backend, ids=[prompts[1]], gen_len=0, prompts=prompts,
                                 remaining=REMAINING, chunk=CHUNK, max_len=MAX_LEN, ep=True))
    for g in got:
        np.testing.assert_allclose(g["logits"], want["logits"], **LOGIT_TOL)
        assert g["first"] == want["first"]
        np.testing.assert_array_equal(g["out"], want["out"])
        np.testing.assert_array_equal(g["lengths"], want["lengths"])


def test_engine_world1_equals_jax_dist():
    from triton_dist_tpu.runtime.mesh import initialize_distributed
    from triton_dist_tpu.runtime.platform import cpu_mesh

    m = cpu_mesh((1,), ("tp",))
    ctx1 = initialize_distributed(devices=list(m.devices.flat), axis_names=("tp",), set_default=False)
    jm = JEPMoELLM(JPRESETS["test-moe"], ctx1, key=jax.random.PRNGKey(4), use_pallas_a2a=True)
    want = _jax_run(JEngine(jm, backend="dist", max_len=MAX_LEN), jm.params, DIST_PROMPTS)
    arrays = {f.name: np.asarray(getattr(jm.params, f.name)) for f in dataclasses.fields(jm.params)}
    model = EPMoELLM(CFG, params_from_numpy(arrays, CFG, "cpu", expert_parallel=True), device="cpu",
                     use_pallas_a2a=True)
    # At world 1 the all-to-alls are identities and no route quantises, so
    # the port's three backends hold to JAX's dist engine alike.
    for backend in ("dist", "dist_ar", "xla"):
        eng = Engine(model, backend=backend, max_len=MAX_LEN)
        logits = model.prefill(torch.tensor([DIST_PROMPTS[1]]), mode=eng.prefill_mode)[0]
        np.testing.assert_allclose(logits.numpy(), want["logits"], **LOGIT_TOL, err_msg=backend)
        cache = eng.alloc_slots(len(DIST_PROMPTS))
        first = [int(eng.prefill_into_slot(cache, slot, torch.tensor([p]))[0]) for slot, p in enumerate(DIST_PROMPTS)]
        assert first == want["first"], backend
        out, _, cache, _ = eng.decode_steps(cache, torch.tensor(first, dtype=torch.int32), torch.tensor(REMAINING),
                                            CHUNK)
        np.testing.assert_array_equal(out.numpy(), want["out"], err_msg=backend)
        np.testing.assert_array_equal(cache.lengths.numpy(), want["lengths"], err_msg=backend)


def test_unported_ep_paths_raise():
    """The mega backend names what it waits for; the CUDA-only variants of
    row 26 (26b) raise on CUDA tensors only, so here their plain versions
    run (above)."""
    model = EPMoELLM(CFG, device="cpu", generator=torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="moe_impl"):
        Engine(model, backend="mega")
    with pytest.raises(ValueError, match="MoE config"):
        EPMoELLM(PRESETS["test-dense"], device="cpu")

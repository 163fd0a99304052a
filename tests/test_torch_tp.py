"""The port at tensor-parallel world 4 on the CPU, held against the JAX
package on a 4-device CPU mesh.

Four rank processes (``tests/test_torch_tp_ranks.py``, one ``gloo`` group over a
file store, one torch thread each) are started once for the module and
import only the port; they run the plain versions. This process computes
the JAX side and hands both sides the same numpy inputs. JAX's own
``Engine(backend="dist")`` needs Pallas collectives that do not lower on
every CPU jax, and JAX holds ``dist`` == ``xla`` == ``dist_ar`` at world 4
(``tests/test_models.py``), so the reference is its ``xla`` backend and, for
the collective matmuls, ``shard_map`` over ``XLA_AG_THEN_GEMM`` / ``XLA``.

Inputs are standard normals and weights at the models' fan-in scale.
Tolerances: fp32 products summed in another order, ``1e-5`` for single
collective matmuls and ``1e-4`` for a model's logits; token streams and the
outputs that every rank must share bitwise are compared exactly.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_tp_ranks import Ranks
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.kernels import allgather_gemm as jag
from triton_dist_tpu.kernels import gemm_allreduce as jar
from triton_dist_tpu.kernels import gemm_reduce_scatter as jrs
from triton_dist_tpu.models import PRESETS as JPRESETS
from triton_dist_tpu.models import DenseLLM as JDenseLLM
from triton_dist_tpu.models import Engine as JEngine
from triton_dist_tpu_torch.kernels import allgather_gemm as ag
from triton_dist_tpu_torch.kernels import gemm_allreduce as ar
from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as rs
from triton_dist_tpu_torch.models import PRESETS, params_from_numpy

torch.set_num_threads(2)  # six test workers share the host

WORLD = 4
OP_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(tmp_path_factory.mktemp("tp") / "store", WORLD)
    yield r
    r.close()


@pytest.fixture(scope="module")
def mesh4():
    from triton_dist_tpu.runtime.mesh import initialize_distributed
    from triton_dist_tpu.runtime.platform import cpu_mesh

    m = cpu_mesh((WORLD,), ("tp",))
    return initialize_distributed(devices=list(m.devices.flat), axis_names=("tp",), set_default=False)


def _shard_map(ctx, fn, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=ctx.mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False))


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _weight(rng, k, n):
    """A (k, n) weight at the model's fan-in scale, 1/sqrt(k)."""
    return _f32(rng, k, n, scale=k ** -0.5)


def test_plain_collectives(ranks):
    rng = _rng(0)
    xs = [_f32(rng, 8, 6) for _ in range(WORLD)]
    got = ranks.ok("collectives", [{"x": x} for x in xs])
    total = xs[0].copy()
    for x in xs[1:]:
        total += x  # rank order, as psum adds
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["all_gather0"], np.concatenate(xs, 0))
        np.testing.assert_array_equal(g["all_gather1"], np.concatenate(xs, 1))
        np.testing.assert_array_equal(g["psum"], total)
        np.testing.assert_array_equal(g["psum_scatter"], total[2 * r:2 * r + 2])
        for s, chunk in enumerate(g["ring"]):
            np.testing.assert_array_equal(chunk, xs[(r - s) % WORLD])


# m per rank for AG (8: the ring, 40: above the crossover), m for RS (8 and
# 264) and AR (3 ragged, 4, 68).
AG_M, RS_M, AR_M = (8, 40), (8, 264), (3, 4, 68)
K_LOCAL, N = 16, 64


@pytest.mark.parametrize("swiglu", [False, True], ids=["ag", "ag_swiglu"])
@pytest.mark.parametrize("m", AG_M)
def test_ag_gemm_routes_vs_jax(ranks, mesh4, m, swiglu):
    rng = _rng(m)
    a = _f32(rng, WORLD * m, 64)
    bs = [_weight(rng, 64, WORLD * 32) for _ in range(2 if swiglu else 1)]
    if swiglu:
        fn = lambda x, g, u: jag.ag_gemm_swiglu_shard(x, g, u, axis="tp",  # noqa: E731
                                                      method=jag.AGGemmMethod.XLA_AG_THEN_GEMM)
    else:
        fn = lambda x, b: jag.ag_gemm_shard(x, b, axis="tp",  # noqa: E731
                                            method=jag.AGGemmMethod.XLA_AG_THEN_GEMM)
    want = np.asarray(_shard_map(mesh4, fn, (P("tp"),) + (P(None, "tp"),) * len(bs), P(None, "tp"))(a, *bs))
    for method in ("auto", "xla_ring", "xla_ag_then_gemm", "pallas_fused"):
        got = ranks.ok("matmuls", [
            {"op": "ag_swiglu" if swiglu else "ag", "method": method, "a": a[r * m:(r + 1) * m],
             "bs": [b[:, r * 32:(r + 1) * 32] for b in bs]} for r in range(WORLD)])
        np.testing.assert_allclose(np.concatenate(got, 1), want, **OP_TOL, err_msg=method)


@pytest.mark.parametrize("m", RS_M)
def test_gemm_rs_routes_vs_jax(ranks, mesh4, m):
    rng = _rng(100 + m)
    a, b = _f32(rng, m, WORLD * K_LOCAL), _weight(rng, WORLD * K_LOCAL, N)
    fn = lambda x, w: jrs.gemm_rs_shard(x, w, axis="tp", method=jrs.GemmRSMethod.XLA)  # noqa: E731
    want = np.asarray(_shard_map(mesh4, fn, (P(None, "tp"), P("tp")), P("tp"))(a, b))
    for method in ("auto", "xla", "xla_ring", "pallas_fused"):
        got = ranks.ok("matmuls", [
            {"op": "rs", "method": method, "a": a[:, r * K_LOCAL:(r + 1) * K_LOCAL],
             "bs": [b[r * K_LOCAL:(r + 1) * K_LOCAL]]} for r in range(WORLD)])
        np.testing.assert_allclose(np.concatenate(got, 0), want, **OP_TOL, err_msg=method)


@pytest.mark.parametrize("m", AR_M)
def test_gemm_ar_routes_vs_jax_and_equal_on_every_rank(ranks, mesh4, m):
    rng = _rng(200 + m)
    a, b = _f32(rng, m, WORLD * K_LOCAL), _weight(rng, WORLD * K_LOCAL, N)
    fn = lambda x, w: jar.gemm_ar_shard(x, w, axis="tp", method=jar.GemmARMethod.XLA)  # noqa: E731
    want = np.asarray(_shard_map(mesh4, fn, (P(None, "tp"), P("tp")), P())(a, b))
    methods = ("auto", "xla", "ll_one_shot") + (("pallas_fused",) if m % WORLD == 0 else ())
    for method in methods:
        got = ranks.ok("matmuls", [
            {"op": "ar", "method": method, "a": a[:, r * K_LOCAL:(r + 1) * K_LOCAL],
             "bs": [b[r * K_LOCAL:(r + 1) * K_LOCAL]]} for r in range(WORLD)])
        np.testing.assert_allclose(got[0], want, **OP_TOL, err_msg=method)
        for g in got[1:]:
            np.testing.assert_array_equal(g, got[0])  # replicated: the same bits on every rank


def test_unported_routes_raise():
    ctx = types.SimpleNamespace(world=WORLD)
    a, b = torch.zeros(8, 8), torch.zeros(8, 8)
    with pytest.raises(NotImplementedError, match="rows 7 and 21"):
        rs.gemm_rs_shard(ctx, a, b, method=rs.GemmRSMethod.PALLAS)
    with pytest.raises(NotImplementedError, match="row 22"):
        ar.gemm_ar_shard(ctx, a, b, method=ar.GemmARMethod.ONE_SHOT)
    with pytest.raises(NotImplementedError, match="rows 20 and"):
        ar.gemm_ar_shard(ctx, a, b, method=ar.GemmARMethod.RS_AG)


ROUTER_M = (1, 2, 3, 4, 8, 31, 32, 33, 63, 64, 65, 100, 255, 256, 257, 260, 384, 1024)


@pytest.mark.parametrize("world", (2, 4, 8))
def test_auto_routers_equal_jax(world):
    for m in ROUTER_M:
        assert (ag.get_auto_ag_gemm_method(m, 4096, 1536, torch.bfloat16, world).value
                == jag.get_auto_ag_gemm_method(m, 4096, 1536, jnp.bfloat16, world).value), m
        assert rs.get_auto_gemm_rs_method(m, world).value == jrs.get_auto_gemm_rs_method(m, world).value, m
        assert ar.get_auto_gemm_ar_method(m, world).value == jar.get_auto_gemm_ar_method(m, world).value, m


@pytest.fixture(scope="module")
def jmodel(mesh4):
    return JDenseLLM(JPRESETS["test-dense"], mesh4, key=jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def arrays(jmodel):
    return {f.name: None if getattr(jmodel.params, f.name) is None else np.asarray(getattr(jmodel.params, f.name))
            for f in dataclasses.fields(jmodel.params)}


def test_params_from_numpy_takes_the_jax_shards(jmodel, arrays, mesh4):
    devices = list(mesh4.mesh.devices.flat)
    cfg = PRESETS["test-dense"]
    for rank in range(WORLD):
        params = params_from_numpy(arrays, cfg, "cpu", rank=rank, world=WORLD)
        for f in dataclasses.fields(jmodel.params):
            jarr = getattr(jmodel.params, f.name)
            if jarr is None:
                assert getattr(params, f.name) is None
                continue
            shard = next(s for s in jarr.addressable_shards if s.device == devices[rank])
            np.testing.assert_array_equal(getattr(params, f.name).numpy(), np.asarray(shard.data), err_msg=f.name)


SERVE_IDS = [[3, 17, 42, 7, 99, 5, 23, 11]]
# A prompt of 264 tokens takes the fused routes' plain versions: m_shard 66
# > 32 (AG), m 264 > 256 (RS) in dist mode, m 264 > 64 (AR) in dist_ar.
SLOT_PROMPTS = [list(np.random.default_rng(7).integers(0, 256, 264)), [5, 9, 13, 2, 77, 1, 8, 200, 31, 4, 6, 90]]
REMAINING, CHUNK, GEN, MAX_LEN = [4, 2], 4, 6, 288


@pytest.fixture(scope="module")
def jax_reference(jmodel):
    eng = JEngine(jmodel, backend="xla", max_len=MAX_LEN)
    ids = jnp.asarray(SERVE_IDS, jnp.int32)
    logits = np.asarray(eng._prefill(jmodel.params, ids)[0])
    served = np.asarray(eng.serve(ids, gen_len=GEN))
    cache = eng.alloc_slots(len(SLOT_PROMPTS))
    first = []
    for slot, p in enumerate(SLOT_PROMPTS):
        t0, cache = eng.prefill_into_slot(cache, slot, jnp.asarray([p], jnp.int32))
        first.append(int(t0))
    out, _, cache, _ = eng.decode_steps(cache, jnp.asarray(first, jnp.int32), jnp.asarray(REMAINING, jnp.int32),
                                        CHUNK)
    return {"logits": logits, "served": served, "first": first, "out": np.asarray(out),
            "lengths": np.asarray(cache.lengths), "k": np.asarray(cache.k)}


@pytest.mark.parametrize("backend", ["dist", "dist_ar", "xla"])
def test_engine_world4_equals_jax_xla(ranks, arrays, jax_reference, backend):
    got = ranks.ok("serve", dict(arrays=arrays, backend=backend, ids=SERVE_IDS, gen_len=GEN, prompts=SLOT_PROMPTS,
                                 remaining=REMAINING, chunk=CHUNK, max_len=MAX_LEN))
    want = jax_reference
    hk = want["k"].shape[2] // WORLD
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["logits"], want["logits"], **LOGIT_TOL)
        np.testing.assert_array_equal(g["served"], want["served"])
        assert g["first"] == want["first"]
        np.testing.assert_array_equal(g["out"], want["out"])
        np.testing.assert_array_equal(g["lengths"], want["lengths"])
        # each rank's cache holds its kv heads of the global cache
        np.testing.assert_allclose(g["k"], want["k"][:, :, r * hk:(r + 1) * hk], **LOGIT_TOL)


def test_dist_prefill_needs_rows_divisible_by_world(ranks, arrays):
    answers = ranks.run("dist_prefill", dict(arrays=arrays, ids=[[1, 2, 3, 4, 5, 6, 7]]))
    for status, value in answers:
        assert status == "err" and value.startswith("ValueError") and "not divisible" in value


def test_unported_world4_paths_raise():
    """MoE, the mega backend and the paged pool at world > 1 raise, naming
    the rest of ROADMAP item B (no collective runs before they do)."""
    from triton_dist_tpu_torch.models import DenseLLM, Engine, Qwen3MoE

    ctx = types.SimpleNamespace(rank=0, world=WORLD, device=torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="item B"):
        Qwen3MoE(PRESETS["test-moe"], ctx=ctx, generator=gen)
    model = DenseLLM(PRESETS["test-dense"], ctx=ctx, generator=gen)
    assert model.params.wqkv.shape[-1] == (8 + 2 * 4) * 32 // WORLD and model.params.wo.shape[1] == 8 * 32 // WORLD
    with pytest.raises(NotImplementedError, match="item B"):
        Engine(model, backend="mega")
    with pytest.raises(NotImplementedError, match="item B"):
        Engine(model, backend="dist").alloc_paged(2, block_size=16, num_blocks=5)

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

The standalone collectives (rows 20-22) are held three ways: against
JAX's ``XLA`` route of the same function (its Pallas collectives do not
lower on the CPU), within ``1e-6`` in fp32; bitwise against a numpy
transcription, in this file, of the TPU kernels' summation order and
rounding; and the all-reduces' output the same bits on every rank.

Inputs are standard normals and weights at the models' fan-in scale.
Tolerances: fp32 products summed in another order, ``1e-5`` for single
collective matmuls and MoE layers and ``1e-4`` for a model's logits; bf16
collectives against XLA's sums ``2e-2`` (two bf16 steps: the ring rounds
after every hop); token streams and the outputs that every rank must share
bitwise are compared exactly.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from test_torch_tp_ranks import Ranks
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.kernels import allgather as jcag
from triton_dist_tpu.kernels import allgather_gemm as jag
from triton_dist_tpu.kernels import allreduce as jcar
from triton_dist_tpu.kernels import gemm_allreduce as jar
from triton_dist_tpu.kernels import gemm_reduce_scatter as jrs
from triton_dist_tpu.kernels.reduce_scatter import reduce_scatter_shard as j_reduce_scatter_shard
from triton_dist_tpu.layers.tp import TP_MoE as JTP_MoE
from triton_dist_tpu.megakernel import ModelBuilder as JModelBuilder
from triton_dist_tpu.models import PRESETS as JPRESETS
from triton_dist_tpu.models import DenseLLM as JDenseLLM
from triton_dist_tpu.models import Engine as JEngine
from triton_dist_tpu.models import Qwen3MoE as JQwen3MoE
from triton_dist_tpu_torch.kernels import allgather as cag
from triton_dist_tpu_torch.kernels import allgather_gemm as ag
from triton_dist_tpu_torch.kernels import allreduce as car
from triton_dist_tpu_torch.kernels import gemm_allreduce as ar
from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as rs
from triton_dist_tpu_torch.kernels import moe_utils as mu
from triton_dist_tpu_torch.megakernel import ModelBuilder
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
    methods = ("auto", "xla", "ll_one_shot", "one_shot") + (("pallas_fused", "rs_ag") if m % WORLD == 0 else ())
    for method in methods:
        got = ranks.ok("matmuls", [
            {"op": "ar", "method": method, "a": a[:, r * K_LOCAL:(r + 1) * K_LOCAL],
             "bs": [b[r * K_LOCAL:(r + 1) * K_LOCAL]]} for r in range(WORLD)])
        np.testing.assert_allclose(got[0], want, **OP_TOL, err_msg=method)
        for g in got[1:]:
            np.testing.assert_array_equal(g, got[0])  # replicated: the same bits on every rank


# The quantized A operand (rows 16q-19q): every route the port runs, at the
# shapes above (AUTO takes the fused kernels at m_shard 40, m 264 and 68,
# the low-latency one at the ragged m 3).
QUANT_ROUTES = {
    "ag": ((40,), ("auto", "xla_ring", "xla_ag_then_gemm", "pallas_fused")),
    "ag_swiglu": ((40,), ("auto", "xla_ring", "xla_ag_then_gemm", "pallas_fused")),
    "rs": ((264,), ("auto", "xla", "xla_ring", "pallas_fused")),
    "ar": ((68, 3), ("auto", "xla", "ll_one_shot", "one_shot", "pallas_fused", "rs_ag")),
}
#: Bands of the quantized ops against the fp32 product on the dequantized
#: operand (``docs/quantization.md``).
QUANT_BAND = {"ag": 1e-3, "ag_swiglu": 1e-2, "rs": 1e-3, "ar": 1e-3}


@pytest.mark.parametrize("wire", ("int8", "fp8"))
@pytest.mark.parametrize("op", tuple(QUANT_ROUTES))
def test_quant_matmul_routes_vs_jax(ranks, mesh4, op, wire):
    """A ``QuantTensor`` A (JAX's payload and scales, carried by the
    bridge): every route within ``1e-5`` of JAX's XLA route on the same
    quantized operand and inside the band of the fp32 product on the
    dequantized operand; the all-reduces' output the same bits on every
    rank."""
    from triton_dist_tpu.models import quant as jq

    sizes, methods = QUANT_ROUTES[op]
    for m in sizes:
        rng = _rng(400 + m)
        if op.startswith("ag"):
            a = _f32(rng, WORLD * m, 64)
            bs = [_weight(rng, 64, WORLD * 32) for _ in range(2 if op == "ag_swiglu" else 1)]
            aq = jq.quantize_tensor(jnp.asarray(a), wire)
            if op == "ag":
                fn = lambda x, b: jag.ag_gemm_shard(x, b, axis="tp",  # noqa: E731
                                                    method=jag.AGGemmMethod.XLA_AG_THEN_GEMM)
            else:
                fn = lambda x, g, u: jag.ag_gemm_swiglu_shard(x, g, u, axis="tp",  # noqa: E731
                                                              method=jag.AGGemmMethod.XLA_AG_THEN_GEMM)
            want = np.asarray(_shard_map(mesh4, fn, (P("tp"),) + (P(None, "tp"),) * len(bs), P(None, "tp"))(aq, *bs))
            deq = np.asarray(jq.dequantize_tensor(aq))
            g = deq @ bs[0]
            band_ref = g if op == "ag" else np.asarray(jax.nn.silu(g)) * (deq @ bs[1])
            shards = [(np.asarray(aq.q)[r * m:(r + 1) * m], np.asarray(aq.scale)[r * m:(r + 1) * m],
                       [b[:, r * 32:(r + 1) * 32] for b in bs]) for r in range(WORLD)]
        else:
            a, b = _f32(rng, m, WORLD * K_LOCAL), _weight(rng, WORLD * K_LOCAL, N)
            if op == "rs":
                fn = lambda x, w: jrs.gemm_rs_shard(jq.quantize_tensor(x, wire), w, axis="tp",  # noqa: E731
                                                    method=jrs.GemmRSMethod.XLA)
            else:
                fn = lambda x, w: jar.gemm_ar_shard(jq.quantize_tensor(x, wire), w, axis="tp",  # noqa: E731
                                                    method=jar.GemmARMethod.XLA)
            want = np.asarray(_shard_map(mesh4, fn, (P(None, "tp"), P("tp")), P("tp") if op == "rs" else P())(a, b))
            qs = [jq.quantize_tensor(jnp.asarray(a[:, r * K_LOCAL:(r + 1) * K_LOCAL]), wire) for r in range(WORLD)]
            band_ref = sum(np.asarray(jq.dequantize_tensor(t)) @ b[r * K_LOCAL:(r + 1) * K_LOCAL]
                           for r, t in enumerate(qs))
            shards = [(np.asarray(t.q), np.asarray(t.scale), [b[r * K_LOCAL:(r + 1) * K_LOCAL]])
                      for r, t in enumerate(qs)]
        got = ranks.ok("quant_matmuls", [
            {"op": op, "methods": methods if m % WORLD == 0 else methods[:4], "q": q.view(np.uint8), "scale": sc,
             "wire": wire, "bs": ws} for q, sc, ws in shards])
        for method in got[0]:
            if op.startswith("ag"):
                out = np.concatenate([g[method] for g in got], 1)
            elif op == "rs":
                out = np.concatenate([g[method] for g in got], 0)
            else:
                out = got[0][method]
                for g in got[1:]:
                    np.testing.assert_array_equal(g[method], out, err_msg=method)  # the same bits on every rank
            np.testing.assert_allclose(out, want, **OP_TOL, err_msg=f"{method} m={m}")
            np.testing.assert_allclose(out, band_ref, rtol=0, atol=QUANT_BAND[op], err_msg=f"{method} m={m}")


def test_unported_routes_raise(ranks):
    """``GemmARMethod.ONE_SHOT`` and ``RS_AG`` run now (rows 22 and 20; their
    values are held against JAX above); ``GemmRSMethod.PALLAS`` still
    raises, naming the GEMM kernel it waits for (row 7)."""
    rng = _rng(300)
    a, b = _f32(rng, 8, WORLD * K_LOCAL), _weight(rng, WORLD * K_LOCAL, N)
    for method in ("one_shot", "rs_ag"):
        got = ranks.ok("matmuls", [
            {"op": "ar", "method": method, "a": a[:, r * K_LOCAL:(r + 1) * K_LOCAL],
             "bs": [b[r * K_LOCAL:(r + 1) * K_LOCAL]]} for r in range(WORLD)])
        assert all(g.shape == (8, N) for g in got), method
    ctx = types.SimpleNamespace(world=WORLD)
    with pytest.raises(NotImplementedError, match=r"row 7\b"):
        rs.gemm_rs_shard(ctx, torch.zeros(8, 8), torch.zeros(8, 8), method=rs.GemmRSMethod.PALLAS)


ROUTER_M = (1, 2, 3, 4, 8, 31, 32, 33, 63, 64, 65, 100, 255, 256, 257, 260, 384, 1024)


@pytest.mark.parametrize("world", (2, 4, 8))
def test_auto_routers_equal_jax(world):
    for m in ROUTER_M:
        assert (ag.get_auto_ag_gemm_method(m, 4096, 1536, torch.bfloat16, world).value
                == jag.get_auto_ag_gemm_method(m, 4096, 1536, jnp.bfloat16, world).value), m
        assert rs.get_auto_gemm_rs_method(m, world).value == jrs.get_auto_gemm_rs_method(m, world).value, m
        assert ar.get_auto_gemm_ar_method(m, world).value == jar.get_auto_gemm_ar_method(m, world).value, m


BYTE_SIZES = (1, 16, 4096, 65536, 131071, 131072, 131073, 262143, 262144, 262145, 1 << 20, 48 << 20)


@pytest.mark.parametrize("world", (2, 4, 8))
def test_auto_collective_routers_equal_jax(world):
    for nbytes in BYTE_SIZES:
        assert (cag.get_auto_all_gather_method(nbytes, world).value
                == jcag.get_auto_all_gather_method(nbytes, world).value), nbytes
        assert (car.get_auto_all_reduce_method(nbytes, world).value
                == jcar.get_auto_all_reduce_method(nbytes, world).value), nbytes


# ------------------------------------------------ rows 20-22, the collectives

BF16 = ml_dtypes.bfloat16


def _round(a, dtype):
    return a.astype(np.float32).astype(dtype)


def ring_rs_numpy(xs, rank):
    """The TPU ring's chunk ``rank`` (``reduce_scatter.py:54-150``): chunk c
    starts at rank c + 1 (``:86``) and gains rank me's partial at every hop
    in fp32, rounded to the wire dtype (``:140-141``), ending at rank c."""
    w = len(xs)
    c = xs[0].shape[0] // w
    part = [x[rank * c:(rank + 1) * c] for x in xs]
    acc = part[(rank + 1) % w]
    for k in range(2, w + 1):
        acc = _round(acc.astype(np.float32) + part[(rank + k) % w].astype(np.float32), xs[0].dtype)
    return acc


def one_shot_numpy(xs):
    """The TPU one-shot kernel's sum (``allreduce.py:164-174``): an fp32
    accumulator from zero, every slot 0 .. world - 1 added in rank order,
    one cast."""
    acc = np.zeros(xs[0].shape, np.float32)
    for x in xs:
        acc += x.astype(np.float32)
    return acc.astype(xs[0].dtype)


# (label, per-rank shape, dtype): the served messages (row 22 at the decode
# step, B 4: bf16 4 x 4096 attention, fp32 4 x 2048 / 4 x 4096 MLP and MoE
# partials; a 1500-row fp32 message, over AUTO's 256 KiB, takes two-shot),
# then the edges.
COLLECTIVE_CASES = {
    "served-bf16-4x4096": ((4, 4096), BF16),
    "served-fp32-4x2048": ((4, 2048), np.float32),
    "served-fp32-1500x64-two-shot": ((1500, 64), np.float32),
    "edge-one-row": ((1, 64), np.float32),
    "edge-ragged-lead-6": ((6, 48), np.float32),
    "edge-bf16-8x64": ((8, 64), BF16),
}


@pytest.fixture(scope="module")
def xla_collectives(mesh4):
    """JAX's ``XLA`` routes of the three collectives, one compile per shape."""
    cache = {}

    def run(xs):
        key = (xs[0].shape, xs[0].dtype)
        if key not in cache:
            divisible = xs[0].shape[0] % WORLD == 0

            def fn(x):
                outs = [jcag.all_gather_shard(x, axis="tp", method=jcag.AllGatherMethod.XLA),
                        jcar.all_reduce_shard(x, axis="tp", method=jcar.AllReduceMethod.XLA)]
                if divisible:
                    outs.append(j_reduce_scatter_shard(x, axis="tp", use_xla=True))
                return tuple(outs)

            cache[key] = _shard_map(mesh4, fn, P("tp"), (P(), P()) + ((P("tp"),) if divisible else ()))
        return [np.asarray(o) for o in cache[key](jnp.asarray(np.concatenate(xs, 0)))]

    return run


def _bits(a):
    return a.view(np.uint16) if a.dtype == BF16 else a


@pytest.mark.parametrize("case", list(COLLECTIVE_CASES))
def test_collectives_world4_vs_jax_and_kernel_order(ranks, xla_collectives, case):
    """Rows 20-22 and the host ops on every rank: within ``1e-6`` (fp32) of
    JAX's ``XLA`` route; bitwise equal to the numpy transcription of the TPU
    kernels' order (the gathers are copies); the all-reduces the same bits
    on every rank; AUTO as its router says."""
    shape, dtype = COLLECTIVE_CASES[case]
    rng = _rng(sum(map(ord, case)))
    xs = [rng.standard_normal(shape).astype(np.float32).astype(dtype) for _ in range(WORLD)]
    got = ranks.ok("collective_ops", [{"x": _bits(x)} for x in xs])
    got = [{k: v.view(BF16) if dtype == BF16 else v for k, v in g.items()} for g in got]
    want_ag, want_ar, *want_rs = xla_collectives(xs)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == np.float32 else dict(rtol=2e-2, atol=2e-2)
    stacked = np.stack(xs)
    one_shot = one_shot_numpy(xs)
    divisible = shape[0] % WORLD == 0
    two_shot = np.concatenate([ring_rs_numpy(xs, r) for r in range(WORLD)]) if divisible else one_shot
    nbytes = xs[0].nbytes
    auto = one_shot if car.get_auto_all_reduce_method(nbytes, WORLD) is car.AllReduceMethod.ONE_SHOT else two_shot
    for r, g in enumerate(got):
        for name in ("ring_ag", "full_mesh_ag", "ag_auto", "ag_xla"):
            np.testing.assert_array_equal(_bits(g[name]), _bits(stacked), err_msg=name)
        np.testing.assert_array_equal(_bits(g["ag_host"]), _bits(stacked.reshape(-1, *shape[1:])))
        np.testing.assert_allclose(g["ag_xla"].astype(np.float32), want_ag.astype(np.float32), **tol)
        for name, want in (("one_shot", one_shot), ("two_shot", two_shot), ("ar_auto", auto), ("ar_host", auto)):
            np.testing.assert_array_equal(_bits(g[name]), _bits(want), err_msg=name)
            np.testing.assert_allclose(g[name].astype(np.float32), want_ar.astype(np.float32), **tol, err_msg=name)
            np.testing.assert_array_equal(_bits(g[name]), _bits(got[0][name]), err_msg=f"{name}: rank {r}")
        np.testing.assert_allclose(g["ar_xla"].astype(np.float32), want_ar.astype(np.float32), **tol)
        if divisible:
            c = shape[0] // WORLD
            np.testing.assert_array_equal(_bits(g["ring_rs"]), _bits(ring_rs_numpy(xs, r)))
            np.testing.assert_array_equal(_bits(g["rs_host"]), _bits(g["ring_rs"]))
            for name in ("ring_rs", "rs_xla"):
                np.testing.assert_allclose(g[name].astype(np.float32),
                                           want_rs[0][r * c:(r + 1) * c].astype(np.float32), **tol, err_msg=name)


# ------------------------------------------------------- TP_MoE at world 4

MOE_D, MOE_E, MOE_FF, MOE_K = 32, 4, 64, 1


def _moe_weights(biased: bool):
    rng = _rng(400 + biased)
    wr = _weight(rng, MOE_D, MOE_E)
    if biased:  # toward expert 0, so that the capacity overflows (JAX tests/test_moe_comm.py:87)
        wr = wr * 0.3 + np.asarray([3.0] + [0.0] * (MOE_E - 1), np.float32)[None]
    wg, wu = (_f32(rng, MOE_E, MOE_D, MOE_FF, scale=MOE_D ** -0.5) for _ in range(2))
    wd = _f32(rng, MOE_E, MOE_FF, MOE_D, scale=MOE_FF ** -0.5)
    return wr, wg, wu, wd


def _drops(x, wr, tokens):
    """Whether routing ``tokens``-token groups of x drops an assignment (the
    port's plan, held equal to JAX's in ``tests/test_torch_moe.py``)."""
    dropped = False
    for lo in range(0, x.shape[0], tokens):
        idx, _ = mu.topk_routing(torch.from_numpy(x[lo:lo + tokens] @ wr), MOE_K)
        plan = mu.make_routing_plan(idx, MOE_E, mu.capacity_for(tokens, MOE_K, MOE_E, 2.0))
        dropped |= not bool(plan.keep.all())
    return dropped


# (port mode, global tokens, biased router, JAX mode). The ring paths route
# each chunk with its own capacity (top-1 of 4 experts: 32-token chunks,
# capacity 24). With the biased router they drop, and they are held against
# JAX's same mode; without drops (neither per chunk nor over all T) every
# mode computes the same, JAX's contract (``layers/tp.py:318-322``), and
# JAX's xla mode is the reference, as for the unchunked paths (a tiny dist
# shard gathered; dist_ar with T / world < 8 or ragged; xla), which route
# all T tokens with one capacity.
MOE_CASES = {
    "dist-ring": ("dist", 128, False, "xla"),
    "dist-ring-drops": ("dist", 128, True, "dist"),
    "dist_ar-ring": ("dist_ar", 128, False, "xla"),
    "dist_ar-ring-drops": ("dist_ar", 128, True, "dist_ar"),
    "dist-tiny-shard": ("dist", 12, False, "xla"),
    "dist_ar-unchunked-drops": ("dist_ar", 12, True, "xla"),
    "dist_ar-ragged": ("dist_ar", 6, False, "xla"),
    "xla-drops": ("xla", 12, True, "xla"),
}


@pytest.fixture(scope="module")
def jax_tp_moe(mesh4):
    """JAX's ``TP_MoE`` at world 4 by mode, one compile per (mode, shape)."""
    cache = {}

    def run(mode, x, weights):
        if (mode, x.shape) not in cache:
            def fn(x_, wr_, wg_, wu_, wd_):
                moe = JTP_MoE(w_router=wr_, w_gate=wg_, w_up=wu_, w_down=wd_, top_k=MOE_K, capacity_factor=2.0,
                              axis="tp")
                return moe(x_, mode=mode)

            x_spec = P("tp") if mode == "dist" else P()
            wspecs = (P(), P(None, None, "tp"), P(None, None, "tp"), P(None, "tp", None))
            cache[mode, x.shape] = _shard_map(mesh4, fn, (x_spec,) + wspecs, x_spec)
        return np.asarray(cache[mode, x.shape](x, *weights))

    return run


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_tp_moe_world4_vs_jax(ranks, jax_tp_moe, case):
    mode, t, biased, jmode = MOE_CASES[case]
    wr, wg, wu, wd = _moe_weights(biased)
    # A biased router sends a token to expert 0 when its features sum above
    # zero; an offset makes that every token.
    x = _f32(_rng(500 + t), t, MOE_D, scale=0.3) + np.float32(0.3 if biased else 0.0)
    ring = mode != "xla" and t % WORLD == 0 and t // WORLD >= 8
    assert _drops(x, wr, t // WORLD if ring else t) == biased, "the case must drop exactly when biased"
    assert not (ring and jmode == "xla" and _drops(x, wr, t)), "xla is the reference only without drops"
    want = jax_tp_moe(jmode, x, (wr, wg, wu, wd))
    per_rank = t // WORLD
    xs = [x[r * per_rank:(r + 1) * per_rank] if mode == "dist" else x for r in range(WORLD)]
    got = ranks.ok("tp_moe", [dict(x=xs[r], w_router=wr, w_gate=wg, w_up=wu, w_down=wd, mode=mode, top_k=MOE_K)
                              for r in range(WORLD)])
    if mode == "dist":
        np.testing.assert_allclose(np.concatenate(got), want, **OP_TOL)
    else:
        for g in got:
            np.testing.assert_allclose(g, want, **OP_TOL)
            np.testing.assert_array_equal(g, got[0])  # replicated: the same bits on every rank


@pytest.mark.parametrize("policy", ["scoreboard", "static", "cost"])
def test_mega_plans_world4_equal_jax(policy):
    """The world-4 step plans (per-rank heads and ff in the cost model) equal
    JAX's ``ModelBuilder(cfg, world=4)`` plans, dense and MoE."""
    for preset in ("test-dense", "test-moe"):
        want = JModelBuilder(JPRESETS[preset], world=WORLD, schedule_policy=policy).build_step_fn(2).plan
        ctx = types.SimpleNamespace(world=WORLD)  # planning needs the world alone
        got = ModelBuilder(PRESETS[preset], schedule_policy=policy, ctx=ctx).build_step_fn(2).plan
        assert got == want, preset


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


def _jax_serve(jmodel, gen_len=GEN, prompts=SLOT_PROMPTS):
    """The JAX ``xla`` engine at world 4 on the serve (none when ``gen_len``
    is 0) and slot requests."""
    eng = JEngine(jmodel, backend="xla", max_len=MAX_LEN)
    ids = jnp.asarray(SERVE_IDS, jnp.int32)
    logits = np.asarray(eng._prefill(jmodel.params, ids)[0])
    served = np.asarray(eng.serve(ids, gen_len=gen_len)) if gen_len else np.zeros(0, np.float32)
    cache = eng.alloc_slots(len(prompts))
    first = []
    for slot, p in enumerate(prompts):
        t0, cache = eng.prefill_into_slot(cache, slot, jnp.asarray([p], jnp.int32))
        first.append(int(t0))
    out, _, cache, _ = eng.decode_steps(cache, jnp.asarray(first, jnp.int32), jnp.asarray(REMAINING, jnp.int32),
                                        CHUNK)
    return {"logits": logits, "served": served, "first": first, "out": np.asarray(out),
            "lengths": np.asarray(cache.lengths), "k": np.asarray(cache.k)}


@pytest.fixture(scope="module")
def jax_reference(jmodel):
    return _jax_serve(jmodel)


def _assert_serves_equal(got, want):
    """Each rank's serve against JAX's: logits within ``1e-4``, tokens and
    lengths equal, its kv heads of the global cache; the decode's hidden
    states the same bits on every rank."""
    hk = want["k"].shape[2] // WORLD
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["logits"], want["logits"], **LOGIT_TOL)
        np.testing.assert_array_equal(g["served"], want["served"])
        assert g["first"] == want["first"]
        np.testing.assert_array_equal(g["out"], want["out"])
        np.testing.assert_array_equal(g["lengths"], want["lengths"])
        # each rank's cache holds its kv heads of the global cache
        np.testing.assert_allclose(g["k"], want["k"][:, :, r * hk:(r + 1) * hk], **LOGIT_TOL)
        np.testing.assert_array_equal(g["hidden"], got[0]["hidden"])


@pytest.mark.parametrize("backend", ["dist", "dist_ar", "xla", "mega"])
def test_engine_world4_equals_jax_xla(ranks, arrays, jax_reference, backend):
    got = ranks.ok("serve", dict(arrays=arrays, backend=backend, ids=SERVE_IDS, gen_len=GEN, prompts=SLOT_PROMPTS,
                                 remaining=REMAINING, chunk=CHUNK, max_len=MAX_LEN))
    _assert_serves_equal(got, jax_reference)


@pytest.fixture(scope="module")
def jmoe(mesh4):
    return JQwen3MoE(JPRESETS["test-moe"], mesh4, key=jax.random.PRNGKey(2))


@pytest.fixture(scope="module")
def moe_arrays(jmoe):
    return {f.name: np.asarray(getattr(jmoe.params, f.name)) for f in dataclasses.fields(jmoe.params)}


# The MoE slots: 64 tokens take the rings in 16-token chunks (dist: 16 a
# rank; dist_ar and the mega prefill: chunks of 16), where capacity_for(16,
# 2, 8, 2.0) = 16, so no chunk drops an assignment and JAX's xla engine
# (one capacity for all 64 tokens, none dropped either) is the reference;
# drops are held against JAX's own ring modes in test_tp_moe_world4_vs_jax.
# 8 tokens take the gathered tiny-shard path and the unchunked all-reduce.
MOE_PROMPTS = [list(np.random.default_rng(8).integers(0, 256, 64)), SERVE_IDS[0]]


@pytest.fixture(scope="module")
def jax_moe_reference(jmoe):
    return _jax_serve(jmoe, gen_len=0, prompts=MOE_PROMPTS)


@pytest.mark.parametrize("backend", ["xla", "dist", "dist_ar", "mega"])
def test_moe_engine_world4_equals_jax_xla(ranks, moe_arrays, jax_moe_reference, backend):
    """``test-moe`` as ``Qwen3MoE`` at world 4 (``TP_MoE``, ff columns a
    rank) on every backend; every decode step takes the unchunked grouped
    GEMMs and the all-reduce (one-shot; on mega the attention's too). JAX
    holds its modes equal (``tests/test_models.py``), so the reference is
    its ``xla`` engine."""
    got = ranks.ok("serve", dict(arrays=moe_arrays, backend=backend, ids=SERVE_IDS, gen_len=0, prompts=MOE_PROMPTS,
                                 remaining=REMAINING, chunk=CHUNK, max_len=MAX_LEN, moe=True))
    _assert_serves_equal(got, jax_moe_reference)


def test_moe_params_from_numpy_takes_the_jax_shards(jmoe, moe_arrays, mesh4):
    devices = list(mesh4.mesh.devices.flat)
    cfg = PRESETS["test-moe"]
    for rank in range(WORLD):
        params = params_from_numpy(moe_arrays, cfg, "cpu", rank=rank, world=WORLD)
        for f in dataclasses.fields(jmoe.params):
            shard = next(s for s in getattr(jmoe.params, f.name).addressable_shards if s.device == devices[rank])
            np.testing.assert_array_equal(getattr(params, f.name).numpy(), np.asarray(shard.data), err_msg=f.name)


def test_dist_prefill_needs_rows_divisible_by_world(ranks, arrays):
    answers = ranks.run("dist_prefill", dict(arrays=arrays, ids=[[1, 2, 3, 4, 5, 6, 7]]))
    for status, value in answers:
        assert status == "err" and value.startswith("ValueError") and "not divisible" in value


def test_unported_world4_paths_raise():
    """At world 4, ``Qwen3MoE`` builds (``TP_MoE`` takes ff columns a rank)
    and ``Engine(backend="mega")`` builds for the dense and the MoE model
    (no collective runs before a step); the paged entry points still raise,
    naming the rest of ROADMAP item B, and the expert-parallel model on mega
    still raises, naming the builder's ``moe_impl`` hook."""
    from triton_dist_tpu_torch.models import DenseLLM, Engine, EPMoELLM, Qwen3MoE

    ctx = types.SimpleNamespace(rank=0, world=WORLD, device=torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    moe = Qwen3MoE(PRESETS["test-moe"], ctx=ctx, generator=gen)
    assert moe.params.mlp_gate.shape[-1] == 48 // WORLD and moe.params.mlp_down.shape[-2] == 48 // WORLD
    model = DenseLLM(PRESETS["test-dense"], ctx=ctx, generator=gen)
    assert model.params.wqkv.shape[-1] == (8 + 2 * 4) * 32 // WORLD and model.params.wo.shape[1] == 8 * 32 // WORLD
    for m in (model, moe):
        eng = Engine(m, backend="mega")
        assert len(eng._mega_layers) == 2 and eng._mega_step.plan
        with pytest.raises(NotImplementedError, match="item B"):
            eng.alloc_paged(2, block_size=16, num_blocks=5)
    with pytest.raises(NotImplementedError, match="item B"):
        Engine(model, backend="dist").alloc_paged(2, block_size=16, num_blocks=5)
    ep = EPMoELLM(PRESETS["test-moe"], ctx=ctx, generator=gen)
    with pytest.raises(NotImplementedError, match="moe_impl"):
        Engine(ep, backend="mega")

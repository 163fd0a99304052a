"""The port's sequence parallelism (``kernels/ag_attention.py``, row 27's
plain version; ``kernels/sp.py``; ``layers/sp.py``; ``function.ag_attention_fn``)
held against the JAX package on the CPU, fp32, at JAX's own test sizes.

The port runs in four rank processes (``tests/test_torch_tp_ranks.py``, one
pool for this module, ``gloo``); JAX runs on the 4-device CPU mesh (``ctx4``),
its flash kernels in interpret mode. JAX's row 27 does not lower on this
CPU jax (its collective Pallas kernels need ``semaphore_read``), so row 27's
references are the functions it equals: JAX's ``flash_attention`` over the
whole sequence (the oracle of ``tests/test_ag_attention.py``), JAX's
``ring_attention_shard`` (the route ``AGSPAttn`` takes where the plan does
not fit), and for the gradients ``jax.grad`` of JAX's ``ring_attention_fn``
and of the dense oracle of ``tests/test_ag_attention.py``. JAX's Ulysses runs
its XLA all-to-all (``use_pallas_a2a=True`` does not lower here either); the
port's two transports compute the same function. The JAX references are
computed once per module.

Tolerances are JAX's own tests' (``tests/test_ag_attention.py``,
``test_sp.py``, ``test_function.py``): ``2e-4`` forward, ``3e-4`` for the
rings' gradients, ``1e-5`` for the fused Ulysses GEMMs; the gathered K and V
are bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from test_torch_tp_ranks import Ranks

from triton_dist_tpu.function import ring_attention_fn as jax_ring_attention_fn
from triton_dist_tpu.kernels import sp as jsp
from triton_dist_tpu.kernels.ag_attention import ag_attention_supported as jax_ag_attention_supported
from triton_dist_tpu.kernels.flash_attn import flash_attention as jax_flash_attention
from triton_dist_tpu.layers.sp import RingSPAttn as JaxRingSPAttn
from triton_dist_tpu.layers.sp import UlyssesSPAttn as JaxUlyssesSPAttn
from triton_dist_tpu_torch import function as fn
from triton_dist_tpu_torch.kernels import ag_attention as aga
from triton_dist_tpu_torch.kernels import sp as ksp
from triton_dist_tpu_torch.layers import Ring2DSPAttn

torch.set_num_threads(2)  # six test workers share the host

WORLD = 4
TOL = dict(rtol=2e-4, atol=2e-4)
RING_TOL = dict(rtol=3e-4, atol=3e-4)
GEMM_TOL = dict(rtol=1e-5, atol=1e-5)
SEQ = P(None, None, "tp")  # (B, H, S, D) sharded over the sequence
# (b, hq, hkv, s_loc, d): JAX's ag test size, and its batched GQA case.
SIZES = {"b1": (1, 4, 2, 16, 32), "gqa-b2": (2, 8, 2, 8, 32)}
CU = (0, 40, 56)  # two documents over the 64-token stream, 8 padding rows


def _normal(rng, *shape, scale=0.4):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _seq_shard(a, r, axis=2):
    n = a.shape[axis] // WORLD
    return np.ascontiguousarray(np.take(a, range(r * n, (r + 1) * n), axis=axis))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=msg, **tol)


def _shard_map(ctx4, f, in_specs, out_specs=SEQ):
    return jax.jit(jax.shard_map(f, mesh=ctx4.mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False))


def _dense_oracle(q, k, v):
    """``tests/test_ag_attention.py``'s causal oracle over the whole sequence."""
    g = q.shape[1] // k.shape[1]
    s = q.shape[2]
    kf = jnp.repeat(k, g, axis=1)
    vf = jnp.repeat(v, g, axis=1)
    sc = jnp.einsum("bhqd,bhkd->bhqk", q, kf) * (q.shape[-1] ** -0.5)
    sc = jnp.where(jnp.tril(jnp.ones((s, s), bool)), sc, -jnp.inf)
    return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(sc, -1), vf)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(tmp_path_factory.mktemp("sp") / "store", WORLD)
    yield r
    r.close()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(27)
    out = {}
    for name, (b, hq, hkv, s_loc, d) in SIZES.items():
        s = WORLD * s_loc
        out[name] = tuple(_normal(rng, b, h, s, d) for h in (hq, hkv, hkv))
    return out


@pytest.fixture(scope="module")
def jax_refs(ctx4, inputs):
    """JAX's flash attention over the whole sequence (o, lse) and, for b1,
    JAX's ``RingSPAttn`` (``ring_attention_shard``) on the mesh, per (size,
    causal); each computed once, when a test first asks."""
    refs = {}

    def get(name, causal):
        if (name, causal) not in refs:
            q, k, v = inputs[name]
            s = q.shape[2]
            o, lse = jax_flash_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=causal, block_q=s, block_k=s,
                                         return_lse=True)
            ring = None
            if name == "b1":
                blk = SIZES[name][3]
                layer = JaxRingSPAttn(axis="tp", causal=causal, block_q=blk, block_k=blk)
                ring = np.asarray(_shard_map(ctx4, layer, (SEQ,) * 3)(q, k, v))
            refs[name, causal] = (np.asarray(o), np.asarray(lse), ring)
        return refs[name, causal]

    return get


def test_ag_attention_supported_matches_jax():
    """(a) The copied plan check gives JAX's booleans over a grid of shapes,
    limits and ``with_residuals``, both sides of the boundary included."""
    grid = [(w, b, hq, hkv, s, d, isz, lim, res)
            for w in (1, 4) for b, hq, hkv in ((1, 32, 8), (2, 8, 2), (1, 4, 4))
            for s in (16, 128, 384, 512, 1024, 4096) for d in (32, 128) for isz in (2, 4)
            for lim in (0, 16, 100) for res in (False, True)]
    got = [aga.ag_attention_supported(*g[:7], vmem_limit_mb=g[7], with_residuals=g[8]) for g in grid]
    want = [jax_ag_attention_supported(*g[:7], vmem_limit_mb=g[7], with_residuals=g[8]) for g in grid]
    assert got == want
    assert any(got) and not all(got)
    # Qwen3-8B attention at world 4 (bf16, B 1): S_local 384 admitted with
    # residuals at 100 MB, 512 refused (the card run's route change).
    assert aga.ag_attention_supported(4, 1, 32, 8, 384, 128, 2, 100, with_residuals=True)
    assert not aga.ag_attention_supported(4, 1, 32, 8, 512, 128, 2, 100, with_residuals=True)


@pytest.mark.parametrize("name,causal", [("b1", True), ("b1", False), ("gqa-b2", True)],
                         ids=["b1-causal", "b1-full", "gqa-b2-causal"])
def test_ag_flash_attention_shard_vs_jax(ranks, inputs, jax_refs, name, causal):
    """(b) Row 27's plain version, with residuals: o within ``2e-4`` of JAX's
    flash over the whole sequence and (b1) of JAX's ring; lse within ``2e-4`` of
    JAX flash's at this rank's rows; k_full and v_full bitwise the whole
    K and V (the shards in rank order)."""
    q, k, v = inputs[name]
    o_ref, lse_ref, ring_ref = jax_refs(name, causal)
    got = ranks.ok("sp_op", [dict(op="ag", q=_seq_shard(q, r), k=_seq_shard(k, r), v=_seq_shard(v, r),
                                  causal=causal) for r in range(WORLD)])
    o = np.concatenate([g["o"] for g in got], axis=2)
    _close(o, o_ref, msg="o vs JAX flash")
    if ring_ref is not None:
        _close(o, ring_ref, msg="o vs JAX ring")
    for r, g in enumerate(got):
        _close(g["lse"], _seq_shard(lse_ref, r), msg=f"lse rank {r}")
        assert np.array_equal(g["k_full"], k) and np.array_equal(g["v_full"], v), f"rank {r}: gathered K/V"


def test_ag_attention_fn_grads_vs_jax(ranks, ctx4, inputs):
    """(c) ``ag_attention_fn``'s gradients (row 27's plain version forward,
    row 5's backward over the gathered KV, the fp32 reduce-scatter of dk,
    dv) against ``jax.grad`` of JAX's ``ring_attention_fn`` and of the dense
    oracle of ``tests/test_ag_attention.py``, within ``3e-4``."""
    q, k, v = inputs["b1"]
    c = _normal(np.random.default_rng(28), *q.shape, scale=1.0)
    ring = jax.shard_map(lambda q_, k_, v_: jax_ring_attention_fn(q_, k_, v_, axis="tp", block_q=16, block_k=16),
                         mesh=ctx4.mesh, in_specs=(SEQ,) * 3, out_specs=SEQ, check_vma=False)
    ring_grads = jax.jit(jax.grad(lambda *a: jnp.sum(ring(*a) * c), argnums=(0, 1, 2)))(q, k, v)
    dense_grads = jax.grad(lambda *a: jnp.sum(_dense_oracle(*a) * c), argnums=(0, 1, 2))(q, k, v)
    got = ranks.ok("function_grads", [dict(op="ag", args=(_seq_shard(q, r), _seq_shard(k, r), _seq_shard(v, r)),
                                           c=_seq_shard(c, r)) for r in range(WORLD)])
    for i, name in enumerate("qkv"):
        grad = np.concatenate([g["grads"][i] for g in got], axis=2)
        _close(grad, ring_grads[i], RING_TOL, msg=f"d{name} vs JAX ring_attention_fn")
        _close(grad, dense_grads[i], RING_TOL, msg=f"d{name} vs the dense oracle")


@pytest.mark.parametrize("mode", ["causal", "full", "varlen"])
def test_ring_sp_attn_vs_jax(ranks, ctx4, inputs, jax_refs, mode):
    """(d) ``RingSPAttn`` (row 1 a step, or row 4 over packed documents that
    span shards) against JAX's ``RingSPAttn`` on the mesh."""
    q, k, v = inputs["b1"]
    causal = mode in ("causal", "varlen")
    cu = CU if mode == "varlen" else None
    if cu is None:
        ref = jax_refs("b1", causal)[2]
    else:
        layer = JaxRingSPAttn(axis="tp", causal=True, block_q=16, block_k=16)
        ref = _shard_map(ctx4, lambda q_, k_, v_: layer(q_, k_, v_, jnp.asarray(cu, jnp.int32)), (SEQ,) * 3)(q, k, v)
    got = ranks.ok("sp_op", [dict(op="ring", q=_seq_shard(q, r), k=_seq_shard(k, r), v=_seq_shard(v, r),
                                  causal=causal, cu_seqlens=cu) for r in range(WORLD)])
    _close(np.concatenate(got, axis=2), ref)


@pytest.mark.parametrize("use_pallas_a2a", [False, True], ids=["plain-a2a", "row25-a2a"])
def test_ulysses_sp_attn_vs_jax(ranks, ctx4, use_pallas_a2a):
    """(d) ``UlyssesSPAttn`` on either transport against JAX's
    ``UlyssesSPAttn`` (its XLA all-to-all) on the mesh, GQA 2 with heads
    that split over the ranks, causal."""
    rng = np.random.default_rng(29)
    b, hq, hkv, s_loc, d = 1, 8, 4, 16, 32
    q, k, v = (_normal(rng, b, WORLD * s_loc, h, d) for h in (hq, hkv, hkv))
    spec = P(None, "tp")
    ref = _shard_map(ctx4, JaxUlyssesSPAttn(axis="tp", causal=True), (spec,) * 3, spec)(q, k, v)
    got = ranks.ok("sp_op", [dict(op="ulysses", q=_seq_shard(q, r, 1), k=_seq_shard(k, r, 1),
                                  v=_seq_shard(v, r, 1), causal=True, use_pallas_a2a=use_pallas_a2a)
                             for r in range(WORLD)])
    _close(np.concatenate(got, axis=1), ref)


@pytest.mark.parametrize("vmem_limit_mb,route", [(100, "ag"), (0, "ring")])
def test_ag_sp_attn_routes_vs_jax(ranks, inputs, jax_refs, vmem_limit_mb, route):
    """(d) ``AGSPAttn`` takes row 27 where JAX's plan fits (100 MB) and the
    ring where it does not (0 MB), once each, and matches JAX's flash over
    the whole sequence on both routes."""
    q, k, v = inputs["b1"]
    got = ranks.ok("sp_op", [dict(op="agsp", q=_seq_shard(q, r), k=_seq_shard(k, r), v=_seq_shard(v, r),
                                  vmem_limit_mb=vmem_limit_mb) for r in range(WORLD)])
    for g in got:
        assert g["calls"] == {"ag": int(route == "ag"), "ring": int(route == "ring")}, g["calls"]
    _close(np.concatenate([g["o"] for g in got], axis=2), jax_refs("b1", True)[0])


def test_ulysses_gemm_a2a_vs_jax(ranks, ctx4):
    """(e) The four fused Ulysses GEMM↔all-to-all functions against JAX's on
    the mesh, within ``1e-5``: ``gemm_a2a_shard``, ``a2a_gemm_shard``, and
    the QKV and O projections over a head-group-major ``wqkv`` and ``wo``."""
    rng = np.random.default_rng(30)
    m, kd, n = 8, 16, 24
    b, s_loc, dm, hq, hkv, hd = 1, 8, 32, 8, 4, 16
    x = _normal(rng, WORLD, m, kd)  # rank r's rows
    w = _normal(rng, kd, n)
    chunks = _normal(rng, WORLD, WORLD, m, kd // WORLD)  # rank r's payload for each peer
    w2 = _normal(rng, kd, n)
    x3 = _normal(rng, b, WORLD * s_loc, dm)
    wqkv = _normal(rng, dm, (hq + 2 * hkv) * hd)
    o = _normal(rng, WORLD, b, WORLD * s_loc, hq // WORLD, hd)  # rank r's head group, whole sequence
    wo = _normal(rng, hq * hd, dm)
    rep, rows = P(), P("tp")

    def qkv(x3_, w_):
        return jsp.ulysses_qkv_gemm_a2a_shard(x3_, w_, num_q_heads=hq, num_kv_heads=hkv, head_dim=hd, axis="tp")

    ref = {
        "gemm_a2a": _shard_map(ctx4, lambda x_, w_: jsp.gemm_a2a_shard(x_[0], w_, axis="tp")[None],
                               (rows, rep), rows)(x, w),
        "a2a_gemm": _shard_map(ctx4, lambda c_, w_: jsp.a2a_gemm_shard(c_[0], w_, axis="tp")[None],
                               (rows, rep), rows)(chunks, w2),
        "qkv": [_shard_map(ctx4, lambda x3_, w_, i=i: qkv(x3_, w_)[i][None], (P(None, "tp"), rep), rows)(x3, wqkv)
                for i in range(3)],
        "o_proj": _shard_map(ctx4, lambda o_, w_: jsp.ulysses_o_a2a_gemm_shard(o_[0], w_, axis="tp"),
                             (rows, rep), P(None, "tp"))(o, wo),
    }
    got = ranks.ok("sp_op", [dict(op="ulysses_gemms", x=x[r], w=w, chunks=chunks[r], w2=w2,
                                  x3=_seq_shard(x3, r, 1), wqkv=wqkv, hq=hq, hkv=hkv, hd=hd, o=o[r], wo=wo)
                             for r in range(WORLD)])
    for r, g in enumerate(got):
        _close(g["gemm_a2a"], ref["gemm_a2a"][r], GEMM_TOL, msg=f"gemm_a2a rank {r}")
        _close(g["a2a_gemm"], ref["a2a_gemm"][r], GEMM_TOL, msg=f"a2a_gemm rank {r}")
        for i, name in enumerate("qkv"):
            _close(g["qkv"][i], ref["qkv"][i][r], GEMM_TOL, msg=f"ulysses {name} rank {r}")
    _close(np.concatenate([g["o_proj"] for g in got], axis=1), ref["o_proj"], GEMM_TOL, msg="o projection")


def test_unported_sp_paths_raise():
    """The two-level ring needs a two-axis mesh (D1), row 27's trace its
    globaltimer records (H); each raises and names what it needs. At world 1
    ``ag_attention_fn`` is rows 1 and 5 and refuses no shape."""
    for f in (ksp.ring_attention_2d_shard, ksp.ring_2d_schedule, Ring2DSPAttn()):
        with pytest.raises(NotImplementedError, match="two-axis mesh"):
            f(None, None, None)
    q = torch.zeros((1, 4, 8, 32))
    kv = torch.zeros((1, 2, 8, 32))
    with pytest.raises(NotImplementedError, match="item H"):
        aga.ag_flash_attention_shard(None, q, kv, kv, trace=object())
    with pytest.raises(NotImplementedError, match="D1"):
        aga.ag_flash_attention_shard(None, q, kv, kv, mesh_axes=("dp", "tp"))
    with pytest.raises(ValueError, match="share a dtype"):
        aga.ag_flash_attention_shard(None, q, kv, kv.double())
    o = fn.ag_attention_fn(None, q.requires_grad_(), kv, kv, vmem_limit_mb=0)
    assert o.shape == q.shape

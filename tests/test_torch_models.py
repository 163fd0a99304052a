"""The port's layers, model and engine held against the JAX package at
tensor-parallel world 1 on the ``test-dense`` preset (fp32).

The JAX side runs on a 1-device CPU mesh, its Pallas kernels in interpret
mode; the port runs with ``device="cpu"``, which takes the kernels' plain
versions. Both use the same weights: JAX ``init_params`` output passed
through the port's weight bridge. Tolerance: fp32 with a different
summation order, ``rtol = atol = 1e-4``; greedy token streams must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.layers.tp import RMSNorm as JRMSNorm
from triton_dist_tpu.layers.tp import TP_Attn as JTP_Attn
from triton_dist_tpu.layers.tp import apply_rope as jax_apply_rope
from triton_dist_tpu.models import PRESETS as JPRESETS
from triton_dist_tpu.models import DenseLLM as JDenseLLM
from triton_dist_tpu.models import Engine as JEngine
from triton_dist_tpu_torch.layers import TP_Attn, RMSNorm, apply_rope
from triton_dist_tpu_torch.models import PRESETS, DenseLLM, Engine, params_from_numpy

# Six test workers share the host with the JAX suite: keep torch's intra-op
# pool small.
torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
IDS = [[3, 17, 42, 7, 99, 5, 23, 11]]


@pytest.fixture(scope="module")
def models():
    from triton_dist_tpu.runtime.mesh import initialize_distributed
    from triton_dist_tpu.runtime.platform import cpu_mesh

    mesh = cpu_mesh((1,), ("tp",))
    ctx = initialize_distributed(devices=list(mesh.devices.flat), axis_names=("tp",),
                                 set_default=False)
    jmodel = JDenseLLM(JPRESETS["test-dense"], ctx, key=jax.random.PRNGKey(1))
    arrays = {
        f.name: None if getattr(jmodel.params, f.name) is None
        else np.asarray(getattr(jmodel.params, f.name))
        for f in dataclasses.fields(jmodel.params)
    }
    cfg = PRESETS["test-dense"]
    tmodel = DenseLLM(cfg, params_from_numpy(arrays, cfg, "cpu"), device="cpu")
    return jmodel, tmodel


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_rmsnorm_and_rope_vs_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = JRMSNorm(weight=jnp.asarray(w), eps=1e-6)(jnp.asarray(x))
    got = RMSNorm(_t(w), eps=1e-6)(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    xr = rng.standard_normal((2, 4, 6, 32)).astype(np.float32)
    pos = rng.integers(0, 50, (2, 6)).astype(np.int32)
    want = jax_apply_rope(jnp.asarray(xr), jnp.asarray(pos), 1e6)
    got = apply_rope(_t(xr), _t(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _layer0(jmodel, tmodel):
    c = jmodel.config
    p = jmodel.params
    jattn = JTP_Attn(
        wqkv=p.wqkv[0], wo=p.wo[0],
        q_norm=JRMSNorm(weight=p.q_norm[0], eps=c.rms_eps),
        k_norm=JRMSNorm(weight=p.k_norm[0], eps=c.rms_eps),
        num_q_heads_local=c.num_q_heads, num_kv_heads_local=c.num_kv_heads,
        head_dim=c.head_dim, rope_theta=c.rope_theta, axis="tp",
        mesh_axes=jmodel.ctx.axis_names,
    )
    return jattn, tmodel.layers[0][1]


def test_attn_layer_prefill_and_decode_vs_jax(models):
    jmodel, tmodel = models
    c = jmodel.config
    jattn, tattn = _layer0(jmodel, tmodel)
    assert isinstance(tattn, TP_Attn)
    rng = np.random.default_rng(1)
    bsz, seq, s_max = 2, 6, 16
    x = rng.standard_normal((bsz * seq, c.hidden_size)).astype(np.float32)
    pos = np.tile(np.arange(seq, dtype=np.int32), (bsz, 1))
    mesh = jmodel.ctx.mesh

    prefill = jax.jit(jax.shard_map(
        lambda a, x_, p_: a.prefill(x_, p_, mode="dist", bsz=bsz), mesh=mesh,
        in_specs=(P(), P(), P()), out_specs=(P(), (P(), P())), check_vma=False,
    ))
    want_out, (want_k, want_v) = prefill(jattn, jnp.asarray(x), jnp.asarray(pos))
    got_out, (got_k, got_v) = tattn.prefill(_t(x), _t(pos), mode="dist", bsz=bsz)
    for g, w in ((got_out, want_out), (got_k, want_k), (got_v, want_v)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)

    xd = rng.standard_normal((bsz, c.hidden_size)).astype(np.float32)
    kc = rng.standard_normal((bsz, c.num_kv_heads, s_max, c.head_dim)).astype(np.float32)
    vc = rng.standard_normal((bsz, c.num_kv_heads, s_max, c.head_dim)).astype(np.float32)
    lengths = np.asarray([3, 9], np.int32)
    decode = jax.jit(jax.shard_map(
        lambda a, x_, p_, k_, v_, l_: a.decode(x_, p_, k_, v_, l_, mode="dist_ar"), mesh=mesh,
        in_specs=(P(),) * 6, out_specs=(P(), (P(), P())), check_vma=False,
    ))
    want_out, (want_k, want_v) = decode(jattn, jnp.asarray(xd), jnp.asarray(lengths), jnp.asarray(kc),
                                        jnp.asarray(vc), jnp.asarray(lengths))
    tk, tv = _t(kc.copy()), _t(vc.copy())
    got_out, (got_k, got_v) = tattn.decode(_t(xd), _t(lengths), tk, tv, _t(lengths))
    assert got_k is tk and got_v is tv  # written in place
    for g, w in ((got_out, want_out), (got_k, want_k), (got_v, want_v)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_dense_prefill_vs_jax(models):
    jmodel, tmodel = models
    jeng = JEngine(jmodel, backend="dist", max_len=32)
    want_logits, want_k, want_v = jeng._prefill(jmodel.params, jnp.asarray(IDS, jnp.int32))
    got_logits, (got_k, got_v) = tmodel.prefill(torch.tensor(IDS))
    assert got_logits.dtype == torch.float32 and got_logits.shape == (1, 256)
    for g, w in ((got_logits, want_logits), (got_k, want_k), (got_v, want_v)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.fixture(scope="module")
def jax_served(models):
    jmodel, _ = models
    return np.asarray(
        JEngine(jmodel, backend="dist", max_len=32).serve(jnp.asarray(IDS, jnp.int32), gen_len=6)
    )


@pytest.mark.parametrize("backend", ["dist", "dist_ar", "xla"])
def test_engine_serve_greedy_equals_jax(models, jax_served, backend):
    _, tmodel = models
    want = jax_served
    engine = Engine(tmodel, backend=backend, max_len=32)
    got = engine.serve(torch.tensor(IDS), gen_len=6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # The last generated token's KV is not written yet (JAX's convention).
    assert engine.kv_cache.lengths.tolist() == [len(IDS[0]) + 6 - 1]


def test_slots_prefill_and_decode_steps_equal_jax(models):
    jmodel, tmodel = models
    prompts = [[5, 9, 13, 2, 77], [3, 17, 42, 7, 99, 5, 23, 11], [1, 2, 3]]
    remaining = np.asarray([4, 2, 0], np.int32)
    chunk = 4

    jeng = JEngine(jmodel, backend="dist", max_len=32)
    jcache = jeng.alloc_slots(3)
    jtok = []
    for slot, ids in enumerate(prompts):
        t0, jcache = jeng.prefill_into_slot(jcache, slot, jnp.asarray([ids], jnp.int32))
        jtok.append(int(t0))
    jout, jlast, jcache, jrem = jeng.decode_steps(
        jcache, jnp.asarray(jtok, jnp.int32), jnp.asarray(remaining), chunk)

    teng = Engine(tmodel, backend="dist", max_len=32)
    tcache = teng.alloc_slots(3)
    ttok = []
    for slot, ids in enumerate(prompts):
        t0, tcache = teng.prefill_into_slot(tcache, slot, torch.tensor([ids]))
        ttok.append(int(t0))
    assert ttok == jtok
    tout, tlast, tcache, trem = teng.decode_steps(
        tcache, torch.tensor(ttok, dtype=torch.int32), torch.from_numpy(remaining), chunk)

    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
    np.testing.assert_array_equal(trem.numpy(), np.asarray(jrem))
    np.testing.assert_array_equal(tcache.lengths.numpy(), np.asarray(jcache.lengths))
    # Inactive slots freeze: slot 1 ran 2 steps, slot 2 none.
    assert tcache.lengths.tolist() == [5 + 4, 8 + 2, 3]
    assert (tout[2] == -1).all() and (tout[1, 2:] == -1).all()
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), **TOL)


def test_chunked_prefill_matches_one_shot(models):
    _, tmodel = models
    c = tmodel.config
    ids = torch.tensor([[7, 3, 200, 18, 5, 99, 1, 64, 33, 2, 150, 12]])
    seq, chunk = ids.shape[1], 5
    want_logits, (want_k, want_v) = tmodel.prefill(ids)
    shape = (c.num_layers, 1, c.num_kv_heads, seq, c.head_dim)
    kb, vb = torch.zeros(shape), torch.zeros(shape)
    for off in range(0, seq, chunk):
        part = ids[:, off:off + chunk]
        n = part.shape[1]
        part = torch.nn.functional.pad(part, (0, chunk - n))  # final chunk padded to C
        logits, (kb, vb) = tmodel.prefill_chunk(part, kb, vb, off, last_idx=n - 1)
    np.testing.assert_allclose(logits.numpy(), want_logits.numpy(), **TOL)
    np.testing.assert_allclose(kb.numpy(), want_k.numpy(), **TOL)
    np.testing.assert_allclose(vb.numpy(), want_v.numpy(), **TOL)

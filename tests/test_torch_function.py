"""The port's training layer (``triton_dist_tpu_torch.function``) and its
kernels' plain versions (rows 4, 5 and 6) held against the JAX package on
the CPU, fp32, at tiny sizes.

World 1: the JAX functions run their Pallas kernels in interpret mode, each
reference jitted once and shared by the tests through module fixtures; one
``jax.vjp`` per case gives the forward values, the LSE and (dq, dk, dv) that
both the port's plain kernels and its autograd functions are held to. The
LSE cotangent is nonzero where a function returns the LSE.

World 4: four rank processes (``tests/test_torch_tp_ranks.py``, one pool for
this module) run the port's functions, each rank backpropagating its own
loss; the references are JAX's XLA compositions on a 4-device CPU mesh (as
``tests/test_function.py::grads_of`` builds them) and, for the rings,
``jax.grad`` of attention over the global sequence. JAX's own ``gemm_ar_fn``
and ``ep_moe_fused_fn(use_pallas_a2a=True)`` need Pallas collectives that
do not lower on this CPU jax, and its ring costs tens of seconds a case, so
they are not the references.

Tolerances are those of JAX's own tests of the same functions
(``tests/test_function.py``): ``2e-4``, and ``3e-4`` for the rings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from test_torch_tp_ranks import Ranks

from triton_dist_tpu import function as jfn
from triton_dist_tpu.kernels import flash_attn as jfa
from triton_dist_tpu.kernels import moe_utils as jmu
from triton_dist_tpu.kernels.sp import _merge_partials as jax_merge_partials
from triton_dist_tpu_torch import function as fn
from triton_dist_tpu_torch.kernels import flash_attn as fa
from triton_dist_tpu_torch.kernels.sp import _merge_partials
from triton_dist_tpu_torch.function.training import attention_block_loss
from triton_dist_tpu_torch.models import PRESETS

torch.set_num_threads(2)  # six test workers share the host

TOL = dict(rtol=2e-4, atol=2e-4)
RING_TOL = dict(rtol=3e-4, atol=3e-4)
WORLD = 4


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), err_msg=msg, **tol)


def _port_grads(f, args, c, cl=None):
    """The port's outputs and gradients of sum(o·c) (+ sum(lse·cl))."""
    leaves = [_t(a).requires_grad_() for a in args]
    out = f(*leaves)
    o, lse = out if isinstance(out, tuple) else (out, None)
    loss = (o * _t(c)).sum()
    if cl is not None:
        loss = loss + (torch.where(lse > fa.NEG_INF, lse, 0.0) * _t(cl)).sum()
    loss.backward()
    return o, lse, [t.grad for t in leaves]


def _jax_vjp(f, args, c, cl=None):
    """JAX's outputs and their VJP against (c, cl), jitted."""
    def run(*a):
        out, vjp = jax.vjp(f, *a)
        cot = (c, cl) if cl is not None else c
        return out, vjp(cot)
    return jax.jit(run)(*[jnp.asarray(a) for a in args])


# ------------------------------------------------------- dense, world 1

# Causal GQA with Sq < Sk (end-aligned, no offsets): flash_attention_fn.
END_ALIGNED = dict(b=1, hq=4, hkv=2, sq=32, sk=64, d=32)
# (q_offset, kv_offset) ring steps at Sq = Sk = 32: below the diagonal, on
# it, and above it (no key visible: exact zero gradients).
OFFSETS = {"below": (64, 32), "diagonal": (32, 32), "whole-masked": (0, 64)}


@pytest.fixture(scope="module")
def dense_ref():
    rng = np.random.default_rng(1)
    s = END_ALIGNED
    q = _normal(rng, s["b"], s["hq"], s["sq"], s["d"], scale=0.5)
    k, v = (_normal(rng, s["b"], s["hkv"], s["sk"], s["d"], scale=0.5) for _ in range(2))
    c = _normal(rng, s["b"], s["hq"], s["sq"], s["d"])
    (o, (dq, dk, dv)) = _jax_vjp(lambda *a: jfn.flash_attention_fn(*a, True), (q, k, v), c)
    return (q, k, v, c), (o, dq, dk, dv)


@pytest.fixture(scope="module")
def lse_ref():
    """flash_attention_lse_fn with traced offsets: one compile, every step."""
    rng = np.random.default_rng(2)
    q = _normal(rng, 1, 4, 32, 32, scale=0.5)
    k, v = (_normal(rng, 1, 2, 32, 32, scale=0.5) for _ in range(2))
    c, cl = _normal(rng, 1, 4, 32, 32), _normal(rng, 1, 4, 32)

    @jax.jit
    def run(q_, k_, v_, qo, ko):
        out, vjp = jax.vjp(lambda *a: jfn.flash_attention_lse_fn(*a, qo, ko, True), q_, k_, v_)
        return out, vjp((jnp.asarray(c), jnp.asarray(cl)))

    refs = {name: run(q, k, v, jnp.int32(qo), jnp.int32(ko)) for name, (qo, ko) in OFFSETS.items()}
    return (q, k, v, c, cl), refs


def test_flash_attention_fn_and_bwd_vs_jax(dense_ref):
    """Rows 1 + 5 end-aligned (Sq < Sk), GQA: the plain kernels and
    ``flash_attention_fn`` against JAX's ``flash_attention_fn``."""
    (q, k, v, c), (o, dq, dk, dv) = dense_ref
    o_p, lse_p = fa.flash_attention(_t(q), _t(k), _t(v), causal=True, return_lse=True)
    _close(o_p, o)
    for got, want, name in zip(fa.flash_attention_bwd(_t(q), _t(k), _t(v), o_p, lse_p, _t(c), causal=True),
                               (dq, dk, dv), "qkv"):
        _close(got, want, msg=f"plain bwd d{name}")
    o_f, _, grads = _port_grads(lambda *a: fn.flash_attention_fn(*a, True), (q, k, v), c)
    _close(o_f, o)
    for got, want, name in zip(grads, (dq, dk, dv), "qkv"):
        _close(got, want, msg=f"flash_attention_fn d{name}")


@pytest.mark.parametrize("step", list(OFFSETS))
def test_flash_attention_lse_fn_and_bwd_vs_jax(lse_ref, step):
    """Rows 1 + 5 at ring offsets with a nonzero LSE cotangent (dlse): the
    plain kernels and ``flash_attention_lse_fn`` against JAX's; a step that
    sees no key gives exact zeros."""
    (q, k, v, c, cl), refs = lse_ref
    (o, lse), (dq, dk, dv) = refs[step]
    qo, ko = OFFSETS[step]
    o_p, lse_p = fa.flash_attention(_t(q), _t(k), _t(v), return_lse=True, q_offset=qo, kv_offset=ko)
    _close(o_p, o)
    live = np.asarray(lse) > fa.NEG_INF * 0.5
    _close(lse_p[torch.from_numpy(live)], np.asarray(lse)[live])
    plain = fa.flash_attention_bwd(_t(q), _t(k), _t(v), o_p, lse_p, _t(c), q_offset=qo, kv_offset=ko, dlse=_t(cl))
    o_f, _, grads = _port_grads(lambda *a: fn.flash_attention_lse_fn(*a, qo, ko, True), (q, k, v), c, cl)
    for got_p, got_f, want, name in zip(plain, grads, (dq, dk, dv), "qkv"):
        _close(got_p, want, msg=f"plain bwd d{name}")
        _close(got_f, want, msg=f"flash_attention_lse_fn d{name}")
        if step == "whole-masked":
            assert not bool(got_f.any()) and not bool(got_p.any())


# ------------------------------------------------------ varlen, world 1

VARLEN = dict(hq=4, hkv=2, t=96, d=32)
CU = [0, 24, 40, 56, 80]  # four sequences and a padding tail of 16
# A ring shard of a stream twice as long: sequences of 24, 32, 24 and 50
# tokens, then padding.
CU_RING = [0, 24, 56, 80, 130]
# (q_offset, kv_offset, cu_seqlens): the whole stream; a step below the
# diagonal; a step above it (no key visible).
VARLEN_OFFSETS = {"stream": (0, 0, CU), "ring-step": (96, 48, CU_RING), "ring-skipped": (0, 96, CU_RING)}


@pytest.fixture(scope="module")
def varlen_ref():
    rng = np.random.default_rng(3)
    s = VARLEN
    q = _normal(rng, s["hq"], s["t"], s["d"], scale=0.5)
    k, v = (_normal(rng, s["hkv"], s["t"], s["d"], scale=0.5) for _ in range(2))
    c, cl = _normal(rng, s["hq"], s["t"], s["d"]), _normal(rng, s["hq"], s["t"])

    @jax.jit
    def run(q_, k_, v_, cu, qo, ko):
        out, vjp = jax.vjp(lambda *a: jfn.flash_attention_varlen_lse_fn(*a, cu, qo, ko), q_, k_, v_)
        return out, vjp((jnp.asarray(c), jnp.asarray(cl)))

    refs = {name: run(q, k, v, jnp.asarray(cu, jnp.int32), jnp.int32(qo), jnp.int32(ko))
            for name, (qo, ko, cu) in VARLEN_OFFSETS.items()}
    plain = _jax_vjp(lambda *a: jfn.flash_attention_varlen_fn(*a, jnp.asarray(CU, jnp.int32)), (q, k, v), c)
    return (q, k, v, c, cl), refs, plain


@pytest.mark.parametrize("step", list(VARLEN_OFFSETS))
def test_flash_attention_varlen_lse_fn_and_bwd_vs_jax(varlen_ref, step):
    """Rows 4 + 6 with a nonzero dlse, on the whole stream and at ring
    offsets: segment ids, o (padding rows exactly 0), the LSE (padding
    NEG_INF), the plain kernels' and ``flash_attention_varlen_lse_fn``'s
    gradients against JAX's."""
    (q, k, v, c, cl), refs, _ = varlen_ref
    (o, lse), (dq, dk, dv) = refs[step]
    qo, ko, cu = VARLEN_OFFSETS[step]
    for got, want in zip(fa._varlen_segments(cu, VARLEN["t"], qo, ko),
                         jfa._varlen_segments(jnp.asarray(cu, jnp.int32), VARLEN["t"], jnp.int32(qo), jnp.int32(ko))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    o_p, lse_p = fa.flash_attention_varlen(_t(q), _t(k), _t(v), cu, return_lse=True, q_offset=qo, kv_offset=ko)
    _close(o_p, o)
    empty = np.asarray(lse) == fa.NEG_INF
    np.testing.assert_array_equal(lse_p.numpy()[empty], np.asarray(lse)[empty])
    assert not bool(o_p[torch.from_numpy(empty)].any())
    _close(lse_p[torch.from_numpy(~empty)], np.asarray(lse)[~empty])
    plain = fa.flash_attention_varlen_bwd(_t(q), _t(k), _t(v), o_p, lse_p, _t(c), cu, q_offset=qo, kv_offset=ko,
                                          dlse=_t(cl))
    _, _, grads = _port_grads(lambda *a: fn.flash_attention_varlen_lse_fn(*a, cu, qo, ko), (q, k, v), c, cl)
    for got_p, got_f, want, name in zip(plain, grads, (dq, dk, dv), "qkv"):
        _close(got_p, want, msg=f"plain bwd d{name}")
        _close(got_f, want, msg=f"flash_attention_varlen_lse_fn d{name}")


def test_flash_attention_varlen_fn_vs_jax(varlen_ref):
    """``flash_attention_varlen_fn`` (rows 4 + 6) on a stream with a padding
    tail: outputs (padding rows exactly 0) and gradients (padding rows' dq
    exactly 0) against JAX's."""
    (q, k, v, c, _), _, (o, (dq, dk, dv)) = varlen_ref
    o_f, _, grads = _port_grads(lambda *a: fn.flash_attention_varlen_fn(*a, CU), (q, k, v), c)
    _close(o_f, o)
    assert not bool(o_f[:, CU[-1]:].any()) and not bool(grads[0][:, CU[-1]:].any())
    for got, want, name in zip(grads, (dq, dk, dv), "qkv"):
        _close(got, want, msg=f"d{name}")


def test_merge_partials_vs_jax():
    """The ring's LSE merge, a whole-masked partial included."""
    rng = np.random.default_rng(4)
    o1, o2 = _normal(rng, 1, 2, 8, 16), _normal(rng, 1, 2, 8, 16)
    l1, l2 = _normal(rng, 1, 2, 8), _normal(rng, 1, 2, 8)
    l2[0, 1] = fa.NEG_INF
    for got, want in zip(_merge_partials(_t(o1), _t(l1), _t(o2), _t(l2)),
                         jax_merge_partials(*(jnp.asarray(a) for a in (o1, l1, o2, l2)))):
        _close(got, want)


def test_group_gemm_swiglu_fn_vs_jax():
    """Row 8 forward and the rematerialised backward against JAX's
    ``group_gemm_swiglu_fn`` (its Pallas forward in interpret mode)."""
    rng = np.random.default_rng(5)
    x, wg, wu = _normal(rng, 4, 16, 24, scale=0.3), _normal(rng, 4, 24, 32, scale=0.2), _normal(rng, 4, 24, 32, scale=0.2)
    c = _normal(rng, 4, 16, 32)
    h, grads_j = _jax_vjp(jfn.group_gemm_swiglu_fn, (x, wg, wu), c)
    h_p, _, grads = _port_grads(fn.group_gemm_swiglu_fn, (x, wg, wu), c)
    _close(h_p, h)
    for got, want, name in zip(grads, grads_j, ("x", "w_gate", "w_up")):
        _close(got, want, msg=name)


def test_attention_block_step_vs_jax():
    """One SGD step of the ``test-dense`` attention block (the loss of
    ``test_model_training_step`` at world 1): the loss, the gradients of
    wqkv and wo, and the loss after the step, against JAX's."""
    from triton_dist_tpu.layers.tp import RMSNorm, apply_rope

    cfg = PRESETS["test-dense"]
    rng = np.random.default_rng(6)
    hq, hkv, hd, dm = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
    embed = _normal(rng, cfg.vocab_size, dm, scale=0.02 * 25)
    ln1 = (1.0 + 0.1 * rng.standard_normal(dm)).astype(np.float32)
    wqkv, wo = _normal(rng, dm, (hq + 2 * hkv) * hd, scale=dm ** -0.5), _normal(rng, hq * hd, dm, scale=(hq * hd) ** -0.5)
    tokens = np.array([[3, 17, 42, 7, 9, 11, 2, 5]], np.int32)

    def jax_loss(wqkv_, wo_):
        bsz, seq = tokens.shape
        x = jnp.asarray(embed)[tokens].reshape(bsz * seq, dm)
        h = RMSNorm(weight=jnp.asarray(ln1), eps=cfg.rms_eps)(x)
        qkv = jnp.dot(h, wqkv_, preferred_element_type=jnp.float32).astype(x.dtype).reshape(bsz, seq, -1, hd)
        pos = jnp.broadcast_to(jnp.arange(seq, dtype=jnp.int32)[None], (bsz, seq))
        q = apply_rope(qkv[:, :, :hq].transpose(0, 2, 1, 3), pos, cfg.rope_theta)
        k = apply_rope(qkv[:, :, hq:hq + hkv].transpose(0, 2, 1, 3), pos, cfg.rope_theta)
        v = qkv[:, :, hq + hkv:].transpose(0, 2, 1, 3)
        o = jfn.flash_attention_fn(q, k, v, True).transpose(0, 2, 1, 3).reshape(bsz * seq, -1)
        out = jnp.dot(o, wo_, preferred_element_type=jnp.float32)
        return jnp.sum(out ** 2) / out.size

    lr = 0.05
    step = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1)))
    val_j, (gq_j, go_j) = step(wqkv, wo)
    val2_j = step(wqkv - lr * gq_j, wo - lr * go_j)[0]

    leaves = [_t(wqkv).requires_grad_(), _t(wo).requires_grad_()]
    loss = attention_block_loss(_t(embed), _t(ln1), *leaves, _t(tokens).long(), cfg)
    loss.backward()
    with torch.no_grad():
        loss2 = attention_block_loss(_t(embed), _t(ln1), *(w - lr * w.grad for w in leaves), _t(tokens).long(), cfg)
    _close(loss, val_j)
    _close(leaves[0].grad, gq_j, msg="wqkv")
    _close(leaves[1].grad, go_j, msg="wo")
    _close(loss2, val2_j)
    assert float(loss2) < float(loss.detach())


# -------------------------------------------------------------- world 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(tmp_path_factory.mktemp("function") / "store", WORLD)
    yield r
    r.close()


@pytest.fixture(scope="module")
def mesh4():
    from triton_dist_tpu.runtime.mesh import initialize_distributed
    from triton_dist_tpu.runtime.platform import cpu_mesh

    m = cpu_mesh((WORLD,), ("tp",))
    return initialize_distributed(devices=list(m.devices.flat), axis_names=("tp",), set_default=False)


def grads_of(ctx, loss_shard, in_specs, args):
    """JAX's gradient of the sum over the mesh of ``loss_shard``
    (``tests/test_function.py::grads_of``)."""
    f = jax.jit(jax.grad(
        lambda *a: jax.shard_map(loss_shard, mesh=ctx.mesh, in_specs=in_specs, out_specs=P(),
                                 check_vma=False)(*a)[()],
        argnums=tuple(range(len(args)))))
    return f(*(jnp.asarray(a) for a in args))


def _rows(a, r):
    n = a.shape[0] // WORLD
    return np.ascontiguousarray(a[r * n:(r + 1) * n])


def _cols(a, r):
    n = a.shape[1] // WORLD
    return np.ascontiguousarray(a[:, r * n:(r + 1) * n])


def _run(ranks, op, per_rank, **kw):
    return ranks.ok("function_grads", [dict(op=op, args=args, c=c, **kw) for args, c in per_rank])


def test_ag_gemm_fn_world4(ranks, mesh4):
    """dx = RS(g @ bᵀ) and the ring weight gradient against JAX's autodiff of
    all_gather + dot."""
    rng = np.random.default_rng(10)
    m, k, n = 8, 16, 12
    x, b, c = _normal(rng, WORLD * m, k, scale=0.3), _normal(rng, k, WORLD * n, scale=0.3), _normal(rng, WORLD * m, WORLD * n)

    def loss_ref(x_, b_, c_):
        out = jnp.dot(jax.lax.all_gather(x_, "tp", tiled=True), b_, preferred_element_type=jnp.float32)
        return jax.lax.psum(jnp.sum(out * c_), "tp").reshape(())

    gx, gb, _ = grads_of(mesh4, loss_ref, (P("tp"), P(None, "tp"), P(None, "tp")), (x, b, c))
    got = _run(ranks, "ag_gemm", [((_rows(x, r), _cols(b, r)), _cols(c, r)) for r in range(WORLD)])
    _close(np.concatenate([g["grads"][0] for g in got]), gx, msg="dx")
    _close(np.concatenate([g["grads"][1] for g in got], axis=1), gb, msg="db")


def test_gemm_rs_fn_world4(ranks, mesh4):
    """da = AG(g) @ bᵀ on the ring and db against JAX's autodiff of dot +
    psum_scatter."""
    rng = np.random.default_rng(11)
    m, k, n = WORLD * 8, 16, 12
    a, b, c = _normal(rng, m, WORLD * k, scale=0.3), _normal(rng, WORLD * k, n, scale=0.3), _normal(rng, m, n)

    def loss_ref(a_, b_, c_):
        out = jax.lax.psum_scatter(jnp.dot(a_, b_, preferred_element_type=jnp.float32), "tp",
                                   scatter_dimension=0, tiled=True)
        return jax.lax.psum(jnp.sum(out * c_), "tp").reshape(())

    ga, gb, _ = grads_of(mesh4, loss_ref, (P(None, "tp"), P("tp"), P("tp")), (a, b, c))
    got = _run(ranks, "gemm_rs", [((_cols(a, r), _rows(b, r)), _rows(c, r)) for r in range(WORLD)])
    _close(np.concatenate([g["grads"][0] for g in got], axis=1), ga, msg="da")
    _close(np.concatenate([g["grads"][1] for g in got]), gb, msg="db")


def test_gemm_ar_fn_world4(ranks):
    """The replicated output's cotangents summed over the ranks: each rank's
    loss is the replicated loss over the world size, and the gradients
    equal the single full product's (JAX's gold standard)."""
    rng = np.random.default_rng(12)
    m, k, n = 16, 8, 12
    a, b, c = _normal(rng, m, WORLD * k, scale=0.3), _normal(rng, WORLD * k, n, scale=0.3), _normal(rng, m, n)
    ra, rb = jax.grad(lambda a_, b_: jnp.sum(jnp.dot(a_, b_) * c), argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    got = _run(ranks, "gemm_ar", [((_cols(a, r), _rows(b, r)), c) for r in range(WORLD)])
    for g in got:
        _close(g["out"], a @ b, tol=dict(rtol=1e-5, atol=1e-5))
    _close(np.concatenate([g["grads"][0] for g in got], axis=1), ra, msg="da")
    _close(np.concatenate([g["grads"][1] for g in got]), rb, msg="db")


@pytest.mark.parametrize("use_pallas", [True, False], ids=["row25-route", "plain-route"])
def test_all_to_all_single_fn_world4(ranks, mesh4, use_pallas):
    """The all-to-all's own transpose against JAX's ``all_to_all_single_fn``
    on its XLA route."""
    rng = np.random.default_rng(13)
    x, c = _normal(rng, WORLD * WORLD, 3, 8), _normal(rng, WORLD * WORLD, 3, 8)

    def loss(x_, c_):
        return jax.lax.psum(jnp.sum(jfn.all_to_all_single_fn(x_, "tp", None, False) * c_), "tp").reshape(())

    gx, _ = grads_of(mesh4, loss, (P("tp"), P("tp")), (x, c))
    got = _run(ranks, "a2a", [((_rows(x, r),), _rows(c, r)) for r in range(WORLD)], use_pallas=use_pallas)
    _close(np.concatenate([g["grads"][0] for g in got]), gx)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["row25-route", "plain-route"])
def test_ep_moe_fused_fn_world4(ranks, mesh4, use_pallas):
    """``ep_moe_fused_fn`` against JAX's XLA composition of the same EP MoE
    (``tests/test_function.py::test_ep_moe_fused_grad``'s reference): x and
    the experts sharded, the router's gradient summed over the ranks."""
    rng = np.random.default_rng(14)
    d, ff, e, t, k = 16, 24, 8, 8, 2
    el, cf = e // WORLD, 4.0
    x = _normal(rng, WORLD * t, d, scale=0.3)
    wr = _normal(rng, d, e)
    wg, wu, wd = _normal(rng, e, d, ff, scale=0.2), _normal(rng, e, d, ff, scale=0.2), _normal(rng, e, ff, d, scale=0.2)
    c = _normal(rng, WORLD * t, d)

    def loss_ref(x_, wr_, wg_, wu_, wd_, c_):
        idx, w = jmu.topk_routing(jnp.dot(x_, wr_, preferred_element_type=jnp.float32), k)
        cap = jmu.capacity_for(t, k, e, cf)
        plan = jmu.make_routing_plan(idx, e, cap)
        buf = jmu.dispatch(x_, plan).reshape(WORLD, el * cap, d)
        recv = jax.lax.all_to_all(buf, "tp", split_axis=0, concat_axis=0, tiled=False)
        xe = recv.reshape(WORLD, el, cap, d).transpose(1, 0, 2, 3).reshape(el, WORLD * cap, d)
        dims = (((2,), (1,)), ((0,), (0,)))
        g = jax.lax.dot_general(xe, wg_, dims, preferred_element_type=jnp.float32)
        u = jax.lax.dot_general(xe, wu_, dims, preferred_element_type=jnp.float32)
        y = jax.lax.dot_general(jax.nn.silu(g) * u, wd_, dims, preferred_element_type=jnp.float32)
        back = y.reshape(el, WORLD, cap, d).transpose(1, 0, 2, 3).reshape(WORLD, el * cap, d)
        recv_b = jax.lax.all_to_all(back, "tp", split_axis=0, concat_axis=0, tiled=False)
        out = jmu.combine(recv_b.reshape(e, cap, d), plan, w, t)
        return jax.lax.psum(jnp.sum(out * c_), "tp").reshape(())

    specs = (P("tp"), P(), P("tp"), P("tp"), P("tp"), P("tp"))
    ref = grads_of(mesh4, loss_ref, specs, (x, wr, wg, wu, wd, c))[:5]
    per_rank = [((_rows(x, r), wr, _rows(wg, r), _rows(wu, r), _rows(wd, r)), _rows(c, r)) for r in range(WORLD)]
    got = _run(ranks, "ep_moe", per_rank, num_experts=e, top_k=k, capacity_factor=cf, use_pallas_a2a=use_pallas)
    for i, name in enumerate(["x", "w_router", "w_gate", "w_up", "w_down"]):
        if name == "w_router":
            for g in got:  # summed over the ranks: the same on every rank
                _close(g["grads"][i], ref[i], msg=name)
        else:
            _close(np.concatenate([g["grads"][i] for g in got]), ref[i], msg=name)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_attention_fn_world4(ranks, causal):
    """The ring (KV rotating on ``ppermute_fn``, the merge, the per-step
    rows 1 + 5 with offsets and dlse) against ``jax.grad`` of JAX's
    ``attention_reference`` over the global sequence."""
    rng = np.random.default_rng(15)
    b, hq, hkv, s_loc, d = 1, 4, 2, 16, 16
    s = WORLD * s_loc
    q, k, v = (_normal(rng, b, h, s, d, scale=0.3) for h in (hq, hkv, hkv))
    c = _normal(rng, b, hq, s, d)
    ref = jax.grad(lambda *a: jnp.sum(jfa.attention_reference(*a, causal=causal) * c), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    def shard(a, r):
        return np.ascontiguousarray(a[:, :, r * s_loc:(r + 1) * s_loc])

    got = _run(ranks, "ring", [((shard(q, r), shard(k, r), shard(v, r)), shard(c, r)) for r in range(WORLD)],
               causal=causal)
    for i, name in enumerate("qkv"):
        _close(np.concatenate([g["grads"][i] for g in got], axis=2), ref[i], tol=RING_TOL, msg=f"d{name}")


def test_ring_attention_varlen_fn_world4(ranks, varlen_ref):
    """The varlen ring (rows 4 + 6 each step) on the packed stream of the
    varlen cases cut into 4 shards of 24 tokens (a sequence spans two
    shards; the padding tail is rank 3's), against JAX's
    ``flash_attention_varlen_fn`` over the whole stream."""
    (q, k, v, c, _), _, (_, ref) = varlen_ref
    s_loc = VARLEN["t"] // WORLD

    def shard(a, r):
        return np.ascontiguousarray(a[:, r * s_loc:(r + 1) * s_loc])

    got = _run(ranks, "ring_varlen", [((shard(q, r), shard(k, r), shard(v, r)), shard(c, r)) for r in range(WORLD)],
               cu_seqlens=CU)
    for i, name in enumerate("qkv"):
        _close(np.concatenate([g["grads"][i] for g in got], axis=1), ref[i], tol=RING_TOL, msg=f"d{name}")


def test_unported_functions_raise():
    """What needs a two-axis mesh raises and names it (item D1).
    ``ag_attention_fn`` (row 27) no longer raises: at world 1 it is rows 1
    and 5 (``tests/test_torch_sp.py`` holds it at world 4)."""
    q, kv = torch.zeros((1, 4, 8, 32)), torch.zeros((1, 2, 8, 32))
    assert fn.ag_attention_fn(None, q, kv, kv).shape == q.shape
    for f in (fn.ring_attention_2d_fn, fn.ring_attention_2d_varlen_fn):
        with pytest.raises(NotImplementedError, match="two-axis mesh.*D1"):
            f(None, None, None)

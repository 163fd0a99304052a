"""Pipeline parallelism of the port on the CPU, held against the JAX
package: the GPipe schedule, its gradient, the stage handoff
(``PPCommLayer``, row 23's plain version) and the pp × tp engine.

Four rank processes (``tests/test_torch_tp_ranks.py``, started once for the
module, laid out as ``pp`` × ``tp`` = 2 × 2: global rank r at ``pp = r //
2``, ``tp = r % 2``) import only the port and run the plain versions; this
process computes the JAX side on 4-device CPU meshes and hands both sides
the same numpy inputs, each JAX reference once per module. JAX's Pallas
collectives do not lower here, so its schedule runs with ``backend="xla"``.

Tolerances. The schedule moves bytes: on a stack whose products are exact
in fp32 (small integers, identity activation) the port's pipeline is
bitwise JAX's, and on ``tests/test_pp.py``'s ``tanh(h @ w)`` stack it is
bitwise the port's own sequential sweep. Against JAX's pipeline on that
stack the two frameworks' ``tanh`` and ``dot`` differ in the last bits (XLA's
CPU ``tanh`` is its own approximation), so outputs are held within ``1e-6``
and gradients within ``1e-6`` relative, in fp32. The engine's prefill
logits and KV are bitwise the port's tp-2 engine's (JAX's internal
contract, ``tests/test_pp.py``), its streams token-equal to JAX's tp-2
``xla`` engine and its logits within ``1e-4`` of JAX's.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from test_torch_tp_ranks import Ranks

from triton_dist_tpu.layers.pp import PPCommLayer as JPPCommLayer
from triton_dist_tpu.layers.pp_schedule import gpipe_forward as j_gpipe_forward
from triton_dist_tpu.layers.pp_schedule import gpipe_stage_params as j_gpipe_stage_params
from triton_dist_tpu.models import PRESETS as JPRESETS
from triton_dist_tpu.models import DenseLLM as JDenseLLM
from triton_dist_tpu.models import Engine as JEngine
from triton_dist_tpu.runtime.mesh import initialize_distributed as j_initialize_distributed
from triton_dist_tpu.runtime.platform import cpu_mesh
from triton_dist_tpu_torch.models import PRESETS, DenseLLM, Engine
from triton_dist_tpu_torch.runtime.mesh import DistContext

torch.set_num_threads(2)  # six test workers share the host

WORLD = 4
L, D, MB = 4, 8, 2  # the toy stack of tests/test_pp.py: layers, width, rows a microbatch
SCHEDULE_TOL = dict(rtol=1e-6, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
SERVE_IDS = np.random.default_rng(0).integers(0, 256, (4, 8)).tolist()
SLOT_PROMPTS = [list(np.random.default_rng(s).integers(0, 256, n)) for s, n in ((1, 5), (2, 9), (3, 12), (4, 7))]
REMAINING, CHUNK, GEN, MAX_LEN = [4, 2, 3, 0], 4, 6, 32


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(tmp_path_factory.mktemp("pp") / "store", WORLD, axes=(("pp", 2), ("tp", 2)))
    yield r
    r.close()


# ------------------------------------------------------------- the schedule


def _toy(m_total: int, seed: int):
    rng = np.random.default_rng(seed)
    ws = (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((m_total, MB, D)).astype(np.float32)
    exact_ws = rng.integers(-1, 2, (L, D, D)).astype(np.float32)  # |h| stays < 2^24: exact sums
    exact_x = rng.integers(-4, 5, (m_total, MB, D)).astype(np.float32)
    return ws, x, exact_ws, exact_x


@pytest.fixture(scope="module")
def jax_pipeline():
    """JAX's GPipe on a 4-stage CPU mesh (``tests/test_pp.py``'s
    ``_pipeline``, with the activation as a parameter)."""
    m = cpu_mesh((4,), ("pp",))
    ctx = j_initialize_distributed(devices=list(m.devices.flat), axis_names=("pp",), set_default=False)
    comm = JPPCommLayer(axis="pp", backend="xla", mesh_axes=("pp",))

    def pipeline(ws, x, act):
        def fn(w, xb):
            def stage(h):
                for layer in range(L // 4):
                    h = act(h @ j_gpipe_stage_params(w, L, axis="pp")[layer])
                return h

            out = j_gpipe_forward(stage, xb, axis="pp", comm=comm, unroll=True)
            return jax.lax.all_gather(out, "pp", axis=0)[3]

        return jax.shard_map(fn, mesh=ctx.mesh, in_specs=(P(), P()), out_specs=P(), check_vma=False)(ws, x)

    return pipeline


def _sequential(ws, x):
    """The port's per-microbatch sweep with the pipeline's shapes."""
    out = []
    for m in range(x.shape[0]):
        h = torch.from_numpy(x[m])
        for w in torch.from_numpy(ws):
            h = torch.tanh(h @ w)
        out.append(h)
    return torch.stack(out).numpy()


@pytest.mark.parametrize("m_total", [1, 3, 6])
def test_gpipe_matches_jax(ranks, jax_pipeline, m_total):
    """4 stages, M microbatches (M = 1 is almost all masked ticks): the
    port's schedule bitwise JAX's on the exact stack; on the tanh stack
    bitwise the port's sequential sweep, its ``unroll=False`` body bitwise
    the unrolled one, within ``1e-6`` of JAX's pipeline; every rank holds
    the same broadcast output."""
    ws, x, exact_ws, exact_x = _toy(m_total, m_total)
    got = ranks.ok("pp_gpipe", dict(stages=4, ws=ws, x=x, exact_ws=exact_ws, exact_x=exact_x))
    want_exact = np.asarray(jax.jit(lambda w, xb: jax_pipeline(w, xb, lambda h: h))(exact_ws, exact_x))
    want_tanh = np.asarray(jax.jit(lambda w, xb: jax_pipeline(w, xb, jnp.tanh))(ws, x))
    seq = _sequential(ws, x)
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g["exact"], want_exact, err_msg=f"rank {r}")
        np.testing.assert_array_equal(g["tanh"], seq, err_msg=f"rank {r}")
        np.testing.assert_array_equal(g["tanh_scan"], g["tanh"], err_msg=f"rank {r}")
        np.testing.assert_allclose(g["tanh"], want_tanh, **SCHEDULE_TOL, err_msg=f"rank {r}")


def test_gpipe_gradient_matches_jax(ranks, jax_pipeline):
    """``backward`` through the port's schedule (the shift's gradient rides
    ``send_prev``), summed over the stages, against ``jax.grad`` through
    JAX's pipeline: within ``1e-6`` relative."""
    ws, x, exact_ws, exact_x = _toy(3, 11)
    got = ranks.ok("pp_gpipe", dict(stages=4, ws=ws, x=x, exact_ws=exact_ws, exact_x=exact_x, grad_x=x))
    want = np.asarray(jax.jit(jax.grad(lambda w: jnp.sum(jax_pipeline(w, x, jnp.tanh) ** 2)))(ws))
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["grad"], want, rtol=1e-6, atol=1e-6 * np.abs(want).max(), err_msg=f"rank {r}")


def test_pp_comm_layer_matches_ppermute(ranks):
    """``send_next`` / ``send_prev`` on both backends and ``p2p_send_recv``
    over the ``pp`` axis of the 2 × 2 layout, and ``send_next`` over all
    four ranks, against ``lax.ppermute`` on JAX meshes of the same layout."""
    x = np.random.default_rng(5).standard_normal((WORLD, 3, 16)).astype(np.float32)
    got = ranks.ok("pp_comm", [dict(x=x[r]) for r in range(WORLD)])

    def shifted(mesh_shape, names, axis, offset):
        mesh = cpu_mesh(mesh_shape, names)
        size = mesh.shape[axis]
        perm = [(i, (i + offset) % size) for i in range(size)]
        spec = P(names)
        f = jax.shard_map(lambda v: jax.lax.ppermute(v, axis, perm), mesh=mesh, in_specs=spec, out_specs=spec)
        return np.asarray(jax.jit(f)(x.reshape(WORLD * 3, 16))).reshape(WORLD, 3, 16)

    nxt, prv = shifted((2, 2), ("pp", "tp"), "pp", 1), shifted((2, 2), ("pp", "tp"), "pp", -1)
    ring4 = shifted((4,), ("pp",), "pp", 1)
    for r, g in enumerate(got):
        for backend in ("pallas", "xla"):
            np.testing.assert_array_equal(g[f"next {backend}"], nxt[r])
            np.testing.assert_array_equal(g[f"prev {backend}"], prv[r])
        np.testing.assert_array_equal(g["send_recv"], prv[r])
        np.testing.assert_array_equal(g["next pp4"], ring4[r])


# --------------------------------------------------------- the pp × tp engine


@pytest.fixture(scope="module")
def jmodel():
    ctx = j_initialize_distributed(axis_names=("tp",), devices=jax.devices("cpu")[:2], set_default=False)
    return JDenseLLM(JPRESETS["test-dense"], ctx, key=jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def jax_tp2(jmodel):
    """JAX's tp-2 ``xla`` engine on the serve and slot requests."""
    eng = JEngine(jmodel, backend="xla", max_len=MAX_LEN)
    ids = jnp.asarray(SERVE_IDS, jnp.int32)
    logits = np.asarray(eng._prefill(jmodel.params, ids)[0])
    served = np.asarray(eng.serve(ids, GEN, key=jax.random.PRNGKey(7)))
    cache = eng.alloc_slots(len(SLOT_PROMPTS))
    first = []
    for slot, p in enumerate(SLOT_PROMPTS):
        t0, cache = eng.prefill_into_slot(cache, slot, jnp.asarray([p], jnp.int32))
        first.append(int(t0))
    out, _, cache, _ = eng.decode_steps(cache, jnp.asarray(first, jnp.int32), jnp.asarray(REMAINING, jnp.int32),
                                        CHUNK)
    return {"logits": logits, "served": served, "first": first, "out": np.asarray(out),
            "lengths": np.asarray(cache.lengths)}


@pytest.fixture(scope="module")
def served(ranks, jmodel):
    """Per backend, the ranks' pp × tp and tp-2 engines on the JAX weights
    (computed once, on first use)."""
    arrays = {f.name: None if getattr(jmodel.params, f.name) is None else np.asarray(getattr(jmodel.params, f.name))
              for f in dataclasses.fields(jmodel.params)}
    cache = {}

    def get(backend):
        if backend not in cache:
            cache[backend] = ranks.ok("pp_serve", dict(arrays=arrays, backend=backend, ids=SERVE_IDS, gen_len=GEN,
                                                       prompts=SLOT_PROMPTS, remaining=REMAINING, chunk=CHUNK,
                                                       max_len=MAX_LEN))
        return cache[backend]

    return get


@pytest.mark.parametrize("backend", ["xla", "dist_ar"])
def test_pp_engine_prefill_bitwise_vs_tp2(served, backend):
    """The 2 × 2 prefill (one microbatch a prompt row, KV through the aux
    channel, each stage keeping its layers) gives the port's tp-2 engine's
    logits bit for bit, and its stage slabs gathered over ``pp`` the tp-2
    engine's K and V; the pipeline engine's caches hold L / 2 layers."""
    for r, g in enumerate(served(backend)):
        pp, tp = g["pp"], g["tp"]
        assert pp["pp_world"] == 2 and tp["pp_world"] == 1
        assert pp["cache_layers"] == PRESETS["test-dense"].num_layers // 2
        for key in ("logits", "k", "v"):
            np.testing.assert_array_equal(pp[key], tp[key], err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("backend", ["xla", "dist_ar"])
def test_pp_engine_streams_equal_jax_tp2(served, jax_tp2, backend):
    """``serve`` and the slots (``prefill_into_slot`` + ``decode_steps``,
    round-robin groups of 2 over the stages) on the 2 × 2 engine: tokens
    equal to JAX's tp-2 ``xla`` engine's and to the port's tp-2 engine's,
    logits within ``1e-4`` of JAX's."""
    for r, g in enumerate(served(backend)):
        pp = g["pp"]
        np.testing.assert_allclose(pp["logits"], jax_tp2["logits"], **LOGIT_TOL)
        np.testing.assert_array_equal(pp["served"], jax_tp2["served"], err_msg=f"rank {r}")
        assert pp["first"] == jax_tp2["first"], r
        np.testing.assert_array_equal(pp["out"], jax_tp2["out"], err_msg=f"rank {r}")
        np.testing.assert_array_equal(pp["lengths"], jax_tp2["lengths"], err_msg=f"rank {r}")
        for key in ("served", "out"):
            np.testing.assert_array_equal(pp[key], g["tp"][key], err_msg=f"rank {r} {key}")


def _pp_context(pp: int, tp: int) -> DistContext:
    """Rank 0's context of a pp × tp layout, without groups: enough to
    build a model and an engine (no collective runs at construction)."""
    cpu = torch.device("cpu")
    axes = {"pp": DistContext(0, pp, cpu, axis_names=("pp",)), "tp": DistContext(0, tp, cpu)}
    return DistContext(0, pp * tp, cpu, axis_names=("pp", "tp"), axes=axes)


def test_pp_engine_refuses_what_jax_refuses():
    """At pp > 1: ``dist`` and ``mega`` raise with JAX's message, the paged
    entry points raise (B3), and layers that do not split over the stages
    raise; a context without a ``pp`` axis stays tensor-parallel."""
    gen = torch.Generator().manual_seed(0)
    model = DenseLLM(PRESETS["test-dense"], ctx=_pp_context(2, 2), generator=gen)
    assert (model.world, model.pp_world) == (2, 2)
    assert model.params.wqkv.shape[-1] == (8 + 2 * 4) * 32 // 2
    for backend in ("dist", "mega"):
        with pytest.raises(ValueError, match=r"pp>1 supports the xla/dist_ar backends"):
            Engine(model, backend=backend)
    engine = Engine(model, backend="xla", max_len=32)
    assert engine.pp_world == 2 and engine.alloc_slots(3).k.shape[0] == 1
    with pytest.raises(NotImplementedError, match="item B3"):
        engine.alloc_paged(2, block_size=16, num_blocks=5)
    with pytest.raises(ValueError, match="must divide over pp=4 stages"):
        Engine(DenseLLM(PRESETS["test-dense"], ctx=_pp_context(4, 1), generator=gen), backend="xla")
    flat = DenseLLM(PRESETS["test-dense"], ctx=types.SimpleNamespace(rank=0, world=2, device=torch.device("cpu")),
                    generator=gen)
    assert (flat.world, flat.pp_world) == (2, 1)

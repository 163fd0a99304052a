"""The port's paged KV pool held against the JAX package at tensor-parallel
world 1: ``BlockAllocator``, the block-table walk ``paged_flash_decode``,
the paged mega back-leg ``fused_paged_attn_back``, the paged step plans,
and the engine's paged entry points (``alloc_paged`` → ``prefill_chunk`` →
``complete_paged_prefill`` → ``decode_steps_paged``) on ``test-dense`` and
``test-moe`` (fp32), mega against the JAX mega engine and the port's own
``dist`` against its ``mega`` and its contiguous ``decode_steps``; and
``Qwen3MoE`` served on mega (contiguous) against the JAX mega engine.

The JAX side runs on a 1-device CPU mesh, its Pallas kernels in interpret
mode; the port runs with ``device="cpu"`` (the plain versions). Inputs and
weights come from numpy seeds (the weights at ``init_params``'s scales),
handed to both packages. Tolerances: fp32 summed in another order, ``rtol = atol =
1e-4``; bf16 ``2e-2``; tokens, plans, allocator results and data movement
(pool scatters of given rows, gathers) must be exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.kernels.flash_decode import gather_paged_kv as jgather_paged_kv
from triton_dist_tpu.kernels.flash_decode import paged_flash_decode as jpaged_flash_decode
from triton_dist_tpu.megakernel import ModelBuilder as JModelBuilder
from triton_dist_tpu.megakernel import kernels as jmk
from triton_dist_tpu.models import PRESETS as JPRESETS
from triton_dist_tpu.models import DenseLLM as JDenseLLM
from triton_dist_tpu.models import Engine as JEngine
from triton_dist_tpu.models import Qwen3MoE as JQwen3MoE
from triton_dist_tpu.models.dense import DenseParams as JDenseParams
from triton_dist_tpu.models.kv_cache import BlockAllocator as JBlockAllocator
from triton_dist_tpu_torch.kernels.flash_decode import (
    decode_reference,
    gather_paged_kv,
    paged_flash_decode,
)
from triton_dist_tpu_torch.megakernel import ModelBuilder
from triton_dist_tpu_torch.megakernel import kernels as mk
from triton_dist_tpu_torch.models import PRESETS, DenseLLM, Engine, Qwen3MoE, init_params, params_from_numpy
from triton_dist_tpu_torch.models.kv_cache import NULL_BLOCK, BlockAllocator

torch.set_num_threads(2)  # six test workers share the host

TOL = {"fp32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _pair(a: np.ndarray, dt: str):
    return jnp.asarray(a, JDT[dt]), torch.from_numpy(np.ascontiguousarray(a)).to(TDT[dt])


def _close(got: torch.Tensor, want, dt: str):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dt])


def test_block_allocator_matches_jax():
    """One scripted sequence of alloc / incref / free / ensure_exclusive
    gives the same results, counts and errors in both packages."""
    script = [
        ("alloc", 3), ("alloc", 2), ("incref", [2, 4]), ("free", [1]), ("alloc", 1),
        ("ensure_exclusive", 2), ("ensure_exclusive", 3), ("free", [2, 4]), ("alloc", 9),
        ("alloc", 4), ("free", [NULL_BLOCK]), ("incref", [NULL_BLOCK]), ("incref", [7]),
        ("free", [5, 5]), ("alloc", -1), ("alloc", 0),
    ]

    def run(alloc):
        log = []
        for op, arg in script:
            try:
                got = getattr(alloc, op)(arg)
            except ValueError as e:
                got = ("ValueError", str(e))
            log.append((op, got, alloc.num_free, alloc.num_used, alloc.num_shared,
                        [alloc.refcount(b) for b in range(alloc.num_blocks)]))
        try:
            while True:  # drain, then copy-on-write with a dry pool
                if not alloc.alloc(1):
                    break
            alloc.incref([1])
            alloc.ensure_exclusive(1)
        except RuntimeError as e:
            log.append(("RuntimeError", str(e)))
        return log

    want = run(JBlockAllocator(10))
    assert run(BlockAllocator(10)) == want
    assert ("RuntimeError", "KV pool exhausted during copy-on-write") in want
    for n in (0, 1):
        with pytest.raises(ValueError, match="need >= 2 blocks"):
            BlockAllocator(n)


def _paged_inputs(hkv: int, seed: int):
    """A contiguous cache scattered into a shuffled pool: every (sequence,
    logical block) owns a distinct pool block, the chain ends in NULL
    entries past each length (lengths 0, bs - 1, bs, a mid one, and S)."""
    bs, mb, hq, d = 8, 4, 8, 32
    s = mb * bs
    lengths = np.asarray([0, bs - 1, bs, 13, s], np.int32)
    b = len(lengths)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    nb = 1 + b * mb
    tables = rng.permutation(np.arange(1, nb)).reshape(b, mb).astype(np.int32)
    pools = [rng.standard_normal((nb, hkv, bs, d)).astype(np.float32) for _ in range(2)]
    for p in pools:
        p[NULL_BLOCK] = 0.0
    for i in range(b):
        tables[i, -(-int(lengths[i]) // bs):] = NULL_BLOCK
    return (q, *pools, tables, lengths)


@pytest.mark.parametrize("dt,hkv", [("fp32", 4), ("bf16", 2)])
def test_paged_decode_vs_jax(dt, hkv):
    q, kp, vp, tables, lengths = _paged_inputs(hkv, seed=hkv)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dt) for a in (q, kp, vp))
    want_o, want_lse = jpaged_flash_decode(jq, jk, jv, jnp.asarray(tables), jnp.asarray(lengths),
                                              impl="pallas", return_lse=True)
    ttab, tlen = torch.from_numpy(tables), torch.from_numpy(lengths)
    got_o, got_lse = paged_flash_decode(tq, tk, tv, ttab, tlen, return_lse=True)
    assert got_o.dtype == TDT[dt] and got_lse.dtype == torch.float32
    _close(got_o, want_o, dt)
    _close(got_lse, want_lse, dt)
    assert (got_o[0] == 0).all() and (got_lse[0] == -1e30).all()  # no key: o = 0, lse = -1e30
    # The plain walk is the contiguous decode on the gathered view, bitwise.
    kc, vc = gather_paged_kv(tk, ttab), gather_paged_kv(tv, ttab)
    ref_o, ref_lse = decode_reference(tq, kc, vc, tlen, return_lse=True)
    assert torch.equal(got_o, ref_o) and torch.equal(got_lse, ref_lse)
    np.testing.assert_array_equal(kc.float().numpy(), np.asarray(jgather_paged_kv(jk, jnp.asarray(tables)),
                                                                   np.float32))
    with pytest.raises(NotImplementedError, match="item E"):
        paged_flash_decode(tq, tk, tv, ttab, tlen, k_scale=tk, v_scale=tv)


def test_fused_paged_attn_back_vs_jax():
    """Slot 0 mid-chain, slot 1 inactive (its write goes to the NULL block),
    slot 2 with a full chain (length == max_blocks·bs: the write drops, as
    JAX's out-of-range table index does). The pools after the scatter are
    exactly JAX's; the fp32 partial within tolerance."""
    rng = np.random.default_rng(5)
    cfg = PRESETS["test-dense"]
    nl, nb, bs, mb = 2, 12, 4, 3
    hq, hkv, hd, n = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((3, hq, hd), (3, hkv, hd), (3, hkv, hd), (nl, nb, hkv, bs, hd), (nl, nb, hkv, bs, hd))]
    wo = (rng.standard_normal((hq * hd, n)) * 0.1).astype(np.float32)
    tables = np.asarray([[5, 2, 9], [7, 0, 0], [3, 11, 1]], np.int32)
    lengths = np.asarray([6, 3, mb * bs], np.int32)
    active = np.asarray([True, False, True])
    for li in (1,):
        part, pk, pv = jmk.fused_paged_attn_back(
            *(jnp.asarray(a) for a in arrays), li, jnp.asarray(tables), jnp.asarray(lengths),
            jnp.asarray(active), jnp.asarray(wo))
        t = [torch.from_numpy(a.copy()) for a in arrays]
        tpart, tpk, tpv = mk.fused_paged_attn_back(
            *t, li, torch.from_numpy(tables), torch.from_numpy(lengths), torch.from_numpy(active),
            torch.from_numpy(wo))
        assert tpk is t[3] and tpv is t[4]  # written in place
        np.testing.assert_array_equal(tpk.numpy(), np.asarray(pk))
        np.testing.assert_array_equal(tpv.numpy(), np.asarray(pv))
        _close(tpart, part, "fp32")
        assert not np.array_equal(np.asarray(pk)[li, NULL_BLOCK], arrays[3][li, NULL_BLOCK])


@pytest.mark.parametrize("policy", ["static", "cost", "scoreboard"])
@pytest.mark.parametrize("preset", ["test-dense", "test-moe"])
def test_paged_step_plan_equals_jax(preset, policy):
    want = JModelBuilder(JPRESETS[preset], world=1, schedule_policy=policy, paged=True).build_step_fn(2).plan
    got = ModelBuilder(PRESETS[preset], schedule_policy=policy, paged=True).build_step_fn(2).plan
    assert got == want
    if policy != "cost":
        assert "attn_back@1→fused_paged_attn_back_ex" in got


# ------------------------------------------------------ the engine, paged

PROMPTS = {0: [5, 9, 13, 2, 77, 8, 1, 3, 44, 61], 2: [3, 17, 42, 7, 99, 5]}
REMAINING = [5, 0, 3]  # slot 1 never joins; slot 2 stops after 3 steps
CHUNK, PREFILL_CHUNK, BS, NUM_BLOCKS, MAX_LEN = 6, 4, 8, 32, 32


def _chains():
    """Block chains from the allocator: slot 0 takes blocks 2, 3; slot 2
    takes block 1 (freed and handed out again) and 4."""
    alloc = BlockAllocator(NUM_BLOCKS)
    dummy = alloc.alloc(1)
    chains = {0: alloc.alloc(2)}
    alloc.free(dummy)
    chains[2] = alloc.alloc(2)
    return chains


def _chunked_prefill(eng, ids, tensor):
    """``ids`` through ``prefill_chunk`` in chunks of 4, the last padded.
    Returns (the last chunk's logits, kbuf, vbuf)."""
    kb, vb = eng.paged_kbuf_zeros(len(ids))
    for off in range(0, len(ids), PREFILL_CHUNK):
        chunk = np.zeros((1, PREFILL_CHUNK), np.int32)
        take = ids[off:off + PREFILL_CHUNK]
        chunk[0, :len(take)] = take
        last = len(ids) - 1 - off if off + PREFILL_CHUNK >= len(ids) else PREFILL_CHUNK - 1
        logits, kb, vb = eng.prefill_chunk(kb, vb, tensor(chunk), off, last)
    return logits, kb, vb


def _serve_paged(eng, *, tensor, argmax, replace):
    """alloc_paged → prefill_chunk (chunks of 4, the last padded) →
    complete_paged_prefill → decode_steps_paged, the same calls in either
    package (``tensor``/``argmax``/``replace`` adapt the handle). Returns
    (first tokens, out, last, remaining, paged)."""
    paged = eng.alloc_paged(3, block_size=BS, num_blocks=NUM_BLOCKS)
    chains = _chains()
    tables = np.zeros((3, paged.max_blocks), np.int32)
    lengths = np.zeros(3, np.int32)
    first = [0, 0, 0]
    for slot, ids in PROMPTS.items():
        logits, kb, vb = _chunked_prefill(eng, ids, tensor)
        tables[slot, :len(chains[slot])] = chains[slot]
        paged = eng.complete_paged_prefill(paged, kb, vb, tables[slot], 0)
        lengths[slot] = len(ids)
        first[slot] = argmax(logits)
    paged = replace(paged, tensor(tables), tensor(lengths))
    out, last, paged, rem = eng.decode_steps_paged(paged, tensor(np.asarray(first, np.int32)),
                                                   tensor(np.asarray(REMAINING, np.int32)), CHUNK)
    return first, out, last, rem, paged


def _serve_paged_port(eng):
    def replace(paged, tables, lengths):
        paged.tables.copy_(tables)
        paged.lengths.copy_(lengths)
        return paged
    return _serve_paged(eng, tensor=torch.from_numpy, argmax=lambda lg: int(torch.argmax(lg[0])),
                        replace=replace)


def _numpy_params(cfg, seed: int) -> dict:
    """Random weights with ``init_params``'s scales (embedding and router
    0.02, matrices 1/sqrt(fan-in), norms ones), made with numpy."""
    rng = np.random.default_rng(seed)
    nl, d, hd = cfg.num_layers, cfg.hidden_size, cfg.head_dim

    def normal(*shape, scale=None):
        scale = shape[-2] ** -0.5 if scale is None else scale
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    if cfg.is_moe:
        e, ff = cfg.num_experts, cfg.moe_intermediate_size
        mlp = dict(mlp_gate=normal(nl, e, d, ff), mlp_up=normal(nl, e, d, ff), mlp_down=normal(nl, e, ff, d),
                   router=normal(nl, d, e, scale=0.02))
    else:
        ff = cfg.intermediate_size
        mlp = dict(mlp_gate=normal(nl, d, ff), mlp_up=normal(nl, d, ff), mlp_down=normal(nl, ff, d), router=None)
    ones = lambda *shape: np.ones(shape, np.float32)  # noqa: E731
    return dict(embed=normal(cfg.vocab_size, d, scale=0.02), ln1=ones(nl, d),
                wqkv=normal(nl, d, (cfg.num_q_heads + 2 * cfg.num_kv_heads) * hd),
                wo=normal(nl, cfg.num_q_heads * hd, d), q_norm=ones(nl, hd), k_norm=ones(nl, hd),
                ln2=ones(nl, d), final_norm=ones(d), lm_head=normal(d, cfg.vocab_size), **mlp)


@pytest.fixture(scope="module")
def engines():
    """``engines(preset)``: the JAX mega engine on a 1-device mesh and the
    port's model on the same numpy-made weights, built once per preset and
    module."""
    from triton_dist_tpu.runtime.mesh import initialize_distributed
    from triton_dist_tpu.runtime.platform import cpu_mesh

    mesh = cpu_mesh((1,), ("tp",))
    ctx = initialize_distributed(devices=list(mesh.devices.flat), axis_names=("tp",), set_default=False)
    built = {}

    def get(preset):
        if preset not in built:
            jcls, tcls = (JQwen3MoE, Qwen3MoE) if preset == "test-moe" else (JDenseLLM, DenseLLM)
            arrays = _numpy_params(PRESETS[preset], seed=1)
            jparams = JDenseParams(**{k: None if a is None else jnp.asarray(a) for k, a in arrays.items()})
            jmodel = jcls(JPRESETS[preset], ctx, params=jparams)
            tmodel = tcls(PRESETS[preset], params_from_numpy(arrays, PRESETS[preset], "cpu"), device="cpu")
            built[preset] = JEngine(jmodel, backend="mega", max_len=MAX_LEN), tmodel
        return built[preset]
    return get


@pytest.mark.parametrize("preset", ["test-dense", "test-moe"])
def test_paged_engine_equals_jax_mega_and_own_dist(engines, preset):
    """The port's mega paged run equals the JAX mega engine's (tokens,
    lengths, remaining exactly; pools within fp32 tolerance); the port's
    dist paged run (gather → decode_steps → scatter) equals its mega run,
    pools included, and contiguous ``decode_steps`` from the same chunked
    prefill gives the same tokens. (A one-shot prefill need not: a MoE
    layer routes per call, so its capacity drops differ from the chunks'.)"""
    jeng, tmodel = engines(preset)
    first, out, last, rem, paged = _serve_paged(
        jeng, tensor=jnp.asarray, argmax=lambda lg: int(jnp.argmax(lg[0])),
        replace=lambda p, t, n: dataclasses.replace(p, tables=t, lengths=n))
    want = dict(first=first, out=np.asarray(out), last=np.asarray(last), rem=np.asarray(rem),
                lengths=np.asarray(paged.lengths), k=np.asarray(paged.k), v=np.asarray(paged.v))
    runs = {b: _serve_paged_port(Engine(tmodel, backend=b, max_len=MAX_LEN)) for b in ("mega", "dist")}
    first, out, last, rem, paged = runs["mega"]
    assert first == want["first"]
    np.testing.assert_array_equal(out.numpy(), want["out"])
    np.testing.assert_array_equal(last.numpy(), want["last"])
    np.testing.assert_array_equal(rem.numpy(), want["rem"])
    assert paged.lengths.tolist() == want["lengths"].tolist() == [10 + 5, 0, 6 + 3]
    assert (out[1] == -1).all() and (out[0, 5:] == -1).all() and (out[2, 3:] == -1).all()
    _close(paged.k, want["k"], "fp32")
    _close(paged.v, want["v"], "fp32")

    d_first, d_out, d_last, d_rem, d_paged = runs["dist"]
    assert d_first == first
    assert torch.equal(d_out, out) and torch.equal(d_last, last) and torch.equal(d_rem, rem)
    assert torch.equal(d_paged.lengths, paged.lengths)
    # Every block but NULL (whose junk rows differ by path) holds the same rows.
    torch.testing.assert_close(d_paged.k[:, 1:], paged.k[:, 1:], **TOL["fp32"])
    torch.testing.assert_close(d_paged.v[:, 1:], paged.v[:, 1:], **TOL["fp32"])

    eng = Engine(tmodel, backend="dist", max_len=MAX_LEN)
    cache = eng.alloc_slots(3)
    for slot, ids in PROMPTS.items():
        _, kb, vb = _chunked_prefill(eng, ids, torch.from_numpy)
        cache.k[:, slot, :, :len(ids)], cache.v[:, slot, :, :len(ids)] = kb[:, 0], vb[:, 0]
        cache.lengths[slot] = len(ids)
    c_out, _, cache, _ = eng.decode_steps(cache, torch.tensor(first), torch.tensor(REMAINING), CHUNK)
    assert torch.equal(c_out, out)
    assert torch.equal(cache.lengths, paged.lengths)


def test_moe_mega_serve_equals_jax_mega_and_dist(engines):
    """Qwen3MoE on mega (contiguous): the step's moe tasks route, run the
    routed-experts kernel's plain version and combine; the stream equals
    the JAX mega engine's and the port's dist engine's."""
    jeng, tmodel = engines("test-moe")
    ids = [[3, 17, 42, 7, 99, 5, 23, 11]]
    want = np.asarray(jeng.serve(jnp.asarray(ids, jnp.int32), gen_len=6))
    engine = Engine(tmodel, backend="mega", max_len=MAX_LEN)
    assert any("fused_moe_ex" in p for p in engine._mega_step.plan)
    np.testing.assert_array_equal(engine.serve(torch.tensor(ids), gen_len=6).numpy(), want)
    dist = Engine(tmodel, backend="dist", max_len=MAX_LEN).serve(torch.tensor(ids), gen_len=6)
    np.testing.assert_array_equal(dist.numpy(), want)


def test_chunked_prefill_pool_rows_equal_one_shot():
    """Chunked prefill (the last chunk padded) writes the rows a one-shot
    prefill computes, and the final chunk's logits are the one-shot logits;
    the pool holds them along the slot's chain (NULL-redirected blocks
    below start_block)."""
    cfg = PRESETS["test-dense"]
    model = DenseLLM(cfg, init_params(cfg, torch.Generator().manual_seed(3), "cpu"), device="cpu")
    eng = Engine(model, backend="mega", max_len=MAX_LEN)
    ids = PROMPTS[0]
    logits, kb, vb = _chunked_prefill(eng, ids, torch.from_numpy)
    one_logits, (ks, vs) = model.prefill(torch.tensor([ids]), mode="dist_ar")
    torch.testing.assert_close(kb, ks, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(vb, vs, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(logits, one_logits, **TOL["fp32"])

    paged = eng.alloc_paged(1, block_size=BS, num_blocks=NUM_BLOCKS)
    row = np.zeros(paged.max_blocks, np.int32)
    row[:2] = [6, 3]
    for start_block in (0, 1):
        paged.k.zero_()
        eng.complete_paged_prefill(paged, kb, vb, row, start_block)
        for j, blk in enumerate(row[:2]):
            rows = kb[:, 0, :, j * BS:(j + 1) * BS]
            got = paged.k[:, blk, :, :rows.shape[2]]
            assert torch.equal(got, rows) if j >= start_block else not got.any()
        assert not paged.k[:, 3, :, len(ids) - BS:].any()  # the padded tail of block 3

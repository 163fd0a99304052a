"""The port's int8/fp8 format held against the JAX package at world 1:
``models/quant.py`` (the quantizer, bitwise), the quantized paged pool
(``PagedKVCache.create(quant=)``), row 3b's plain version
(``paged_flash_decode`` on a quantized pool), the quantized mega back-leg
(``fused_paged_attn_back`` on ``QuantPool`` pairs) and the engine's paged
entry points on ``test-dense`` and ``test-moe`` through int8 and fp8 pools,
mega and ``dist``, against the JAX mega engine on the same quantized pool.
The world-4 quantized collective matmuls are in ``tests/test_torch_tp.py``.

The JAX side runs on a 1-device CPU mesh, its Pallas kernels in interpret
mode; the port runs with ``device="cpu"`` (the plain versions). Inputs come
from numpy seeds and reach both packages as the same numbers; JAX's
quantized state reaches the port through ``models/weights.py``'s bridge.
Tolerances: the format and every pool write are compared bitwise; walks
within ``1e-5`` in fp32 and ``2e-2`` in bf16 (the port rounds P to q's
dtype as row 3 does, JAX's quantized walk keeps P in f32); token streams
exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.kernels.flash_decode import paged_flash_decode as jpaged_flash_decode
from triton_dist_tpu.megakernel import kernels as jmk
from triton_dist_tpu.models import PRESETS as JPRESETS
from triton_dist_tpu.models import DenseLLM as JDenseLLM
from triton_dist_tpu.models import Engine as JEngine
from triton_dist_tpu.models import Qwen3MoE as JQwen3MoE
from triton_dist_tpu.models import quant as jq
from triton_dist_tpu.models.kv_cache import PagedKVCache as JPagedKVCache
from triton_dist_tpu_torch.kernels.flash_decode import paged_decode_reference, paged_flash_decode
from triton_dist_tpu_torch.megakernel import ModelBuilder
from triton_dist_tpu_torch.megakernel import kernels as mk
from triton_dist_tpu_torch.models import (
    PRESETS,
    DenseLLM,
    Engine,
    Qwen3MoE,
    params_from_numpy,
    quant_pool_from_numpy,
    quant_tensor_from_numpy,
)
from triton_dist_tpu_torch.models import quant as tq
from triton_dist_tpu_torch.models.kv_cache import NULL_BLOCK, BlockAllocator, PagedKVCache

torch.set_num_threads(2)  # six test workers share the host

WIRES = ("int8", "fp8")
TOL = {"fp32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _bytes(t) -> np.ndarray:
    """A port tensor or a JAX array as its raw bytes."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(t)).view(np.uint8)


def _assert_bitwise(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(_bytes(got), _bytes(want))


def _edge_rows() -> np.ndarray:
    """Rows that exercise the format: zero rows, magnitudes from 1e-30 to
    1e30, values whose scaled magnitude sits at the clip edge (240, 127.5,
    128) and ties at .5 of the int8 grid, beside unit normals."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((40, 64)).astype(np.float32)
    x[0] = 0.0
    x[1] = 0.0
    x[1, 5] = -0.0
    for i, e in enumerate(np.linspace(-30, 30, 13)):
        x[2 + i] *= np.float32(10.0 ** e)
    # absmax 1.0 → int8 scale 2^-7, fp8 scale 2^-8: the edges of each grid
    x[15, 0] = 1.0
    x[15, 1:] = np.asarray([240, 127.5, 128, 248, 244, 255.9], np.float32).repeat(11)[:63] / 256
    x[16, 0] = 1.0
    x[16, 1:] = (np.arange(63) + 0.5).astype(np.float32) / 128  # ties at .5 on the int8 grid
    x[17, 0] = -1.0
    x[17, 1:] = -(np.arange(63) + 0.5).astype(np.float32) / 128
    return x


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("wire", WIRES)
def test_quantize_rows_bitwise_vs_jax(wire, dt):
    """Payload and scales of ``quantize_rows`` / ``quantize_kv_rows`` /
    ``quantize_tensor`` equal JAX's bit for bit, and the bridge carries a
    JAX ``QuantTensor`` (column 0 of its lane-replicated scales) into the
    port's."""
    x = _edge_rows()
    jx, tx = jnp.asarray(x, JDT[dt]), torch.from_numpy(x).to(TDT[dt])
    jqv, jsv = jq.quantize_rows(jx, wire)
    tqv, tsv = tq.quantize_rows(tx, wire)
    assert tqv.dtype == tq.wire_dtype(wire) and tsv.dtype == torch.float32 and tsv.shape == (40, 1)
    _assert_bitwise(tqv, jqv)
    _assert_bitwise(tsv, jsv)
    kq, ks = tq.quantize_kv_rows(tx.reshape(4, 10, 64), wire)
    jkq, jks = jq.quantize_kv_rows(jx.reshape(4, 10, 64), wire)
    _assert_bitwise(kq, jkq)
    _assert_bitwise(ks, jks)
    jt = jq.quantize_tensor(jx, wire)
    bridged = quant_tensor_from_numpy(np.asarray(jt.q), np.asarray(jt.scale), wire, "cpu")
    ours = tq.quantize_tensor(tx, wire)
    _assert_bitwise(bridged.q, np.asarray(jt.q))
    assert torch.equal(bridged.q.view(torch.uint8), ours.q.view(torch.uint8))
    assert torch.equal(bridged.scale, ours.scale)
    np.testing.assert_array_equal(tq.dequantize_rows(tqv, tsv).numpy(), np.asarray(jq.dequantize_rows(jqv, jsv)))
    assert not tqv[0].float().any() and (tsv[:2] == 1.0).all()


@pytest.mark.parametrize("wire", WIRES)
def test_roundtrip_bound_and_requantization(wire):
    """The round trip stays inside ``ERROR_BOUND`` of each row's absmax, the
    scales are exact powers of two, and quantizing the dequantized rows
    gives the same bytes (JAX ``tests/test_quant.py:102-140``)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    x *= np.exp2(rng.integers(-12, 12, size=(64, 1))).astype(np.float32)
    q, s = tq.quantize_rows(torch.from_numpy(x), wire)
    back = tq.dequantize_rows(q, s).numpy()
    absmax = np.abs(x).max(axis=1, keepdims=True)
    assert (np.abs(back - x) <= tq.ERROR_BOUND[wire] * absmax + 1e-12).all()
    mant, _ = np.frexp(s.numpy())
    np.testing.assert_array_equal(mant, 0.5)
    t1 = tq.quantize_tensor(torch.from_numpy(x), wire)
    for dtype in (torch.float32, torch.bfloat16):  # exact in both
        t2 = tq.quantize_tensor(tq.dequantize_tensor(t1, dtype), wire)
        assert torch.equal(t1.q.view(torch.uint8), t2.q.view(torch.uint8)) and torch.equal(t1.scale, t2.scale)
    assert tq.wire_itemsize(wire) == 1 and t1.nbytes_wire == 64 * 256 + 64 * tq.SCALE_BYTES


def test_env_knobs(monkeypatch):
    for name, fn in (("TDT_QUANT_KV", tq.kv_quant_from_env), ("TDT_QUANT_WIRE", tq.wire_quant_from_env)):
        for value, want in (("", None), ("off", None), ("FP8", "fp8"), (" int8 ", "int8")):
            monkeypatch.setenv(name, value)
            assert fn() == want
        monkeypatch.setenv(name, "int4")
        with pytest.raises(ValueError, match=name):
            fn()
    with pytest.raises(ValueError, match="unknown quant wire"):
        tq.wire_dtype("bf16")


@pytest.mark.parametrize("wire", WIRES)
def test_quant_pool_create_vs_jax(wire):
    """Payload dtypes, shapes, the 1.0 scale pools and ``bytes_per_block``
    equal JAX's (9216 B a block on the test preset at block size 16, against
    32768 unquantized)."""
    cfg = PRESETS["test-dense"]
    args = (cfg.num_layers, 3, cfg.num_kv_heads, cfg.head_dim)
    kw = dict(block_size=16, num_blocks=6, max_len=40)
    want = JPagedKVCache.create(*args, **kw, dtype=jnp.float32, quant=wire)
    got = PagedKVCache.create(*args, **kw, dtype=torch.float32, device="cpu", quant=wire)
    for name in ("k", "v", "k_scale", "v_scale", "tables", "lengths"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert tuple(g.shape) == w.shape, name
        assert g.element_size() == w.dtype.itemsize, name
        np.testing.assert_array_equal(_bytes(g), _bytes(w))
    assert got.k.dtype == tq.wire_dtype(wire) and got.quant == want.quant == wire
    assert got.bytes_per_block == want.bytes_per_block == 9216
    plain = PagedKVCache.create(*args, **kw, dtype=torch.float32, device="cpu")
    assert plain.bytes_per_block == 32768 and plain.k_scale is None and plain.pool_pair() == (plain.k, plain.v)
    pk, pv = got.pool_pair()
    assert pk.q is got.k and pv.scale is got.v_scale and pk.wire == wire


# ------------------------------------------------------- row 3b, plain version

def _oracle_case(seed):
    """``test_paged_decode_quant_oracle``'s shapes (``tests/test_quant.py``)."""
    rng = np.random.default_rng(seed)
    b, hq, hkv, d, bs, nb = 2, 4, 2, 64, 16, 9
    return (rng.standard_normal((b, hq, d)).astype(np.float32),
            rng.standard_normal((nb, hkv, bs, d)).astype(np.float32),
            rng.standard_normal((nb, hkv, bs, d)).astype(np.float32),
            np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32), np.asarray([37, 61], np.int32))


def _shuffled_case(hkv, seed):
    """``tests/test_torch_paged.py``'s ``_paged_inputs``: a shuffled pool,
    lengths 0, bs - 1, bs, 13 and S, NULL past each chain."""
    bs, mb, hq, d = 8, 4, 8, 32
    lengths = np.asarray([0, bs - 1, bs, 13, mb * bs], np.int32)
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


@pytest.mark.parametrize("case", ["oracle-fp32", "shuffled-bf16-hkv2"])
@pytest.mark.parametrize("wire", WIRES)
def test_paged_decode_quant_vs_jax(wire, case):
    """Row 3b's plain version against JAX's quantized walk (its Pallas
    kernel in interpret mode) and JAX's gather oracle, on the same quantized
    pools (JAX's bytes, bridged), and bitwise against row 3's plain version
    on the pool dequantized to q's dtype."""
    dt = "bf16" if "bf16" in case else "fp32"
    q, kp, vp, tables, lengths = _oracle_case(3) if case.startswith("oracle") else _shuffled_case(2, seed=2)
    jqv = jnp.asarray(q, JDT[dt])
    (jkq, jks), (jvq, jvs) = (jq.quantize_kv_rows(jnp.asarray(p, JDT[dt]), wire) for p in (kp, vp))
    kw = dict(k_scale=jks, v_scale=jvs, return_lse=True)
    want_pal = jpaged_flash_decode(jqv, jkq, jvq, jnp.asarray(tables), jnp.asarray(lengths), impl="pallas", **kw)
    want_gat = jpaged_flash_decode(jqv, jkq, jvq, jnp.asarray(tables), jnp.asarray(lengths), impl="gather", **kw)
    pk = quant_pool_from_numpy(np.asarray(jkq), np.asarray(jks), wire, "cpu")
    pv = quant_pool_from_numpy(np.asarray(jvq), np.asarray(jvs), wire, "cpu")
    tqv = torch.from_numpy(q).to(TDT[dt])
    ttab, tlen = torch.from_numpy(tables), torch.from_numpy(lengths)
    o, lse = paged_flash_decode(tqv, pk, pv, ttab, tlen, return_lse=True)
    assert o.dtype == TDT[dt] and lse.dtype == torch.float32
    for want_o, want_lse in (want_pal, want_gat):
        np.testing.assert_allclose(o.float().numpy(), np.asarray(want_o, np.float32), **TOL[dt])
        np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse, np.float32), **TOL[dt])
    kd, vd = (tq.dequantize_kv(p.q, p.scale, TDT[dt]) for p in (pk, pv))
    ref_o, ref_lse = paged_decode_reference(tqv, kd, vd, ttab, tlen, return_lse=True)
    assert torch.equal(o, ref_o) and torch.equal(lse, ref_lse)
    # The same call through k_scale / v_scale.
    o2 = paged_flash_decode(tqv, pk.q, pv.q, ttab, tlen, k_scale=pk.scale, v_scale=pv.scale)
    assert torch.equal(o2, o)


@pytest.mark.parametrize("wire", WIRES)
def test_fused_paged_attn_back_quant_vs_jax(wire):
    """On ``QuantPool`` pairs: slot 0 mid-chain, slot 1 inactive (its row
    goes to the NULL block), slot 2 with a full chain (the write drops). The
    rows written, payload and scales, are JAX's bit for bit; the fp32
    partial within ``1e-5``."""
    rng = np.random.default_rng(9)
    cfg = PRESETS["test-dense"]
    nl, nb, bs, mb = 2, 12, 4, 3
    hq, hkv, hd, n = cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
    q, k_new, v_new = (rng.standard_normal(s).astype(np.float32) for s in ((3, hq, hd), (3, hkv, hd), (3, hkv, hd)))
    pools = [jq.quantize_kv_rows(jnp.asarray(rng.standard_normal((nl, nb, hkv, bs, hd)), jnp.float32), wire)
             for _ in range(2)]
    wo = (rng.standard_normal((hq * hd, n)) * 0.1).astype(np.float32)
    tables = np.asarray([[5, 2, 9], [7, 0, 0], [3, 11, 1]], np.int32)
    lengths = np.asarray([6, 3, mb * bs], np.int32)
    active = np.asarray([True, False, True])
    li = 1
    jpk, jpv = (jq.QuantPool(pq, ps, wire) for pq, ps in pools)
    part, jpk, jpv = jmk.fused_paged_attn_back(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new), jpk, jpv, li, jnp.asarray(tables),
        jnp.asarray(lengths), jnp.asarray(active), jnp.asarray(wo))
    tpk, tpv = (quant_pool_from_numpy(np.asarray(pq), np.asarray(ps), wire, "cpu") for pq, ps in pools)
    tpart, tpk2, tpv2 = mk.fused_paged_attn_back(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new), tpk, tpv, li,
        torch.from_numpy(tables), torch.from_numpy(lengths), torch.from_numpy(active), torch.from_numpy(wo))
    assert tpk2 is tpk and tpv2 is tpv  # written in place
    for got, want in ((tpk, jpk), (tpv, jpv)):
        _assert_bitwise(got.q, want.q)
        _assert_bitwise(got.scale, want.scale)
    np.testing.assert_allclose(tpart.numpy(), np.asarray(part), **TOL["fp32"])
    assert not np.array_equal(_bytes(tpk.scale[li, NULL_BLOCK]), _bytes(pools[0][1][li, NULL_BLOCK]))


# -------------------------------------------------------- the engine, paged

MAX_LEN, BS, NUM_BLOCKS = 32, 8, 13
#: JAX's pinned parity prompts (``tests/test_quant.py:440-451``); two of
#: them, both 18 tokens long (one prefill program), in two slots that stop
#: at different steps.
PARITY_IDX = (0, 2, 4, 6, 7, 9)
SLOTS = (2, 7)
REMAINING = [3, 2]
STEPS = max(REMAINING)


def _parity_prompt(i):
    return [(3 + 5 * i + j) % 251 + 1 for j in range(4 + (i % 5) * 7)]


def _prefill(eng, tensor):
    """Each pinned prompt through ``prefill_chunk`` in one chunk: (first
    tokens, context buffers as numpy)."""
    first, bufs = [], []
    for i in SLOTS:
        ids = np.asarray([_parity_prompt(i)], np.int32)
        kb, vb = eng.paged_kbuf_zeros(ids.shape[1])
        logits, kb, vb = eng.prefill_chunk(kb, vb, tensor(ids), 0, ids.shape[1] - 1)
        first.append(int(np.argmax(np.asarray(logits)[0])))
        bufs.append((np.asarray(kb), np.asarray(vb)))
    return first, bufs


@pytest.fixture(scope="module")
def served():
    """``served(preset)``: the JAX model at ``PRNGKey(1)`` on a 1-device
    mesh with its mega and ``xla`` engines, the port's model on the same
    weights (through ``params_from_numpy``), and the pinned prompts'
    first tokens and context buffers from JAX's ``prefill_chunk``; built
    once per preset."""
    from triton_dist_tpu.runtime.mesh import initialize_distributed
    from triton_dist_tpu.runtime.platform import cpu_mesh

    mesh = cpu_mesh((1,), ("tp",))
    ctx = initialize_distributed(devices=list(mesh.devices.flat), axis_names=("tp",), set_default=False)
    built = {}

    def get(preset):
        if preset not in built:
            jcls, tcls = (JQwen3MoE, Qwen3MoE) if preset == "test-moe" else (JDenseLLM, DenseLLM)
            jmodel = jcls(JPRESETS[preset], ctx, key=jax.random.PRNGKey(1))
            arrays = {f.name: None if getattr(jmodel.params, f.name) is None else
                      np.asarray(getattr(jmodel.params, f.name)) for f in dataclasses.fields(jmodel.params)}
            tmodel = tcls(PRESETS[preset], params_from_numpy(arrays, PRESETS[preset], "cpu"), device="cpu")
            jengines = {b: JEngine(jmodel, backend=b, max_len=MAX_LEN) for b in ("mega", "xla")}
            built[preset] = jengines, tmodel, _prefill(jengines["xla"], jnp.asarray)
        return built[preset]
    return get


def _paged_decode(eng, quant, first, bufs, *, tensor, set_rows):
    """``alloc_paged(quant=)`` → ``complete_paged_prefill`` of the given
    context buffers along chains from a ``BlockAllocator`` →
    ``decode_steps_paged``, the same calls in either package. Returns (the
    pool after the prefills, out, lengths)."""
    paged = eng.alloc_paged(len(SLOTS), block_size=BS, num_blocks=NUM_BLOCKS, quant=quant)
    alloc = BlockAllocator(NUM_BLOCKS)
    tables = np.zeros((len(SLOTS), paged.max_blocks), np.int32)
    lengths = np.zeros(len(SLOTS), np.int32)
    for slot, (kb, vb) in enumerate(bufs):
        p = kb.shape[3]
        chain = alloc.alloc(-(-(p + STEPS) // BS))
        tables[slot, :len(chain)] = chain
        paged = eng.complete_paged_prefill(paged, tensor(kb), tensor(vb), tensor(tables[slot]), 0)
        lengths[slot] = p
    pool = {k: _bytes(getattr(paged, k)).copy() for k in ("k", "v", "k_scale", "v_scale")}
    paged = set_rows(paged, tensor(tables), tensor(lengths))
    out, _, paged, _ = eng.decode_steps_paged(paged, tensor(np.asarray(first, np.int32)),
                                              tensor(np.asarray(REMAINING, np.int32)), STEPS)
    return pool, np.asarray(out), np.asarray(paged.lengths)


def _port_tensor(a):
    return torch.from_numpy(np.array(a))


def _port_set_rows(paged, tables, lengths):
    paged.tables.copy_(tables)
    paged.lengths.copy_(lengths)
    return paged


@pytest.mark.parametrize("preset,wire,backend", [
    ("test-dense", "int8", "mega"), ("test-dense", "fp8", "dist"),
    ("test-moe", "fp8", "mega"), ("test-moe", "int8", "dist")])
def test_quant_paged_engine_equals_jax(served, preset, wire, backend):
    """The pinned prompts through a quantized pool: the port's
    ``prefill_chunk`` gives JAX's first tokens and context buffers (within
    ``1e-5``); from the same buffers (JAX's, as numpy) ``complete_paged_prefill``
    writes JAX's pool bytes (payload and scales, every block but NULL's),
    and ``decode_steps_paged`` gives JAX's streams exactly, mega against
    JAX's mega engine (the new rows quantized at append, row 3b) and
    ``dist`` against JAX's ``xla`` engine (the gather bounce: rows
    quantized at the chunk's scatter). Each preset runs one wire on each
    backend, so every wire meets every preset and backend (JAX's engines
    compile anew for each wire). The quantized step's plan is the
    unquantized one."""
    jengines, tmodel, (first, bufs) = served(preset)
    eng = Engine(tmodel, backend="mega", max_len=MAX_LEN)
    t_first, t_bufs = _prefill(eng, _port_tensor)
    assert t_first == first
    for (tk, tv), (jk, jv) in zip(t_bufs, bufs):
        np.testing.assert_allclose(tk, jk, **TOL["fp32"])
        np.testing.assert_allclose(tv, jv, **TOL["fp32"])
    want_pool, want_out, want_len = _paged_decode(
        jengines["xla" if backend == "dist" else backend], wire, first, bufs, tensor=jnp.asarray,
        set_rows=lambda p, t, n: dataclasses.replace(p, tables=t, lengths=n))
    got_pool, got_out, got_len = _paged_decode(
        Engine(tmodel, backend=backend, max_len=MAX_LEN), wire, first, bufs, tensor=_port_tensor,
        set_rows=_port_set_rows)
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(got_pool[name][:, 1:], want_pool[name][:, 1:], err_msg=name)
    np.testing.assert_array_equal(got_out, want_out)
    np.testing.assert_array_equal(got_len, want_len)
    assert got_len.tolist() == [len(_parity_prompt(i)) + r for i, r in zip(SLOTS, REMAINING)]
    plan = ModelBuilder(PRESETS[preset], paged=True).build_step_fn(PRESETS[preset].num_layers).plan
    assert eng._mega_paged_step.plan == plan


def test_quant_streams_equal_unquantized_streams_on_the_pinned_family(served):
    """The bar of JAX's ``tests/test_quant.py::test_serving_greedy_parity_quant_kv``,
    held by the port: on JAX's pinned ``test-dense`` family (the six prompts
    of ``PARITY_IDX``, 6 + 2·n tokens each; weights from JAX's ``PRNGKey(1)``
    through ``params_from_numpy``), the greedy streams served through int8
    and fp8 pools equal those through the unquantized pool, token for token.
    The serving follows JAX's test: the ``xla`` engine on a paged pool of
    16-row blocks (``TDT_KV_BLOCK_SIZE``), one prefill chunk a prompt
    (``TDT_PREFILL_CHUNK`` = max_len 96), decode in chunks of 8 steps
    (``TDT_SERVE_CHUNK``), so each request's rows are quantized at the same
    points of its own timeline as under JAX's staggered server (slots do not
    see each other's rows, so all six share one batch here)."""
    _, tmodel, _ = served("test-dense")
    max_len, bs, chunk = 96, 16, 8
    gens = [6 + 2 * n for n in range(len(PARITY_IDX))]
    prompts = [_parity_prompt(i) for i in PARITY_IDX]
    chains = [-(-(len(p) + g) // bs) for p, g in zip(prompts, gens)]
    num_blocks = 1 + sum(chains)
    streams = {}
    for wire in (None, *WIRES):
        eng = Engine(tmodel, backend="xla", max_len=max_len)
        paged = eng.alloc_paged(len(prompts), block_size=bs, num_blocks=num_blocks, quant=wire)
        alloc = BlockAllocator(num_blocks)
        tables = torch.zeros((len(prompts), paged.max_blocks), dtype=torch.int32)
        first = []
        for slot, (p, n) in enumerate(zip(prompts, chains)):
            kb, vb = eng.paged_kbuf_zeros(len(p))
            logits, kb, vb = eng.prefill_chunk(kb, vb, torch.tensor([p], dtype=torch.int32), 0, len(p) - 1)
            first.append(int(torch.argmax(logits[0])))
            tables[slot, :n] = torch.tensor(alloc.alloc(n), dtype=torch.int32)
            paged = eng.complete_paged_prefill(paged, kb, vb, tables[slot], 0)
        paged = _port_set_rows(paged, tables, torch.tensor([len(p) for p in prompts], dtype=torch.int32))
        got = [[f] for f in first]
        tokens, remaining = torch.tensor(first, dtype=torch.int32), torch.tensor([g - 1 for g in gens])
        while bool((remaining > 0).any()):
            out, tokens, paged, remaining = eng.decode_steps_paged(paged, tokens, remaining, chunk)
            for slot, row in enumerate(out.tolist()):
                got[slot] += [t for t in row if t >= 0]
        assert [len(s) for s in got] == gens
        streams[wire] = got
    for wire in WIRES:
        assert streams[wire] == streams[None], f"{wire}: {streams[wire]} != {streams[None]}"

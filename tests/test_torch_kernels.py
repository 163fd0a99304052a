"""The port's attention kernels (their plain versions, which is what a CPU
tensor runs) held against the JAX package's Pallas kernels, which run in
interpret mode on the CPU as the JAX tests run them.

Inputs come from ``numpy.random.default_rng``. Tolerance: fp32 on the CPU
with a different summation order (one block here, online blocks there):
``rtol = atol = 1e-4``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.kernels.flash_attn import flash_attention as jax_flash_attention
from triton_dist_tpu.kernels.flash_decode import flash_decode as jax_flash_decode
from triton_dist_tpu_torch.kernels import flash_attention, flash_decode

# Six test workers share the host with the JAX suite: keep torch's intra-op
# pool small.
torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _rng(name: str) -> np.random.Generator:
    """A generator seeded from the case name, the same in every process."""
    return np.random.default_rng(sum(map(ord, name)))


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# (b, hq, hkv, sq, sk, d, causal, q_offset, kv_offset)
ATTN_CASES = {
    "causal-group1": (1, 4, 4, 64, 64, 32, True, None, None),
    "noncausal-group2": (2, 4, 2, 48, 48, 32, False, None, None),
    "causal-group4-sq<sk": (1, 8, 2, 32, 96, 32, True, None, None),
    "causal-group2-blocks": (1, 4, 2, 64, 64, 64, True, None, None),
    "chunk-offset": (1, 4, 2, 32, 64, 32, True, 16, 0),
    "rows-without-keys": (1, 8, 2, 32, 64, 32, True, 0, 20),
}


@pytest.mark.parametrize("return_lse", [False, True], ids=["o", "o+lse"])
@pytest.mark.parametrize("case", list(ATTN_CASES), ids=list(ATTN_CASES))
def test_flash_attention_vs_jax(case, return_lse):
    b, hq, hkv, sq, sk, d, causal, q_offset, kv_offset = ATTN_CASES[case]
    rng = _rng(case)
    q, k, v = _normal(rng, (b, hq, sq, d)), _normal(rng, (b, hkv, sk, d)), _normal(rng, (b, hkv, sk, d))
    offsets = {}
    if q_offset is not None:
        offsets = dict(q_offset=jnp.int32(q_offset), kv_offset=jnp.int32(kv_offset))
    # Small JAX blocks so the reference's online softmax crosses blocks.
    blocks = dict(block_q=16, block_k=16) if case == "causal-group2-blocks" else {}
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                               return_lse=return_lse, **blocks, **offsets)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=causal, return_lse=return_lse,
                          q_offset=q_offset, kv_offset=kv_offset)
    if not return_lse:
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if case == "rows-without-keys":
        # q_off = -20: query rows 0..19 see no key and must be exact zeros.
        o = got[0].numpy()
        assert np.all(o[:, :, :20] == 0.0)
        assert np.all(np.asarray(want[0])[:, :, :20] == 0.0)
        assert np.abs(o[:, :, 20:]).max() > 0


# (b, hq, hkv, s, d, lengths)
DECODE_CASES = {
    "group4-ragged": (4, 8, 2, 64, 32, [1, 17, 64, 40]),
    "group1-ragged": (3, 4, 4, 48, 64, [48, 1, 30]),
    "group2-empty-row": (2, 4, 2, 32, 32, [0, 9]),
}


@pytest.mark.parametrize("case", list(DECODE_CASES), ids=list(DECODE_CASES))
def test_flash_decode_vs_jax(case):
    b, hq, hkv, s, d, lengths = DECODE_CASES[case]
    rng = _rng(case)
    q = _normal(rng, (b, hq, d))
    kc, vc = _normal(rng, (b, hkv, s, d)), _normal(rng, (b, hkv, s, d))
    lens = np.asarray(lengths, np.int32)
    want_o, want_lse = jax_flash_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                        jnp.asarray(lens), block_k=16, return_lse=True)
    got_o, got_lse = flash_decode(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                                  torch.from_numpy(lens), return_lse=True)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)
    o_only = flash_decode(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                          torch.from_numpy(lens))
    np.testing.assert_array_equal(o_only.numpy(), got_o.numpy())

"""Symmetric int8/fp8 quantization: the port's copy of
``triton_dist_tpu/models/quant.py``, the one number format that the
quantized paged KV pool (``models/kv_cache.py``, ``kernels/flash_decode.py``,
``megakernel/kernels.py``) and the quantized A operand of the collective
matmuls (``kernels/allgather_gemm.py``, ``gemm_reduce_scatter.py``,
``gemm_allreduce.py``) agree on byte for byte with the JAX package.

Format (per row, the last axis): ``x ≈ q · scale``, ``q`` int8 or
float8_e4m3fn, ``scale`` one f32 power of two from the row's absmax::

    absmax = m · 2^e   (frexp: m in [0.5, 1))
    scale  = 2^(e - 1 - SHIFT)      SHIFT = 6 (int8) | 7 (fp8)

so ``|x| / scale`` lies in the format's top octave, clipped to 127 (int8)
or 240 (e4m3) before the cast; int8 rounds half to even, the e4m3 cast
rounds to nearest even. An all-zero row gets scale 1.0. Dequantization
``q · scale`` is exact in f32, and in bf16 too (at most 8 significant bits
times a power of two), so requantizing a dequantized row gives the same
bytes back.

One layout differs from JAX's: ``QuantTensor`` keeps its scales as
``(rows, 1)`` f32. JAX replicates them over 128 lanes only because Mosaic
cannot slice a ``(rows, 1)`` buffer; ``models/weights.py``
(``quant_tensor_from_numpy``) takes JAX's column 0.

Knobs: ``TDT_QUANT_KV`` and ``TDT_QUANT_WIRE`` ("" | "int8" | "fp8").
"""

from __future__ import annotations

import dataclasses
import os

import torch

WIRES = ("int8", "fp8")
WIRE_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}

# |x| / scale lands in [2^SHIFT, 2^(SHIFT + 1)): the top octave of the format.
_SHIFT = {"int8": 6, "fp8": 7}
# Magnitude clip before the cast: int8 would round [127.5, 128) up to 128;
# e4m3 would round (248, 256) up to 256 and leave the octave.
_CLIP = {"int8": 127.0, "fp8": 240.0}

#: Absolute round-trip error bound, relative to the row's absmax.
ERROR_BOUND = {"int8": 2.0 ** -7, "fp8": 2.0 ** -4}

#: f32 per-row scale.
SCALE_BYTES = 4


def wire_dtype(wire: str) -> torch.dtype:
    """The element dtype of ``wire`` (validates the name)."""
    if wire not in WIRE_DTYPES:
        raise ValueError(f"unknown quant wire {wire!r}; expected one of {WIRES}")
    return WIRE_DTYPES[wire]


def wire_itemsize(wire: str) -> int:
    return torch.empty((), dtype=wire_dtype(wire)).element_size()


def kv_quant_from_env() -> str | None:
    """Resolve ``TDT_QUANT_KV`` ("" → None)."""
    return _env_wire("TDT_QUANT_KV")


def wire_quant_from_env() -> str | None:
    """Resolve ``TDT_QUANT_WIRE`` ("" → None)."""
    return _env_wire("TDT_QUANT_WIRE")


def _env_wire(name: str) -> str | None:
    w = os.environ.get(name, "").strip().lower()
    if not w or w in ("0", "none", "off"):
        return None
    if w not in WIRES:
        raise ValueError(f"{name}={w!r}: expected one of {WIRES} (or empty)")
    return w


def _pow2_scale(absmax: torch.Tensor, shift: int) -> torch.Tensor:
    """absmax = m·2^e (m in [0.5, 1)) → 2^(e - 1 - shift); zero rows 1.0."""
    _, e = torch.frexp(absmax)
    one = torch.ones_like(absmax)
    return torch.where(absmax > 0, torch.ldexp(one, e - 1 - shift), one)


def quantize_rows(x: torch.Tensor, wire: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``x`` along its last axis: ``(q, scale)``, ``q`` of x's
    shape in the wire dtype, ``scale`` ``x.shape[:-1] + (1,)`` f32."""
    dt = wire_dtype(wire)
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = _pow2_scale(absmax, _SHIFT[wire])
    y = torch.clamp(xf / scale, -_CLIP[wire], _CLIP[wire])
    q = torch.round(y).to(dt) if wire == "int8" else y.to(dt)
    return q, scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q · scale`` in f32, cast to ``dtype`` (exact in f32 and bf16)."""
    return (q.float() * scale[..., :1]).to(dtype)


@dataclasses.dataclass(frozen=True)
class QuantTensor:
    """A quantized 2-D operand: ``q`` (rows, cols) in the wire dtype and
    ``scale`` (rows, 1) f32, one scale a row. Rows are the panels that ride
    the all-gather and that a tile dequantizes."""

    q: torch.Tensor
    scale: torch.Tensor
    wire: str

    @property
    def shape(self):
        return self.q.shape

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def nbytes_wire(self) -> int:
        """Bytes a panel of these rows moves: payload plus scales."""
        return self.q.numel() * wire_itemsize(self.wire) + self.scale.numel() * SCALE_BYTES


def quantize_tensor(x: torch.Tensor, wire: str) -> QuantTensor:
    if x.dim() != 2:
        raise ValueError(f"quantize_tensor takes a 2-D tensor, got {tuple(x.shape)}")
    q, s = quantize_rows(x, wire)
    return QuantTensor(q=q, scale=s, wire=wire)


def dequantize_tensor(t: QuantTensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return dequantize_rows(t.q, t.scale, dtype)


@dataclasses.dataclass(frozen=True)
class QuantPool:
    """A quantized KV pool half: payload ``q`` (..., bs, D) in the wire
    dtype and the parallel scale pool ``scale`` (..., bs, 1) f32, one scale
    a stored row, written once at append. Indexing the leading axis (a
    layer) gives the pair of views, so a step can pass ``pool[li]`` where it
    passes an unquantized pool."""

    q: torch.Tensor
    scale: torch.Tensor
    wire: str

    @property
    def shape(self):
        return self.q.shape

    def __getitem__(self, i) -> "QuantPool":
        return QuantPool(self.q[i], self.scale[i], self.wire)


def quantize_kv_rows(x: torch.Tensor, wire: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize new KV rows (..., D) → ``(q, scale)``, scale (..., 1) f32:
    the pair a paged write puts into the payload and scale pools."""
    return quantize_rows(x, wire)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dequantize gathered KV payload (..., D) with its (..., 1) scales."""
    return dequantize_rows(q, scale, dtype)

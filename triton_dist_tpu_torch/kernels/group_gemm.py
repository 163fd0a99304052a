"""Grouped (per-expert) GEMMs over capacity-padded expert buffers.

Counterpart of ``triton_dist_tpu/kernels/group_gemm.py``:

* ``group_gemm``: one batched product per expert, accumulated in fp32 and
  cast to the input dtype. In JAX it is a plain ``dot_general`` that XLA
  runs; here it is ``torch.bmm``.
* ``group_gemm_swiglu``: the fused gate/up products with the SwiGLU
  epilogue, which JAX runs as the Pallas kernel ``_group_swiglu_kernel``.
  On a CUDA tensor it launches the hand-written kernel in
  ``csrc/group_gemm.cu`` (its header says what bounds it on the H100 and
  how its design answers that); on a CPU tensor it runs
  ``group_swiglu_reference``, the plain PyTorch version, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.kernels import _build

_SIGNATURES = {
    "tdt_group_swiglu": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}


def _dot_f32(op, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``op(x, w)`` accumulated and returned in fp32 (JAX's
    ``preferred_element_type=float32``): fp32 inputs as they are, CUDA
    bf16 through ``out_dtype``, CPU bf16 upcast first."""
    if x.dtype == torch.float32:
        return op(x, w)
    if x.is_cuda:
        return op(x, w, out_dtype=torch.float32)
    return op(x.float(), w.float())


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """2-D ``x @ w`` in fp32 (``jnp.dot(..., preferred_element_type=f32)``)."""
    return _dot_f32(torch.mm, x, w)


def bmm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched ``x @ w`` in fp32 (``dot_general(..., preferred_element_type=f32)``)."""
    return _dot_f32(torch.bmm, x, w)


def group_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-expert GEMM: x (E, C, d_in) @ w (E, d_in, d_out) → (E, C, d_out)
    in x's dtype, accumulated in fp32."""
    return bmm_f32(x, w).to(x.dtype)


def group_swiglu_reference(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor) -> torch.Tensor:
    """Plain version of ``group_gemm_swiglu``: ``silu(x @ wg) * (x @ wu)``
    per expert, both products and the SwiGLU in fp32, cast once."""
    g = bmm_f32(x, w_gate)
    u = bmm_f32(x, w_up)
    return (torch.nn.functional.silu(g) * u).to(x.dtype)


def group_gemm_swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor) -> torch.Tensor:
    """Fused per-expert gate/up GEMM + SwiGLU: x (E, C, d), w_gate and w_up
    (E, d, f) → (E, C, f) in x's dtype. CUDA tensors (fp32 or bf16,
    contiguous; bf16 needs d and f multiples of 8) launch the kernel; CPU
    tensors run ``group_swiglu_reference``."""
    if x.dim() != 3 or w_gate.dim() != 3 or w_gate.shape != w_up.shape:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, w_gate {tuple(w_gate.shape)}, "
                         f"w_up {tuple(w_up.shape)}")
    e, c, d = x.shape
    f = w_gate.shape[2]
    if w_gate.shape[:2] != (e, d):
        raise ValueError(f"weights {tuple(w_gate.shape)} do not fit x {tuple(x.shape)}")
    if not (x.device == w_gate.device == w_up.device):
        raise ValueError("x and the weights must be on one device")
    if not (x.dtype == w_gate.dtype == w_up.dtype):
        raise ValueError("x and the weights must share a dtype")
    if x.device.type == "cpu":
        return group_swiglu_reference(x, w_gate, w_up)
    if x.device.type != "cuda":
        raise ValueError(f"group_gemm_swiglu runs on CUDA or CPU tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"group_gemm_swiglu takes fp32 or bf16, got {x.dtype}")
    if not all(t.is_contiguous() for t in (x, w_gate, w_up)):
        raise ValueError("group_gemm_swiglu needs contiguous x and weights")
    if x.dtype == torch.bfloat16 and (d % 8 or f % 8):
        raise ValueError(f"bf16 group_gemm_swiglu needs d and f multiples of 8, got d={d}, f={f}")
    out = torch.empty((e, c, f), device=x.device, dtype=x.dtype)
    lib = _build.load("group_gemm", _SIGNATURES)
    with torch.cuda.device(x.device):
        code = lib.tdt_group_swiglu(
            _build.ptr(x), _build.ptr(w_gate), _build.ptr(w_up), _build.ptr(out), e, c, d, f,
            1 if x.dtype == torch.bfloat16 else 0, _build.stream_ptr(x.device),
        )
    _build.check(lib, code, "group_gemm_swiglu")
    group_gemm_swiglu.launches += 1
    return out


#: Kernel launches so far (CUDA calls only; the CPU path launches nothing).
group_gemm_swiglu.launches = 0


def swiglu_bytes(x: torch.Tensor, w_gate: torch.Tensor) -> int:
    """Bytes the function must move: x, w_gate and w_up read once, out
    written once."""
    e, c, d = x.shape
    f = w_gate.shape[2]
    return x.element_size() * (e * c * d + 2 * e * d * f + e * c * f)


def swiglu_flops(x: torch.Tensor, w_gate: torch.Tensor) -> int:
    """FLOPs of the two products (2·C·d·f each per expert); the epilogue's
    few operations per output are not counted."""
    e, c, d = x.shape
    return 4 * e * c * d * w_gate.shape[2]

"""The mega backend's routed-experts kernel.

Counterpart of ``fused_moe_block`` in ``triton_dist_tpu/megakernel/kernels.py``
(the Pallas kernel ``_moe_block_kernel``): per expert, gate/up products →
SwiGLU → down product over the capacity-padded token panels of the MoE
dispatch, fp32 out. On a CUDA tensor the wrapper launches the hand-written
kernel in ``csrc/mega_moe_block.cu`` on the current stream (its header says
what bounds it on the H100 and how its design answers that); on a CPU
tensor it runs ``moe_block_reference``, the plain PyTorch version, and
nothing else. ``megakernel/kernels.py`` exports it under the JAX name.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.mega_decode import TILE_N

_SIGNATURES = {"tdt_moe_block": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]}


def moe_block_reference(xe: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                        w_down: torch.Tensor) -> torch.Tensor:
    """Plain ``fused_moe_block``: fp32 products of the operands upcast to
    fp32 (so on a card the result does not depend on the library's
    reduced-precision bf16 reductions), h = silu(g)·u rounded to xe's dtype
    before the down product, fp32 (E, C, d) out."""
    x = xe.float()
    g, u = torch.bmm(x, w_gate.float()), torch.bmm(x, w_up.float())
    h = (torch.nn.functional.silu(g) * u).to(xe.dtype)
    return torch.bmm(h.float(), w_down.float())


def fused_moe_block(
    xe: torch.Tensor,  # (E, C, d) capacity-padded dispatched token panels
    w_gate: torch.Tensor,  # (E, d, ff)
    w_up: torch.Tensor,  # (E, d, ff)
    w_down: torch.Tensor,  # (E, ff, d)
) -> torch.Tensor:
    """Routed-experts panel compute: ``silu(xe @ w_gate) * (xe @ w_up)``
    rounded to xe's dtype, then ``@ w_down``; returns the fp32 (E, C, d)
    down-product partials (the caller combines them in fp32). CUDA tensors
    (fp32 or bf16, contiguous, d and ff multiples of 8) launch the kernel;
    CPU tensors run ``moe_block_reference``."""
    if xe.dim() != 3 or w_gate.dim() != 3:
        raise ValueError(f"fused_moe_block: bad shapes xe {tuple(xe.shape)}, w_gate {tuple(w_gate.shape)}")
    e, c, d = xe.shape
    ff = w_gate.shape[2]
    if w_gate.shape != (e, d, ff) or w_up.shape != (e, d, ff) or w_down.shape != (e, ff, d):
        raise ValueError(f"fused_moe_block: bad shapes xe {tuple(xe.shape)}, w_gate {tuple(w_gate.shape)}, "
                         f"w_up {tuple(w_up.shape)}, w_down {tuple(w_down.shape)}")
    ops = dict(xe=xe, w_gate=w_gate, w_up=w_up, w_down=w_down)
    if any(t.device != xe.device for t in ops.values()):
        raise ValueError("fused_moe_block: all operands must be on one device")
    if any(t.dtype != xe.dtype for t in ops.values()):
        raise ValueError("fused_moe_block: xe and the weights must share a dtype")
    if xe.device.type == "cpu":
        return moe_block_reference(xe, w_gate, w_up, w_down)
    if xe.device.type != "cuda":
        raise ValueError(f"fused_moe_block runs on CUDA or CPU tensors, got {xe.device}")
    if xe.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_moe_block takes fp32 or bf16, got {xe.dtype}")
    for name, t in ops.items():
        if not t.is_contiguous():
            raise ValueError(f"fused_moe_block needs contiguous operands ({name} is not)")
    if d % 8 or ff % 8 or e > 65535 or c < 1:
        raise ValueError(f"fused_moe_block needs d and ff multiples of 8, 1 <= E <= 65535 and C >= 1, "
                         f"got d {d}, ff {ff}, E {e}, C {c}")
    y = torch.empty((e, c, d), device=xe.device, dtype=torch.float32)
    part = torch.empty((-(-ff // TILE_N), e, c, d), device=xe.device, dtype=torch.float32)
    lib = _build.load("mega_moe_block", _SIGNATURES)
    with torch.cuda.device(xe.device):
        code = lib.tdt_moe_block(
            _build.ptr(xe), _build.ptr(w_gate), _build.ptr(w_up), _build.ptr(w_down), _build.ptr(y),
            _build.ptr(part), e, c, d, ff, 1 if xe.dtype == torch.bfloat16 else 0,
            _build.stream_ptr(xe.device),
        )
    _build.check(lib, code, "fused_moe_block")
    fused_moe_block.launches += 1
    return y


#: Kernel launches so far (CUDA calls only; a call counts once, whatever
#: passes of its source it launches).
fused_moe_block.launches = 0


def moe_block_cost(xe: torch.Tensor, w_gate: torch.Tensor) -> tuple[int, int]:
    """(FLOPs, bytes) that this input needs: the panels read once, the fp32
    output written once, and the three weights of the live experts only (an
    expert whose panel is all zero rows gives y = 0 without its weights);
    6·d·ff FLOPs for each nonzero token row."""
    e, c, d = xe.shape
    ff = w_gate.shape[2]
    el = xe.element_size()
    live_rows = xe.ne(0).any(2)
    live, rows = int(live_rows.any(1).sum()), int(live_rows.sum())
    return 6 * rows * d * ff, el * (e * c * d + 3 * live * d * ff) + 4 * e * c * d

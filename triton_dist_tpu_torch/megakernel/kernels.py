"""Fused per-block decode kernels of the mega backend.

Counterpart of ``triton_dist_tpu/megakernel/kernels.py``, under the same
names. The four kernels of the dense contiguous step are ported: their
wrappers, plain versions and CUDA sources sit with the port's other kernels
(``kernels/mega_decode.py``, ``csrc/mega_*.cu``) and are exported here.
The MoE block (``fused_moe_block``) and the paged back-leg
(``fused_paged_attn_back``) are the next slice of the port and raise.
"""

from __future__ import annotations

from triton_dist_tpu_torch.kernels.mega_decode import (  # noqa: F401
    fused_attn_back,
    fused_ln_qkv_rope,
    fused_mlp_block,
    fused_norm_head,
)

#: What the next slice of the mega port brings (ROADMAP queue 1 item M).
NEXT_SLICE = (
    "the mega backend's MoE block (table row 13, fused_moe_block) and its paged "
    "step (row 3, paged_flash_decode with fused_paged_attn_back) are the next "
    "slice of the port (ROADMAP queue 1 item M)"
)


def fused_moe_block(*args, **kwargs):
    """Routed-experts panel compute (``_moe_block_kernel``): not ported yet."""
    raise NotImplementedError(NEXT_SLICE)


def fused_paged_attn_back(*args, **kwargs):
    """Paged attention back-leg (``paged_flash_decode``): not ported yet."""
    raise NotImplementedError(NEXT_SLICE)

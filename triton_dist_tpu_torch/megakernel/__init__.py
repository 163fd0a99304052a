"""The mega decode backend: a decode step recorded as a task graph and
lowered to fused per-block kernels.

Counterpart of ``triton_dist_tpu/megakernel/``. ``ModelBuilder``
(``builder.py``) records every layer's ops as ``Task``s of one
``TaskGraph`` (``graph.py``), the scheduler groups them into the known
fusable chains, and each group lowers to one fused kernel wrapper
(``kernels.py``): ``fused_ln_qkv_rope`` (attention front),
``fused_attn_back`` (the sweep with its o-projection; paged:
``fused_paged_attn_back``, the pool write, the block-table walk and the
o-projection), ``fused_mlp_block`` and, for a MoE model, the routed
experts ``fused_moe_block`` between routing and combine; the model's head
is ``fused_norm_head``. On the card each kernel is hand-written CUDA.
"""

from triton_dist_tpu_torch.megakernel.builder import ModelBuilder
from triton_dist_tpu_torch.megakernel.graph import Task, TaskGraph
from triton_dist_tpu_torch.megakernel.kernels import (
    fused_attn_back,
    fused_ln_qkv_rope,
    fused_mlp_block,
    fused_moe_block,
    fused_norm_head,
    fused_paged_attn_back,
)

__all__ = [
    "ModelBuilder",
    "Task",
    "TaskGraph",
    "fused_attn_back",
    "fused_ln_qkv_rope",
    "fused_mlp_block",
    "fused_moe_block",
    "fused_norm_head",
    "fused_paged_attn_back",
]

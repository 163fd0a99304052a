"""Training autograd functions over the port's kernels: counterpart of
``triton_dist_tpu/function`` (the reference's L9 layer).

Each ``torch.autograd.Function``'s backward runs the kernel or collective
that JAX's ``custom_vjp`` picks: the dual collective matmul (AG-GEMM's input
gradient is a GEMM-RS and the other way round), the all-to-all for itself,
and the flash-attention backward kernels (rows 5 and 6) for the attention
functions. ``function.collectives`` states what gradient each rank gets.
"""

from triton_dist_tpu_torch.function.collectives import (
    ag_attention_fn,
    ag_gemm_fn,
    all_to_all_single_fn,
    flash_attention_fn,
    flash_attention_lse_fn,
    flash_attention_varlen_fn,
    flash_attention_varlen_lse_fn,
    gemm_ar_fn,
    gemm_rs_fn,
    group_gemm_swiglu_fn,
    ppermute_fn,
    ring_attention_2d_fn,
    ring_attention_2d_varlen_fn,
    ring_attention_fn,
    ring_attention_varlen_fn,
)
from triton_dist_tpu_torch.function.ep_moe import ep_moe_fused_fn

__all__ = [
    "ag_attention_fn",
    "ag_gemm_fn",
    "flash_attention_fn",
    "flash_attention_varlen_fn",
    "flash_attention_varlen_lse_fn",
    "flash_attention_lse_fn",
    "ring_attention_fn",
    "ring_attention_2d_fn",
    "ring_attention_2d_varlen_fn",
    "ring_attention_varlen_fn",
    "gemm_rs_fn",
    "gemm_ar_fn",
    "all_to_all_single_fn",
    "group_gemm_swiglu_fn",
    "ep_moe_fused_fn",
    "ppermute_fn",
]

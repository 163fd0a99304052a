"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. Every wrapper counts its launches in ``<wrapper>.launches`` (a
backward wrapper one per kernel it starts: two a call)."""

from triton_dist_tpu_torch.kernels.ag_attention import ag_attention_reference, ag_attn_kernel
from triton_dist_tpu_torch.kernels.allgather import all_gather_reference, full_mesh_ag_call, ring_ag_call
from triton_dist_tpu_torch.kernels.allgather_gemm import (
    ag_gemm_fused,
    ag_gemm_fused_quant,
    ag_gemm_quant_reference,
    ag_gemm_reference,
)
from triton_dist_tpu_torch.kernels.allreduce import one_shot_ar_call, one_shot_ar_reference
from triton_dist_tpu_torch.kernels.common_ops import barrier_all_on_device
from triton_dist_tpu_torch.kernels.ep_a2a import all_to_all_kernel
from triton_dist_tpu_torch.kernels.ep_fused import fused_ep_kernel, fused_ep_reference
from triton_dist_tpu_torch.kernels.flash_attn import (
    attention_bwd_reference,
    attention_reference,
    flash_attention,
    flash_attention_bwd,
    flash_attention_varlen,
    flash_attention_varlen_bwd,
    varlen_bwd_reference,
    varlen_reference,
)
from triton_dist_tpu_torch.kernels.flash_decode import (
    decode_reference,
    flash_decode,
    paged_decode_quant_reference,
    paged_decode_reference,
    paged_flash_decode,
    paged_flash_decode_quant,
)
from triton_dist_tpu_torch.kernels.gemm_allreduce import (
    gemm_ar_fused,
    gemm_ar_fused_quant,
    gemm_ar_ll,
    gemm_ar_ll_quant,
    gemm_ar_quant_reference,
    gemm_ar_reference,
)
from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import (
    gemm_rs_fused,
    gemm_rs_fused_quant,
    gemm_rs_quant_reference,
    gemm_rs_reference,
)
from triton_dist_tpu_torch.kernels.group_gemm import group_gemm_swiglu, group_swiglu_reference
from triton_dist_tpu_torch.kernels.mega_decode import (
    attn_back_reference,
    fused_attn_back,
    fused_ln_qkv_rope,
    fused_mlp_block,
    fused_norm_head,
    ln_qkv_rope_reference,
    mlp_block_reference,
    norm_head_reference,
)
from triton_dist_tpu_torch.kernels.mega_moe import fused_moe_block, moe_block_reference
from triton_dist_tpu_torch.kernels.p2p import p2p_kernel, p2p_reference
from triton_dist_tpu_torch.kernels.reduce_scatter import ring_rs_call, ring_rs_reference

#: The kernel wrappers of the served paths, by name.
KERNELS = {
    "flash_attention": flash_attention,
    "flash_attention_varlen": flash_attention_varlen,
    "flash_attention_bwd": flash_attention_bwd,
    "flash_attention_varlen_bwd": flash_attention_varlen_bwd,
    "flash_decode": flash_decode,
    "paged_flash_decode": paged_flash_decode,
    "paged_flash_decode_quant": paged_flash_decode_quant,
    "group_gemm_swiglu": group_gemm_swiglu,
    "fused_ln_qkv_rope": fused_ln_qkv_rope,
    "fused_attn_back": fused_attn_back,
    "fused_mlp_block": fused_mlp_block,
    "fused_norm_head": fused_norm_head,
    "fused_moe_block": fused_moe_block,
    "ag_gemm_fused": ag_gemm_fused,
    "gemm_rs_fused": gemm_rs_fused,
    "gemm_ar_fused": gemm_ar_fused,
    "gemm_ar_ll": gemm_ar_ll,
    "ag_gemm_fused_quant": ag_gemm_fused_quant,
    "gemm_rs_fused_quant": gemm_rs_fused_quant,
    "gemm_ar_fused_quant": gemm_ar_fused_quant,
    "gemm_ar_ll_quant": gemm_ar_ll_quant,
    "barrier_all_on_device": barrier_all_on_device,
    "all_to_all_kernel": all_to_all_kernel,
    "fused_ep_kernel": fused_ep_kernel,
    "ring_ag_call": ring_ag_call,
    "full_mesh_ag_call": full_mesh_ag_call,
    "ring_rs_call": ring_rs_call,
    "one_shot_ar_call": one_shot_ar_call,
    "ag_attn_kernel": ag_attn_kernel,
    "p2p_kernel": p2p_kernel,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = [
    "KERNELS",
    "ag_attention_reference",
    "ag_attn_kernel",
    "ag_gemm_fused",
    "ag_gemm_fused_quant",
    "ag_gemm_quant_reference",
    "ag_gemm_reference",
    "all_gather_reference",
    "full_mesh_ag_call",
    "one_shot_ar_call",
    "one_shot_ar_reference",
    "ring_ag_call",
    "ring_rs_call",
    "ring_rs_reference",
    "all_to_all_kernel",
    "barrier_all_on_device",
    "fused_ep_kernel",
    "fused_ep_reference",
    "gemm_ar_fused",
    "gemm_ar_fused_quant",
    "gemm_ar_ll",
    "gemm_ar_ll_quant",
    "gemm_ar_quant_reference",
    "gemm_ar_reference",
    "gemm_rs_fused",
    "gemm_rs_fused_quant",
    "gemm_rs_quant_reference",
    "gemm_rs_reference",
    "attention_bwd_reference",
    "attention_reference",
    "attn_back_reference",
    "decode_reference",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_varlen",
    "flash_attention_varlen_bwd",
    "flash_decode",
    "fused_attn_back",
    "fused_ln_qkv_rope",
    "fused_mlp_block",
    "fused_moe_block",
    "fused_norm_head",
    "group_gemm_swiglu",
    "group_swiglu_reference",
    "ln_qkv_rope_reference",
    "mlp_block_reference",
    "moe_block_reference",
    "norm_head_reference",
    "p2p_kernel",
    "p2p_reference",
    "paged_decode_quant_reference",
    "paged_decode_reference",
    "paged_flash_decode",
    "paged_flash_decode_quant",
    "varlen_bwd_reference",
    "varlen_reference",
    "launch_counts",
    "reset_launch_counts",
]

"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. Every wrapper counts its launches in ``<wrapper>.launches``."""

from triton_dist_tpu_torch.kernels.flash_attn import attention_reference, flash_attention
from triton_dist_tpu_torch.kernels.flash_decode import (
    decode_reference,
    flash_decode,
    paged_decode_reference,
    paged_flash_decode,
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

#: The kernel wrappers of the served paths, by name.
KERNELS = {
    "flash_attention": flash_attention,
    "flash_decode": flash_decode,
    "paged_flash_decode": paged_flash_decode,
    "group_gemm_swiglu": group_gemm_swiglu,
    "fused_ln_qkv_rope": fused_ln_qkv_rope,
    "fused_attn_back": fused_attn_back,
    "fused_mlp_block": fused_mlp_block,
    "fused_norm_head": fused_norm_head,
    "fused_moe_block": fused_moe_block,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = [
    "KERNELS",
    "attention_reference",
    "attn_back_reference",
    "decode_reference",
    "flash_attention",
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
    "paged_decode_reference",
    "paged_flash_decode",
    "launch_counts",
    "reset_launch_counts",
]

"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. Every wrapper counts its launches in ``<wrapper>.launches``."""

from triton_dist_tpu_torch.kernels.flash_attn import attention_reference, flash_attention
from triton_dist_tpu_torch.kernels.flash_decode import decode_reference, flash_decode
from triton_dist_tpu_torch.kernels.group_gemm import group_gemm_swiglu, group_swiglu_reference

#: The kernel wrappers of the served paths, by name.
KERNELS = {
    "flash_attention": flash_attention,
    "flash_decode": flash_decode,
    "group_gemm_swiglu": group_gemm_swiglu,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = [
    "KERNELS",
    "attention_reference",
    "decode_reference",
    "flash_attention",
    "flash_decode",
    "group_gemm_swiglu",
    "group_swiglu_reference",
    "launch_counts",
    "reset_launch_counts",
]

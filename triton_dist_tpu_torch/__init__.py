"""triton_dist_tpu_torch: the PyTorch/CUDA port of ``triton_dist_tpu``.

The JAX package beside it is the reference. This package imports ``torch``
and never ``jax``, and nothing of ``triton_dist_tpu``: it keeps its own
copies of what it needs. Module names mirror the JAX package's, so each
counterpart is found under the same path.

It serves the Qwen3-class models: ``models.Engine`` over
``models.DenseLLM`` or ``models.Qwen3MoE``, with
hand-written CUDA kernels for flash attention (prefill), flash decode (over
a padded cache or a paged block pool) and the MoE layers' grouped gate/up
GEMM with its SwiGLU. ``Engine(backend="mega")`` decodes through
``megakernel``: every step is one recorded task graph lowered to fused
decode kernels (the routed experts among them), over the slot cache or
directly over a paged KV pool (``models.PagedKVCache``). The dense model
also runs tensor-parallel over ranks that are processes (``runtime.mesh``),
over a symmetric heap mapped with CUDA IPC (``shmem.symm``), through the
hand-written collective matmuls (AG-GEMM, GEMM-RS, GEMM-AR and its
low-latency twin); ``models.EPMoELLM`` serves a MoE model expert-parallel
over those ranks, through the hand-written one-sided all-to-all and the
fused dispatch → expert MLP → combine kernel.
"""

from triton_dist_tpu_torch.runtime.platform import resolve_device  # noqa: F401

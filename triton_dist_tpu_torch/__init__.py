"""triton_dist_tpu_torch: the PyTorch/CUDA port of ``triton_dist_tpu``.

The JAX package beside it is the reference. This package imports ``torch``
and never ``jax``, and nothing of ``triton_dist_tpu``: it keeps its own
copies of what it needs. Module names mirror the JAX package's, so each
counterpart is found under the same path.

It serves the Qwen3-class models at tensor-parallel world 1:
``models.Engine`` over ``models.DenseLLM`` or ``models.Qwen3MoE``, with
hand-written CUDA kernels for flash attention (prefill), flash decode and
the MoE layers' grouped gate/up GEMM with its SwiGLU.
"""

from triton_dist_tpu_torch.runtime.platform import resolve_device  # noqa: F401

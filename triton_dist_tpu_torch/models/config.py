"""Model configuration: a copy of ``triton_dist_tpu/models/config.py``.

Copied, not imported: importing any ``triton_dist_tpu`` module runs that
package's ``__init__``, which imports JAX.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 1024
    hidden_size: int = 256
    intermediate_size: int = 512
    num_layers: int = 2
    num_q_heads: int = 8
    num_kv_heads: int = 4
    head_dim: int = 64
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_word_embeddings: bool = False
    # MoE (None → dense MLP)
    num_experts: int | None = None
    top_k: int = 8
    moe_intermediate_size: int | None = None
    norm_topk_prob: bool = True

    @property
    def is_moe(self) -> bool:
        return self.num_experts is not None


PRESETS: dict[str, ModelConfig] = {
    # Qwen3-8B/32B-style dense shapes (reference e2e targets, e2e_dense.md)
    "qwen3-8b": ModelConfig(
        vocab_size=151936, hidden_size=4096, intermediate_size=12288,
        num_layers=36, num_q_heads=32, num_kv_heads=8, head_dim=128,
    ),
    "qwen3-32b": ModelConfig(
        vocab_size=151936, hidden_size=5120, intermediate_size=25600,
        num_layers=64, num_q_heads=64, num_kv_heads=8, head_dim=128,
    ),
    # Qwen3-30B-A3B-style MoE (reference qwen_moe.py target family)
    "qwen3-moe-30b-a3b": ModelConfig(
        vocab_size=151936, hidden_size=2048, intermediate_size=6144,
        num_layers=48, num_q_heads=32, num_kv_heads=4, head_dim=128,
        num_experts=128, top_k=8, moe_intermediate_size=768,
    ),
    # Tiny configs for tests / CPU sim
    "test-dense": ModelConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=2, num_q_heads=8, num_kv_heads=4, head_dim=32, dtype="float32",
    ),
    "test-moe": ModelConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_layers=2, num_q_heads=8, num_kv_heads=4, head_dim=32, dtype="float32",
        num_experts=8, top_k=2, moe_intermediate_size=48,
    ),
}


def torch_dtype(config: ModelConfig):
    """The ``torch.dtype`` named by ``config.dtype``."""
    import torch

    return getattr(torch, config.dtype)

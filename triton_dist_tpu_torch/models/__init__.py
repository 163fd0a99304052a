from triton_dist_tpu_torch.models.config import PRESETS, ModelConfig
from triton_dist_tpu_torch.models.dense import DenseLLM, DenseParams, Qwen3MoE, init_params
from triton_dist_tpu_torch.models.engine import Engine, sample_token
from triton_dist_tpu_torch.models.kv_cache import KVCache, PagedKVCache
from triton_dist_tpu_torch.models.weights import params_from_numpy

__all__ = [
    "PRESETS",
    "DenseLLM",
    "DenseParams",
    "Engine",
    "KVCache",
    "ModelConfig",
    "PagedKVCache",
    "Qwen3MoE",
    "init_params",
    "params_from_numpy",
    "sample_token",
]

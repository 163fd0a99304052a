from triton_dist_tpu_torch.models.config import PRESETS, ModelConfig
from triton_dist_tpu_torch.models.dense import DenseLLM, DenseParams, Qwen3MoE, init_params
from triton_dist_tpu_torch.models.engine import Engine, sample_token
from triton_dist_tpu_torch.models.kv_cache import KVCache, PagedKVCache
from triton_dist_tpu_torch.models.moe import EPMoELLM
from triton_dist_tpu_torch.models.quant import QuantPool, QuantTensor, quantize_tensor
from triton_dist_tpu_torch.models.weights import params_from_numpy, quant_pool_from_numpy, quant_tensor_from_numpy

__all__ = [
    "PRESETS",
    "DenseLLM",
    "DenseParams",
    "EPMoELLM",
    "Engine",
    "KVCache",
    "ModelConfig",
    "PagedKVCache",
    "QuantPool",
    "QuantTensor",
    "Qwen3MoE",
    "init_params",
    "params_from_numpy",
    "quant_pool_from_numpy",
    "quant_tensor_from_numpy",
    "quantize_tensor",
    "sample_token",
]

"""Weight bridge: the JAX package's ``DenseParams`` into the port's.

``params_from_numpy`` takes the JAX parameters field by field as numpy
arrays (``{name: np.asarray(getattr(jax_params, name))}``) and returns the
port's ``DenseParams`` on ``device``, so both packages compute the same
model. At world 1 nothing is sharded, so every array is taken whole.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from triton_dist_tpu_torch.models.config import ModelConfig, torch_dtype
from triton_dist_tpu_torch.models.dense import DenseParams
from triton_dist_tpu_torch.runtime.platform import resolve_device


def _to_tensor(a: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: torch shares the buffer
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def params_from_numpy(arrays: dict[str, np.ndarray], config: ModelConfig,
                      device: str | torch.device | None = None) -> DenseParams:
    """The port's ``DenseParams`` from the JAX fields as numpy arrays, cast
    to ``config.dtype``. Raises on a missing field or a shape that does not
    fit ``config``."""
    c = config
    device = resolve_device(device)
    dt = torch_dtype(c)
    L, d, hd, ff, V = c.num_layers, c.hidden_size, c.head_dim, c.intermediate_size, c.vocab_size
    expect = {
        "embed": (V, d),
        "ln1": (L, d),
        "wqkv": (L, d, (c.num_q_heads + 2 * c.num_kv_heads) * hd),
        "wo": (L, c.num_q_heads * hd, d),
        "q_norm": (L, hd),
        "k_norm": (L, hd),
        "ln2": (L, d),
        "mlp_gate": (L, d, ff),
        "mlp_up": (L, d, ff),
        "mlp_down": (L, ff, d),
        "final_norm": (d,),
        "lm_head": (d, V),
    }
    out = {}
    for f in dataclasses.fields(DenseParams):
        if f.name == "router":
            if arrays.get("router") is not None:
                raise NotImplementedError("MoE weights are not ported yet")
            out["router"] = None
            continue
        if f.name not in arrays:
            raise KeyError(f"missing parameter {f.name!r}")
        a = np.asarray(arrays[f.name])
        if a.shape != expect[f.name]:
            raise ValueError(f"{f.name}: shape {a.shape}, expected {expect[f.name]}")
        out[f.name] = _to_tensor(a, dt, device)
    return DenseParams(**out)

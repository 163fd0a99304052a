"""Weight bridge: the JAX package's ``DenseParams`` into the port's.

``params_from_numpy`` takes the JAX parameters field by field as numpy
arrays (``{name: np.asarray(getattr(jax_params, name))}``) and returns the
port's ``DenseParams`` on ``device``, so both packages compute the same
model, dense or MoE (router and 4-D expert slabs). The arrays are the
global ones; at world > 1 each rank takes its shard as JAX's ``_specs``
places it (``dense.py:51-68``; ``models.dense.shard``): ``wqkv``,
``mlp_gate``, ``mlp_up`` and ``lm_head`` by contiguous column blocks,
``wo`` and ``mlp_down`` by row blocks, the rest whole; with
``expert_parallel`` the expert slabs by whole experts instead. Given a
context (``ctx``), the shard is that of its tensor-parallel axis: on a
``pp`` × ``tp`` mesh every stage holds its ``tp`` shard of every layer, as
JAX's ``p_specs`` replicate the parameters over ``pp``.

``quant_pool_from_numpy`` and ``quant_tensor_from_numpy`` carry the JAX
package's quantized state (``models/quant.py``: a ``QuantPool`` half or a
paged pool's payload and scale pools; a ``QuantTensor``, whose scales JAX
replicates over 128 lanes, of which column 0 is taken) into the port's
types, byte for byte.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from triton_dist_tpu_torch.models.config import ModelConfig, torch_dtype
from triton_dist_tpu_torch.models.dense import DenseParams, shard, tp_pp_contexts
from triton_dist_tpu_torch.models.quant import QuantPool, QuantTensor, wire_dtype
from triton_dist_tpu_torch.runtime.platform import resolve_device


def _to_tensor(a: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: torch shares the buffer
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def params_from_numpy(arrays: dict[str, np.ndarray], config: ModelConfig,
                      device: str | torch.device | None = None, *, rank: int = 0,
                      world: int = 1, expert_parallel: bool = False, ctx=None) -> DenseParams:
    """The port's ``DenseParams`` of rank ``rank`` of ``world`` from the JAX
    fields as global numpy arrays, cast to ``config.dtype``. ``ctx``
    (``runtime.mesh.DistContext``) stands for ``rank``, ``world`` and a
    ``device`` of None: its tensor-parallel rank and world. With
    ``expert_parallel`` (a MoE config; JAX ``load_hf_weights(...,
    expert_parallel=True)``) each rank keeps whole experts of the expert
    slabs (``EP_SHARD_DIM``). Raises on a missing field, a shape that does
    not fit ``config`` or one that does not split over the ranks."""
    c = config
    if expert_parallel and not c.is_moe:
        raise ValueError("expert_parallel needs a MoE config")
    if ctx is not None:
        tp = tp_pp_contexts(ctx)[0]
        rank, world = (0, 1) if tp is None else (tp.rank, tp.world)
        device = ctx.device if device is None else device
    device = resolve_device(device)
    dt = torch_dtype(c)
    L, d, hd, V = c.num_layers, c.hidden_size, c.head_dim, c.vocab_size
    if c.is_moe:
        e, ffe = c.num_experts, c.moe_intermediate_size
        mlp = {"mlp_gate": (L, e, d, ffe), "mlp_up": (L, e, d, ffe), "mlp_down": (L, e, ffe, d),
               "router": (L, d, e)}
    else:
        ff = c.intermediate_size
        mlp = {"mlp_gate": (L, d, ff), "mlp_up": (L, d, ff), "mlp_down": (L, ff, d), "router": None}
    expect = {
        "embed": (V, d),
        "ln1": (L, d),
        "wqkv": (L, d, (c.num_q_heads + 2 * c.num_kv_heads) * hd),
        "wo": (L, c.num_q_heads * hd, d),
        "q_norm": (L, hd),
        "k_norm": (L, hd),
        "ln2": (L, d),
        **mlp,
        "final_norm": (d,),
        "lm_head": (d, V),
    }
    out = {}
    for f in dataclasses.fields(DenseParams):
        if expect[f.name] is None:  # the dense model has no router
            if arrays.get(f.name) is not None:
                raise ValueError(f"{f.name}: given for a dense config")
            out[f.name] = None
            continue
        if arrays.get(f.name) is None:
            raise KeyError(f"missing parameter {f.name!r}")
        a = np.asarray(arrays[f.name])
        if a.shape != expect[f.name]:
            raise ValueError(f"{f.name}: shape {a.shape}, expected {expect[f.name]}")
        out[f.name] = _to_tensor(shard(f.name, a, rank, world, expert_parallel), dt, device)
    return DenseParams(**out)


def _payload(a: np.ndarray, wire: str, device: torch.device) -> torch.Tensor:
    """A JAX int8 or float8_e4m3fn payload as the port's tensor, same bytes."""
    a = np.ascontiguousarray(a)
    if a.dtype.itemsize != 1:
        raise ValueError(f"a {wire} payload has 1-byte elements, got {a.dtype}")
    return torch.from_numpy(a.view(np.uint8).copy()).view(wire_dtype(wire)).to(device)


def quant_pool_from_numpy(q: np.ndarray, scale: np.ndarray, wire: str,
                          device: str | torch.device | None = None) -> QuantPool:
    """A quantized pool half (payload (..., bs, D) and scales (..., bs, 1)
    f32) from JAX's arrays as numpy."""
    device = resolve_device(device)
    scale = np.asarray(scale, np.float32)
    if scale.shape != np.shape(q)[:-1] + (1,):
        raise ValueError(f"scales {scale.shape} do not fit a payload {np.shape(q)}")
    return QuantPool(_payload(q, wire, device), torch.from_numpy(scale.copy()).to(device), wire)


def quant_tensor_from_numpy(q: np.ndarray, scale: np.ndarray, wire: str,
                            device: str | torch.device | None = None) -> QuantTensor:
    """A ``QuantTensor`` from JAX's payload (rows, cols) and its scales,
    lane-replicated (rows, 128) or (rows, 1): column 0 is the row's scale."""
    device = resolve_device(device)
    scale = np.asarray(scale, np.float32)
    if q.ndim != 2 or scale.ndim != 2 or scale.shape[0] != q.shape[0]:
        raise ValueError(f"a payload {q.shape} with scales {scale.shape}")
    return QuantTensor(_payload(q, wire, device), torch.from_numpy(np.ascontiguousarray(scale[:, :1])).to(device),
                       wire)

"""Qwen3-class LLM, dense or MoE, at tensor-parallel world 1.

Counterpart of ``triton_dist_tpu/models/dense.py`` (``DenseParams``,
``init_params``, ``DenseLLM.prefill_shard`` / ``prefill_chunk_shard`` /
``decode_shard``, ``Qwen3MoE``; the megakernel branches are not ported).
Parameters are stacked over layers as in JAX; a Python loop over layers
stands in for ``lax.scan``. The caches a step is given are updated in place.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from triton_dist_tpu_torch.kernels.group_gemm import matmul_f32
from triton_dist_tpu_torch.layers.tp import TP_Attn, TP_MLP, TP_MoE, RMSNorm
from triton_dist_tpu_torch.models.config import ModelConfig, torch_dtype
from triton_dist_tpu_torch.runtime.platform import resolve_device


@dataclasses.dataclass
class DenseParams:
    """Stacked-layer parameters, field for field the JAX ``DenseParams``."""

    embed: torch.Tensor  # (V, d)
    ln1: torch.Tensor  # (L, d)
    wqkv: torch.Tensor  # (L, d, (hq + 2·hkv)·hd)
    wo: torch.Tensor  # (L, hq·hd, d)
    q_norm: torch.Tensor  # (L, hd)
    k_norm: torch.Tensor  # (L, hd)
    ln2: torch.Tensor  # (L, d)
    mlp_gate: torch.Tensor  # dense (L, d, ff) | MoE (L, E, d, ff_e)
    mlp_up: torch.Tensor  # dense (L, d, ff) | MoE (L, E, d, ff_e)
    mlp_down: torch.Tensor  # dense (L, ff, d) | MoE (L, E, ff_e, d)
    router: torch.Tensor | None  # MoE (L, d, E); None for the dense model
    final_norm: torch.Tensor  # (d,)
    lm_head: torch.Tensor  # (d, V)


def init_params(config: ModelConfig, generator: torch.Generator,
                device: str | torch.device | None = None) -> DenseParams:
    """Random weights with the JAX package's scales (``dense.py:84-115``):
    the embedding and the MoE router at 0.02, every other matrix at
    1/sqrt(shape[-2]) (its fan-in), norms at ones. Normals are drawn on
    ``generator``'s device one layer at a time (so a full-size model never
    holds an fp32 copy of a whole stack), scaled in fp32 and cast to the
    model dtype."""
    c = config
    device = resolve_device(device)
    dt = torch_dtype(c)
    L, d, hd = c.num_layers, c.hidden_size, c.head_dim
    qkv_cols = (c.num_q_heads + 2 * c.num_kv_heads) * hd

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
        return (x * scale).to(device=device, dtype=dt)

    def stacked(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
        out = torch.empty((L, *shape), device=device, dtype=dt)
        for i in range(L):
            out[i] = normal(shape, scale)
        return out

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dt)

    embed = normal((c.vocab_size, d), 0.02)
    wqkv = stacked((d, qkv_cols))
    wo = stacked((c.num_q_heads * hd, d))
    if c.is_moe:
        e, ffe = c.num_experts, c.moe_intermediate_size
        mlp_gate, mlp_up = stacked((e, d, ffe)), stacked((e, d, ffe))
        mlp_down = stacked((e, ffe, d))
        router = stacked((d, e), scale=0.02)
    else:
        ff = c.intermediate_size
        mlp_gate, mlp_up, mlp_down = stacked((d, ff)), stacked((d, ff)), stacked((ff, d))
        router = None

    return DenseParams(
        embed=embed,
        ln1=ones(L, d),
        wqkv=wqkv,
        wo=wo,
        q_norm=ones(L, hd),
        k_norm=ones(L, hd),
        ln2=ones(L, d),
        mlp_gate=mlp_gate,
        mlp_up=mlp_up,
        mlp_down=mlp_down,
        router=router,
        final_norm=ones(d),
        lm_head=normal((d, c.vocab_size), 1.0 / math.sqrt(d)),
    )


def _replicated(mode: str) -> str:
    """The MLP mode of a replicated (decode-regime) call."""
    return "xla" if mode == "xla" else "dist_ar"


class DenseLLM:
    """Qwen3-style model at world 1; the MLP is ``TP_MoE`` for a MoE config
    and ``TP_MLP`` otherwise, as in JAX. Pass ``params`` (for instance from
    ``models.weights.params_from_numpy``) or a ``generator`` for random
    weights; ``device`` defaults to the current CUDA card."""

    def __init__(self, config: ModelConfig, params: DenseParams | None = None, *,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None, world: int = 1):
        self.config = config
        self.world = world
        self.device = resolve_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            params = init_params(config, generator, self.device)
        self.params = params
        c = config
        p = params
        self.layers = []
        for i in range(c.num_layers):
            attn = TP_Attn(
                p.wqkv[i], p.wo[i],
                RMSNorm(p.q_norm[i], c.rms_eps), RMSNorm(p.k_norm[i], c.rms_eps),
                num_q_heads=c.num_q_heads // world, num_kv_heads=c.num_kv_heads // world,
                head_dim=c.head_dim, rope_theta=c.rope_theta, world=world,
            )
            self.layers.append(
                (RMSNorm(p.ln1[i], c.rms_eps), attn, RMSNorm(p.ln2[i], c.rms_eps), self._mlp(i))
            )
        self.final_norm = RMSNorm(p.final_norm, c.rms_eps)

    def _mlp(self, i: int) -> TP_MLP | TP_MoE:
        c, p = self.config, self.params
        if c.is_moe:
            return TP_MoE(p.router[i], p.mlp_gate[i], p.mlp_up[i], p.mlp_down[i], top_k=c.top_k,
                          world=self.world)
        return TP_MLP(p.mlp_gate[i], p.mlp_up[i], p.mlp_down[i], world=self.world)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return matmul_f32(x, self.params.lm_head)

    @torch.no_grad()
    def prefill(self, tokens, mode: str = "dist"):
        """tokens (B, S) → (last-token logits (B, V) fp32, stacked caches
        ``(ks, vs)`` each (L, B, Hkv, S, D))."""
        c = self.config
        tokens = self._tokens(tokens)
        bsz, seq = tokens.shape
        x = self.params.embed[tokens].reshape(bsz * seq, c.hidden_size)
        pos = torch.arange(seq, dtype=torch.int32, device=self.device)[None].expand(bsz, seq)
        shape = (c.num_layers, bsz, c.num_kv_heads // self.world, seq, c.head_dim)
        ks = torch.empty(shape, dtype=x.dtype, device=self.device)
        vs = torch.empty_like(ks)
        for i, (ln1, attn, ln2, mlp) in enumerate(self.layers):
            a, (k, v) = attn.prefill(ln1(x), pos, mode=mode, bsz=bsz)
            ks[i], vs[i] = k, v
            x = x + a
            # A MoE MLP takes "dist" (seq-sharded) or the replicated modes,
            # exactly the prefill modes (JAX dense.py:201-207).
            x = x + mlp(ln2(x), mode=mode)
        x = self.final_norm(x).reshape(bsz, seq, -1)[:, -1]
        return self._logits(x), (ks, vs)

    @torch.no_grad()
    def prefill_chunk(self, tokens, kbufs, vbufs, off: int, last_idx: int,
                      mode: str = "dist_ar"):
        """One chunk of an incremental prefill: tokens (B, C) at absolute
        start ``off`` against running buffers ``kbufs``/``vbufs``
        (L, B, Hkv, P, D), updated in place. Returns (logits (B, V) of row
        ``last_idx`` of the chunk, (kbufs, vbufs))."""
        c = self.config
        tokens = self._tokens(tokens)
        bsz, seq = tokens.shape
        x = self.params.embed[tokens].reshape(bsz * seq, c.hidden_size)
        pos = (off + torch.arange(seq, dtype=torch.int32, device=self.device))[None].expand(bsz, seq)
        # Chunks are replicated: a MoE MLP takes the decode regime's modes
        # (JAX dense.py:258).
        mlp_mode = _replicated(mode) if c.is_moe else mode
        for i, (ln1, attn, ln2, mlp) in enumerate(self.layers):
            a, _ = attn.prefill_chunk(ln1(x), pos, kbufs[i], vbufs[i], off, mode=mode, bsz=bsz)
            x = x + a
            x = x + mlp(ln2(x), mode=mlp_mode)
        x = self.final_norm(x).reshape(bsz, seq, -1)
        x = x[:, min(max(int(last_idx), 0), seq - 1)]
        return self._logits(x), (kbufs, vbufs)

    @torch.no_grad()
    def decode(self, token, ks, vs, lengths, mode: str = "dist_ar"):
        """token (B,) → (logits (B, V) fp32, ks, vs): one step at positions
        ``lengths``; writes each layer's new K/V into ``ks``/``vs`` in place."""
        token = self._tokens(token)
        x = self.params.embed[token]
        for i, (ln1, attn, ln2, mlp) in enumerate(self.layers):
            a, _ = attn.decode(ln1(x), lengths, ks[i], vs[i], lengths, mode=mode)
            x = x + a
            x = x + mlp(ln2(x), mode=_replicated(mode))  # JAX dense.py:355-358
        return self._logits(self.final_norm(x)), ks, vs


class Qwen3MoE(DenseLLM):
    """Qwen3-MoE (reference ``models/qwen_moe.py:108``): the ``DenseLLM``
    skeleton with a ``TP_MoE`` MLP in every layer. Needs a MoE config."""

    def __init__(self, config: ModelConfig, params: DenseParams | None = None, **kwargs):
        if not config.is_moe:
            raise ValueError("Qwen3MoE needs a MoE config (config.num_experts set)")
        super().__init__(config, params, **kwargs)

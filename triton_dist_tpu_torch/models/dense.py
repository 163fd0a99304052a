"""Qwen3-class LLM, dense or MoE, over tensor-parallel ranks.

Counterpart of ``triton_dist_tpu/models/dense.py`` (``DenseParams``,
``init_params``, ``DenseLLM.prefill_shard`` / ``prefill_chunk_shard`` /
``decode_shard``, ``decode_shard_mega``, ``decode_shard_mega_paged``,
``split_layer_params``, ``Qwen3MoE``; the speculative verify steps are not
ported).
Parameters are stacked over layers as in JAX; a Python loop over layers
stands in for ``lax.scan``. The caches a step is given are updated in place.

At world > 1 every rank holds its shard of the parameters, as JAX's
``_specs`` (``dense.py:51-68``) places them: ``wqkv``, ``mlp_gate``,
``mlp_up`` and ``lm_head`` split into contiguous column blocks, ``wo`` and
``mlp_down`` into row blocks, the rest whole. JAX reads each rank's
``wqkv`` block as [q | k | v] of its own heads, so on the same global arrays
the world-4 model is not the world-1 model. A MoE config's expert slabs
split by ff columns (gate, up) and rows (down) as well, every rank holding
every expert (``TP_MoE``); the expert-parallel MoE model is
``models.moe.EPMoELLM`` (its slabs by whole experts, ``EP_SHARD_DIM``). The
mega step at world > 1 runs the builder over this rank's shard with the
context's all-reduces (JAX ``_mega_builder``, ``dense.py:294-317``).

A context with a ``pp`` axis (``runtime.mesh.split_axes``, JAX's ``pp`` ×
``tp`` mesh) gives the model its tensor-parallel world from the ``tp`` axis
(``ctx``, ``world``) and its pipeline stages from the ``pp`` axis
(``pp_ctx``, ``pp_world``): every rank holds its ``tp`` shard of every
layer, replicated over ``pp`` as JAX's ``p_specs`` place it, and the
engine's pipeline programs (``disagg/pp_engine.py``) run each stage's slice
of ``layers`` through ``prefill_layers`` / ``decode_layers``, the
very layer loops of ``prefill`` and ``decode``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from triton_dist_tpu_torch.kernels.group_gemm import matmul_f32
from triton_dist_tpu_torch.layers.tp import TP_Attn, TP_MLP, TP_MoE, RMSNorm
from triton_dist_tpu_torch.megakernel.builder import ModelBuilder
from triton_dist_tpu_torch.megakernel.kernels import fused_norm_head
from triton_dist_tpu_torch.models.config import ModelConfig, torch_dtype
from triton_dist_tpu_torch.runtime.mesh import all_gather
from triton_dist_tpu_torch.runtime.platform import resolve_device

#: The dimension each sharded parameter splits over the ranks (JAX
#: ``_specs``): -1 a column block, -2 a row block; the others are whole.
SHARD_DIM = {"wqkv": -1, "mlp_gate": -1, "mlp_up": -1, "lm_head": -1, "wo": -2, "mlp_down": -2}
#: The expert-parallel placement (JAX ``models/moe.py:ep_specs``): the MoE
#: expert slabs split on their expert dimension, whole experts per rank.
EP_SHARD_DIM = {**SHARD_DIM, "mlp_gate": -3, "mlp_up": -3, "mlp_down": -3}


def shard(name: str, t, rank: int, world: int, expert_parallel: bool = False):
    """Rank ``rank``'s block of the global parameter ``name``, a torch
    tensor or numpy array (a view; the whole array for a replicated one).
    ``expert_parallel``: the MoE expert slabs by whole experts
    (``EP_SHARD_DIM``) instead of by ff columns and rows."""
    dim = (EP_SHARD_DIM if expert_parallel else SHARD_DIM).get(name)
    if dim is None or world == 1:
        return t
    n = t.shape[dim]
    if n % world:
        raise ValueError(f"{name}: dimension {dim} of {tuple(t.shape)} does not split over {world} ranks")
    idx = [slice(None)] * t.ndim
    idx[dim] = slice(rank * (n // world), (rank + 1) * (n // world))
    return t[tuple(idx)]


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
                device: str | torch.device | None = None, *, rank: int = 0, world: int = 1,
                expert_parallel: bool = False) -> DenseParams:
    """Random weights with the JAX package's scales (``dense.py:84-115``):
    the embedding and the MoE router at 0.02, every other matrix at
    1/sqrt(shape[-2]) (its fan-in), norms at ones. Normals are drawn on
    ``generator``'s device one layer at a time (so a full-size model never
    holds an fp32 copy of a whole stack), scaled in fp32 and cast to the
    model dtype. With ``world`` > 1 every rank draws the same global tensors
    (give each the same seed) and keeps its shard (``shard``; with
    ``expert_parallel``, whole experts)."""
    c = config
    device = resolve_device(device)
    dt = torch_dtype(c)
    L, d, hd = c.num_layers, c.hidden_size, c.head_dim
    qkv_cols = (c.num_q_heads + 2 * c.num_kv_heads) * hd

    def normal(shape, scale, name=None):
        x = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
        return shard(name, x * scale, rank, world, expert_parallel).to(device=device, dtype=dt).contiguous()

    def stacked(shape, scale=None, name=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
        first = normal(shape, scale, name)
        out = torch.empty((L, *first.shape), device=device, dtype=dt)
        out[0] = first
        for i in range(1, L):
            out[i] = normal(shape, scale, name)
        return out

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dt)

    embed = normal((c.vocab_size, d), 0.02)
    wqkv = stacked((d, qkv_cols), name="wqkv")
    wo = stacked((c.num_q_heads * hd, d), name="wo")
    ff_shape = (c.num_experts, d, c.moe_intermediate_size) if c.is_moe else (d, c.intermediate_size)
    mlp_gate, mlp_up = stacked(ff_shape, name="mlp_gate"), stacked(ff_shape, name="mlp_up")
    mlp_down = stacked((*ff_shape[:-2], ff_shape[-1], d), name="mlp_down")
    router = stacked((d, c.num_experts), scale=0.02) if c.is_moe else None

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
        lm_head=normal((d, c.vocab_size), 1.0 / math.sqrt(d), "lm_head"),
    )


def tp_pp_contexts(ctx):
    """(tensor-parallel context, pipeline context) of a model's ``ctx``: a
    context without a ``pp`` axis is all tensor-parallel; one with it gives
    its ``tp`` axis (None when it has none) and its ``pp`` axis."""
    names = getattr(ctx, "axis_names", None)
    if ctx is None or names is None or "pp" not in names:
        return ctx, None
    if set(names) - {"pp", "tp"}:
        raise ValueError(f"a model takes the mesh axes 'pp' and 'tp', not {names}")
    return (ctx.axis("tp") if "tp" in names else None), ctx.axis("pp")


def _replicated(mode: str) -> str:
    """The MLP mode of a replicated (decode-regime) call."""
    return "xla" if mode == "xla" else "dist_ar"


class DenseLLM:
    """Qwen3-style model; the MLP is ``TP_MoE`` for a MoE config and
    ``TP_MLP`` otherwise, as in JAX. Pass ``params`` (for instance from
    ``models.weights.params_from_numpy``) or a ``generator`` for random
    weights. ``ctx`` (``runtime.mesh.DistContext``) sets the world and the
    device, and ``params`` are then this rank's shard; without it the model
    is at world 1 on ``device`` (default the current CUDA card)."""

    #: Whether the MoE expert slabs are sharded by whole experts.
    expert_parallel = False

    def __init__(self, config: ModelConfig, params: DenseParams | None = None, *,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None, ctx=None):
        self.config = config
        self.ctx, self.pp_ctx = tp_pp_contexts(ctx)
        self.world = 1 if self.ctx is None else self.ctx.world
        self.pp_world = 1 if self.pp_ctx is None else self.pp_ctx.world
        if ctx is not None and device is not None and torch.device(device).type != ctx.device.type:
            raise ValueError(f"device {device} differs from the context's {ctx.device}")
        self.device = ctx.device if ctx is not None else resolve_device(device)
        c = config
        if c.num_q_heads % self.world or c.num_kv_heads % self.world:
            raise ValueError(f"{c.num_q_heads} q and {c.num_kv_heads} kv heads do not split over "
                             f"{self.world} ranks")
        if params is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            rank = 0 if self.ctx is None else self.ctx.rank
            params = init_params(config, generator, self.device, rank=rank, world=self.world,
                                 expert_parallel=self.expert_parallel)
        self.params = params
        p = params
        self.layers = []
        for i in range(c.num_layers):
            attn = TP_Attn(
                p.wqkv[i], p.wo[i],
                RMSNorm(p.q_norm[i], c.rms_eps), RMSNorm(p.k_norm[i], c.rms_eps),
                num_q_heads=c.num_q_heads // self.world, num_kv_heads=c.num_kv_heads // self.world,
                head_dim=c.head_dim, rope_theta=c.rope_theta, ctx=self.ctx,
            )
            self.layers.append(
                (RMSNorm(p.ln1[i], c.rms_eps), attn, RMSNorm(p.ln2[i], c.rms_eps), self._mlp(i))
            )
        self.final_norm = RMSNorm(p.final_norm, c.rms_eps)

    def _mlp(self, i: int) -> TP_MLP | TP_MoE:
        c, p = self.config, self.params
        if c.is_moe:
            return TP_MoE(p.router[i], p.mlp_gate[i], p.mlp_up[i], p.mlp_down[i], top_k=c.top_k,
                          ctx=self.ctx)
        return TP_MLP(p.mlp_gate[i], p.mlp_up[i], p.mlp_down[i], ctx=self.ctx)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return matmul_f32(x, self.params.lm_head)

    @torch.no_grad()
    def prefill(self, tokens, mode: str = "dist"):
        """tokens (B, S) → (last-token logits (B, V / world) fp32, this
        rank's columns; stacked caches ``(ks, vs)`` each (L, B, Hkv / world,
        S, D)). ``dist`` mode runs the layers on this rank's 1/world of the
        B·S rows and gathers them back before the head (JAX
        ``dense.py:189-192,217-220``); B·S must split over the ranks."""
        c = self.config
        tokens = self._tokens(tokens)
        bsz, seq = tokens.shape
        x = self.params.embed[tokens].reshape(bsz * seq, c.hidden_size)
        pos = torch.arange(seq, dtype=torch.int32, device=self.device)[None].expand(bsz, seq)
        sharded = mode == "dist" and self.world > 1
        if sharded:
            if (bsz * seq) % self.world:
                raise ValueError(f"dist prefill splits B·S = {bsz * seq} rows over {self.world} ranks: "
                                 "not divisible")
            chunk = bsz * seq // self.world
            x = x[self.ctx.rank * chunk:(self.ctx.rank + 1) * chunk]
        shape = (c.num_layers, bsz, c.num_kv_heads // self.world, seq, c.head_dim)
        ks = torch.empty(shape, dtype=x.dtype, device=self.device)
        vs = torch.empty_like(ks)
        x = self.prefill_layers(x, pos, bsz, mode, self.layers, ks, vs)
        x = self.final_norm(x)
        if sharded:
            x = all_gather(self.ctx, x, 0)
        x = x.reshape(bsz, seq, -1)[:, -1]
        return self._logits(x), (ks, vs)

    @staticmethod
    def prefill_layers(x, pos, bsz: int, mode: str, layers, ks, vs) -> torch.Tensor:
        """``layers`` over x (bsz·S, d) at positions ``pos`` (bsz, S), each
        layer's K and V written into ``ks[i]``, ``vs[i]`` (B, Hkv, S, D)."""
        for i, (ln1, attn, ln2, mlp) in enumerate(layers):
            a, (k, v) = attn.prefill(ln1(x), pos, mode=mode, bsz=bsz)
            ks[i], vs[i] = k, v
            x = x + a
            # A MoE MLP takes "dist" (seq-sharded) or the replicated modes,
            # exactly the prefill modes (JAX dense.py:201-207).
            x = x + mlp(ln2(x), mode=mode)
        return x

    @staticmethod
    def decode_layers(x, lengths, ks, vs, mode: str, layers) -> torch.Tensor:
        """``layers`` over one token a row, x (B, d) at positions
        ``lengths``; each layer writes its new K/V into ``ks[i]``, ``vs[i]``
        (B, Hkv, T, D) in place."""
        for i, (ln1, attn, ln2, mlp) in enumerate(layers):
            a, _ = attn.decode(ln1(x), lengths, ks[i], vs[i], lengths, mode=mode)
            x = x + a
            x = x + mlp(ln2(x), mode=_replicated(mode))  # JAX dense.py:355-358
        return x

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
        """token (B,) → (logits (B, V / world) fp32, ks, vs): one step at positions
        ``lengths``; writes each layer's new K/V into ``ks``/``vs`` in place.
        ``mode="mega"`` is ``decode_mega``'s, which needs the per-layer
        parameters and the step function."""
        if mode == "mega":
            raise ValueError("mega decode needs per-layer params and a step function: use decode_mega")
        return self._logits(self.decode_hidden(token, ks, vs, lengths, mode)), ks, vs

    @torch.no_grad()
    def decode_hidden(self, token, ks, vs, lengths, mode: str = "dist_ar") -> torch.Tensor:
        """``decode`` up to the head: the final-normed hidden states (B, d),
        replicated over the ranks (the same bits on every rank where the
        collectives reduce in rank order)."""
        x = self.params.embed[self._tokens(token)]
        return self.final_norm(self.decode_layers(x, lengths, ks, vs, mode, self.layers))

    # -- the mega backend ---------------------------------------------------

    _LAYER_FIELDS = ("ln1", "wqkv", "wo", "q_norm", "k_norm", "ln2", "mlp_gate", "mlp_up", "mlp_down")

    def split_layer_params(self) -> list[dict]:
        """Per-layer parameter dicts for the mega step (with ``router`` for a
        MoE config). Each entry is a VIEW of the stacked tensor (a
        leading-index slice of a contiguous tensor is contiguous), so the
        kernels read the stacked weights in place and no second copy exists;
        the JAX package materialises a per-layer copy here, because a Pallas
        call cannot take a slice lazily. At world > 1 they are this rank's
        shard."""
        p = self.params
        fields = self._LAYER_FIELDS + (("router",) if self.config.is_moe else ())
        return [{f: getattr(p, f)[i] for f in fields} for i in range(self.config.num_layers)]

    def mega_step_fn(self, *, paged: bool = False):
        """The whole decode step as one recorded task graph
        (``ModelBuilder.build_step_fn``, scoreboard policy), over the
        contiguous caches or, with ``paged``, the block pools; its ``plan``
        lists the lowerings. At world > 1 the step is this rank's, its
        all-reduces over ``ctx``."""
        return ModelBuilder(self.config, paged=paged, ctx=self.ctx).build_step_fn(self.config.num_layers)

    @torch.no_grad()
    def decode_mega(self, step_fn, mega_layers: list, token, ks, vs, lengths):
        """One mega decode step (JAX ``decode_shard_mega``): embed, the step
        function over ``mega_layers`` (``split_layer_params``), then the
        fused final norm and lm_head. Returns (logits (B, V / world) fp32,
        this rank's columns, ks, vs); the caches are updated in place."""
        x = self.params.embed[self._tokens(token)]
        x, ks, vs = step_fn(mega_layers, x, ks, vs, lengths)
        logits = fused_norm_head(x, self.params.final_norm, self.params.lm_head, eps=self.config.rms_eps)
        return logits, ks, vs

    @torch.no_grad()
    def decode_mega_paged(self, step_fn, mega_layers: list, token, pk, pv, tables, lengths, active):
        """One paged mega decode step (JAX ``decode_shard_mega_paged``): the
        ``mega_step_fn(paged=True)`` step writes each slot's new rows through
        its block table into the stacked pools ``pk``/``pv`` (L, num_blocks,
        Hkv, bs, D) and walks them; ``tables`` (B, max_blocks) int32 and
        ``active`` (B,) bool are data. Inactive slots write to the NULL block
        and attend their frozen ``lengths`` rows; the caller masks their
        logits. ``pk``/``pv`` may be ``QuantPool`` pairs
        (``PagedKVCache.pool_pair``, JAX ``Engine._pool_pair``): the same
        plan quantizes the new rows at append and walks them with row 3b.
        Returns (logits (B, V) fp32, pk, pv), the pools updated in place."""
        x = self.params.embed[self._tokens(token)]
        x, pk, pv = step_fn(mega_layers, x, pk, pv, lengths, active=active, tables=tables)
        logits = fused_norm_head(x, self.params.final_norm, self.params.lm_head, eps=self.config.rms_eps)
        return logits, pk, pv


class Qwen3MoE(DenseLLM):
    """Qwen3-MoE (reference ``models/qwen_moe.py:108``): the ``DenseLLM``
    skeleton with a ``TP_MoE`` MLP in every layer. Needs a MoE config."""

    def __init__(self, config: ModelConfig, params: DenseParams | None = None, **kwargs):
        if not config.is_moe:
            raise ValueError("Qwen3MoE needs a MoE config (config.num_experts set)")
        super().__init__(config, params, **kwargs)

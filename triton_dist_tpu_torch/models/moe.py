"""Expert-parallel Qwen3-MoE: counterpart of ``triton_dist_tpu/models/moe.py``
(``ep_specs``, ``EPMoELLM``).

The ``DenseLLM`` skeleton, tensor-parallel attention, with the MLP an
``EP_MoE``: rank r holds whole experts ``[r·E_local, (r+1)·E_local)`` of every
layer, ``(E_local, d, ff)`` and ``(E_local, ff, d)``, over the same ranks the
attention splits its heads on. The route of each MoE call follows JAX's
``_ep_mlp``: mode ``xla`` forces ``EPMoEMethod.XLA`` (the plain composition
on the plain transport); ``dist`` (tokens sharded by rows) and ``dist_ar``
(tokens replicated) resolve AUTO by the token count: at or below the
crossover the fp8-wire low-latency route, above it the fused one.
``use_pallas_a2a`` keeps JAX's meaning: False rides the plain transport,
True takes rows 25 and 26 on the routes other than ``xla``.

Not ported: the per-expert routing telemetry (``_note_ep_stats``, with
ROADMAP item A1), the degraded-transport gate (A2/F), and the mega
lowering (``_mega_moe_impl``: the mega builder's ``moe_impl`` hook, and its
world, item B2); ``backend="mega"`` raises.
"""

from __future__ import annotations

from triton_dist_tpu_torch.kernels.low_latency_a2a import (
    EPMoEMethod,
    ep_a2a_crossover_tokens,
    get_auto_ep_moe_method,
)
from triton_dist_tpu_torch.layers.ep import EP_MoE
from triton_dist_tpu_torch.layers.tp import MOE_CAPACITY_FACTOR
from triton_dist_tpu_torch.models.config import ModelConfig
from triton_dist_tpu_torch.models.dense import EP_SHARD_DIM, DenseLLM, DenseParams

MEGA_EP = ("EPMoELLM on the mega backend needs the mega builder's moe_impl hook (JAX "
           "megakernel/builder.py:73,575; ROADMAP queue 1 item C4)")


def ep_specs(config: ModelConfig) -> dict[str, int]:
    """The expert-parallel placement: the dimension each sharded parameter
    splits on (``models.dense.shard``), the expert slabs on E."""
    if not config.is_moe:
        raise ValueError("ep_specs needs a MoE config")
    return dict(EP_SHARD_DIM)


class EPMoELLM(DenseLLM):
    """Qwen3-MoE with the MLP expert-parallel over the tensor-parallel ranks.
    ``config.num_experts`` must split over the world. Pass ``params`` (each
    rank's shard, e.g. ``params_from_numpy(..., expert_parallel=True)``) or
    a ``generator`` for random weights."""

    expert_parallel = True

    def __init__(self, config: ModelConfig, params: DenseParams | None = None, *,
                 use_pallas_a2a: bool = False, **kwargs):
        if not config.is_moe:
            raise ValueError("EPMoELLM needs a MoE config (config.num_experts set)")
        ctx = kwargs.get("ctx")
        world = 1 if ctx is None else ctx.world
        if config.num_experts % world:
            raise ValueError(f"num_experts={config.num_experts} must divide over world={world}")
        self.use_pallas_a2a = use_pallas_a2a
        super().__init__(config, params, **kwargs)

    def ep_crossover_tokens(self) -> int:
        """The low_latency ↔ fused threshold this model routes by."""
        return ep_a2a_crossover_tokens(self.world)

    def _mlp(self, i: int):
        p = self.params
        lp = {"router": p.router[i], "mlp_gate": p.mlp_gate[i], "mlp_up": p.mlp_up[i], "mlp_down": p.mlp_down[i]}

        def run(x, mode="dist_ar"):
            return self._ep_mlp(lp, x, mode)

        return run

    def _ep_mlp(self, lp: dict, x, mode: str):
        """One EP MoE call on this rank's tokens x (T, d): the route by mode and
        T, then ``EP_MoE``."""
        c = self.config
        if mode == "xla":
            method = EPMoEMethod.XLA
        else:
            method = get_auto_ep_moe_method(x.shape[0], self.world)
        use_pallas = self.use_pallas_a2a and method is not EPMoEMethod.XLA
        moe = EP_MoE(lp["router"], lp["mlp_gate"], lp["mlp_up"], lp["mlp_down"], num_experts=c.num_experts,
                     top_k=c.top_k, capacity_factor=MOE_CAPACITY_FACTOR, ctx=self.ctx, use_pallas_a2a=use_pallas,
                     low_latency=method is EPMoEMethod.LOW_LATENCY,
                     fused_kernel=method is EPMoEMethod.FUSED and use_pallas)
        return moe(x)

    def split_layer_params(self) -> list[dict]:
        raise NotImplementedError(MEGA_EP)

    def mega_step_fn(self, *, paged: bool = False):
        raise NotImplementedError(MEGA_EP)

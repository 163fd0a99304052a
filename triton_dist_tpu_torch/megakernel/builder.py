"""ModelBuilder: assemble a decode step from fused task groups.

Counterpart of ``triton_dist_tpu/megakernel/builder.py``.
``make_*`` calls record the model's ops into ``self.graph``;
``build_layer_fn`` / ``build_step_fn`` consume the scheduler's fusion
groups to pick kernels: an ``attn_front`` group lowers to
``fused_ln_qkv_rope``, an ``attn_back`` or ``attn_sweep`` group to
``fused_attn_back`` (``fused_paged_attn_back`` when paged), an
``mlp_block`` group to ``fused_mlp_block``, a ``moe_block`` group (a MoE
config) to the routed-experts kernel ``fused_moe_block`` between plain
routing and combine, and any unmatched or pinned task to its standalone
op. The chosen lowerings are recorded in ``ModelBuilder.plan`` as
``"{group}@{layer}→{executor}"`` strings, the same as the JAX package's for
the same config and policy.

``build_step_fn`` records the whole model's decode step as ONE graph
(every layer's tasks with ``@<layer>`` names); under the default
``scoreboard`` policy a layer's cache scatter is emitted after the next
layer's attention front. The caches are the stacked ``(L, B, Hkv, S, D)``
tensors or, with ``paged=True``, the stacked block pools ``(L,
num_blocks, Hkv, bs, D)`` with the block tables and the per-slot active
mask as step inputs; both are updated in place (JAX returns new arrays).
The block pools may be ``QuantPool`` pairs (``models/quant.py``): the
plan is the same, the paged ``cache_update`` lowerings quantize the new
rows once at append and the walk is row 3b (JAX ``builder.py:688-763``).

At tensor-parallel world > 1 (a ``ctx``, JAX's ``world``) every rank
records the same graph over its shard: its q and kv heads and its ff
columns. The attention back-leg's fp32 o-projection partial is cast to the
model dtype and all-reduced one-shot (row 22); the MLP's partial and the
MoE block's fp32 combine are all-reduced with ``AUTO`` in fp32 and cast
(``allreduce.all_reduce_shard``), at JAX's rounding points
(``builder.py:470-479, 609-616, 823-834``).

Not ported: the JAX builder's ``moe_impl`` hook, through which the
expert-parallel model lowers its ``moe`` task, comes with that model
(ROADMAP queue 1 items B and C); ``build_verify_fn`` (speculative
decoding, item C) raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels.allreduce import AllReduceMethod, all_reduce_shard
from triton_dist_tpu_torch.kernels.flash_decode import flash_decode, paged_flash_decode
from triton_dist_tpu_torch.kernels.gemm_allreduce import gemm_ar_shard
from triton_dist_tpu_torch.kernels.group_gemm import matmul_f32
from triton_dist_tpu_torch.kernels.moe_utils import (
    capacity_for,
    combine,
    dispatch,
    make_routing_plan,
    topk_routing,
)
from triton_dist_tpu_torch.kernels.norm_rope import apply_rope, rmsnorm
from triton_dist_tpu_torch.layers.tp import MOE_CAPACITY_FACTOR, TP_MoE
from triton_dist_tpu_torch.megakernel.graph import Task, TaskGraph
from triton_dist_tpu_torch.megakernel.kernels import (
    fused_attn_back,
    fused_ln_qkv_rope,
    fused_mlp_block,
    fused_moe_block,
    fused_paged_attn_back,
    paged_write_at,
    write_pool_rows,
)

#: What the builder leaves to a later item.
_VERIFY = "the speculative k-wide verify step is ROADMAP queue 1 item C"

#: The decode batch and context the ``cost`` policy models (the JAX
#: builder's defaults, so that the plans agree).
COST_BATCH_HINT = 8
COST_CTX_HINT = 4096


def _append_at(env: dict, len_in: str, s: int):
    """Where each slot's new K/V row goes in a cache of S rows: (slots,
    row index, keep mask). A slot whose length has reached S keeps its row,
    as JAX's out-of-bounds scatter drops the write (a plain
    ``cache[li, rows, :, lengths] = new`` would index out of range). Every
    layer appends at the same lengths, so this is computed once per step
    and kept in the step's value environment."""
    key = f"{len_in}#append@{s}"
    if key not in env:
        lengths = env[len_in]
        rows = torch.arange(lengths.shape[0], device=lengths.device)
        env[key] = (rows, lengths.long().clamp(min=0, max=s - 1), (lengths < s)[:, None, None])
    return env[key]


def _write_rows(cache: torch.Tensor, li: int, new: torch.Tensor, at) -> None:
    """Write ``new`` (B, Hkv, D) into layer ``li`` of the stacked cache
    (L, B, Hkv, S, D) in place, at ``at = _append_at(...)``."""
    rows, idx, keep = at
    cache[li, rows, :, idx] = torch.where(keep, new, cache[li, rows, :, idx])


def _paged_at(env: dict, len_in: str, act_in: str, tab_in: str, bs: int):
    """``paged_write_at`` for this step's lengths, active mask and tables:
    computed once per step (every layer writes at the same place) and kept
    in the step's value environment."""
    key = f"{len_in}#paged@{bs}"
    if key not in env:
        env[key] = paged_write_at(env[tab_in], env[len_in], env[act_in], bs)
    return env[key]


class ModelBuilder:
    """Records a transformer decode step's tasks and lowers them.

    Usage (as the JAX builder):
        mb = ModelBuilder(config)
        step_fn = mb.build_step_fn(config.num_layers)   # also fills mb.graph
        print(mb.graph.summary())                        # the fusion schedule
        print(mb.plan)                                   # the kernels it chose

    To audit or override the fusion, record first, mutate ``mb.graph``
    (``pin_standalone``), then call ``build_layer_fn()``: it lowers
    whatever the graph holds. ``schedule_policy`` is ``"scoreboard"``
    (default), ``"static"`` or ``"cost"`` (``TaskGraph.schedule``).
    ``ctx`` (``runtime.mesh.DistContext``; None at world 1) sets the
    tensor-parallel world the step runs at, JAX's ``world``."""

    def __init__(self, config, schedule_policy: str = "scoreboard", paged: bool = False, *, ctx=None):
        self.config = config
        self.schedule_policy = schedule_policy
        self.paged = paged
        self.ctx = ctx
        self.world = 1 if ctx is None else ctx.world
        if config.num_q_heads % self.world or config.num_kv_heads % self.world:
            raise ValueError(f"{config.num_q_heads} q and {config.num_kv_heads} kv heads do not split over "
                             f"{self.world} ranks")
        self.graph = TaskGraph()
        self.plan: list[str] = []

    # ------------------------------------------------------------ cost model
    def group_cost(self, gname: str, window) -> float:
        """Modeled fraction of the group's memory traffic that fusing saves
        (each intermediate kept on chip skips one write and one read); the
        ``cost`` policy fuses only when this clears
        ``graph.COST_FUSE_THRESHOLD``. The same model as the JAX builder's."""
        c = self.config
        b = COST_BATCH_HINT
        d = c.hidden_size
        hq, hkv, hd = c.num_q_heads // self.world, c.num_kv_heads // self.world, c.head_dim
        cols = (hq + 2 * hkv) * hd
        # Element counts, not bytes: every tensor in a group shares the
        # model dtype, so the itemsize cancels out of the ratio.
        if gname == "attn_front":
            saved = 2 * (b * d + 2 * b * cols)
            base = d * cols + b * d
        elif gname in ("attn_back", "attn_sweep"):
            saved = 2 * b * hq * hd  # attention output round-trip
            base = hq * hd * d + 2 * hkv * COST_CTX_HINT * hd * b
        elif gname == "mlp_block":
            ff = c.intermediate_size // self.world
            saved = 2 * (b * d + 3 * b * ff)
            base = 3 * d * ff + b * d
        elif gname == "moe_block":
            ff = c.moe_intermediate_size // self.world
            e = c.num_experts
            cap = capacity_for(b, c.top_k, e, MOE_CAPACITY_FACTOR)
            saved = 2 * e * cap * ff
            base = 3 * e * d * ff + e * cap * d
        else:
            return 1.0  # unknown group: trust the static decision
        return saved / max(base, 1)

    # ------------------------------------------------------------- recording
    # All make_* accept a ``tag`` (task/value name suffix, "@<layer>" in the
    # step graph) and the wiring values that differ per layer; the defaults
    # record the classic single-layer graph.
    def make_attn_front(self, *, tag: str = "", x_in: str = "input:x"):
        g = self.graph
        g.add(Task(f"ln1{tag}", "rmsnorm", (x_in, "param:ln1"), (f"v:xn1{tag}",)))
        g.add(Task(f"qkv_proj{tag}", "linear", (f"v:xn1{tag}", "param:wqkv"), (f"v:qkv{tag}",)))
        g.add(Task(f"qk_norm{tag}", "head_norm", (f"v:qkv{tag}", "param:q_norm", "param:k_norm"),
                   (f"v:qkv_n{tag}",)))
        g.add(Task(f"rope{tag}", "rope", (f"v:qkv_n{tag}", "input:pos"),
                   (f"v:q{tag}", f"v:k{tag}", f"v:v{tag}")))

    def make_attn_back(self, *, tag: str = "", x_in: str = "input:x",
                       kc_in: str = "input:kc", vc_in: str = "input:vc",
                       split_sweep: bool = False):
        """Attention back-leg, in one of three recorded shapes:

        * classic (default): ``cache_update → flash_decode → o-proj → add``,
          the 4-chain ``attn_back`` group;
        * ``split_sweep=True`` (the contiguous step graph): the sweep
          (``flash_decode_append``, which splices the new row in itself)
          first, and the cache scatter as a separate task that depends only
          on k and v, which the scoreboard defers;
        * ``self.paged``: the classic chain, its cache tasks taking the
          ``input:active`` and ``input:tables`` step inputs and writing /
          walking the block pool (the write must come before the walk: a
          paged sweep has no splice)."""
        g = self.graph
        if self.paged:
            g.add(Task(f"cache_update{tag}", "cache_update",
                       (f"v:k{tag}", f"v:v{tag}", kc_in, vc_in, "input:lengths", "input:active",
                        "input:tables"),
                       (f"v:kc2{tag}", f"v:vc2{tag}")))
            g.add(Task(f"flash_decode{tag}", "flash_decode",
                       (f"v:q{tag}", f"v:kc2{tag}", f"v:vc2{tag}", "input:lengths", "input:active",
                        "input:tables"),
                       (f"v:attn{tag}",)))
            g.add(Task(f"o_proj_ar{tag}", "linear_allreduce",
                       (f"v:attn{tag}", "param:wo"), (f"v:attn_out{tag}",)))
            g.add(Task(f"resid1{tag}", "add", (x_in, f"v:attn_out{tag}"), (f"v:x1{tag}",)))
            return
        if split_sweep:
            g.add(Task(f"flash_decode{tag}", "flash_decode_append",
                       (f"v:q{tag}", f"v:k{tag}", f"v:v{tag}", kc_in, vc_in, "input:lengths"),
                       (f"v:attn{tag}",)))
            g.add(Task(f"o_proj_ar{tag}", "linear_allreduce",
                       (f"v:attn{tag}", "param:wo"), (f"v:attn_out{tag}",)))
            g.add(Task(f"resid1{tag}", "add", (x_in, f"v:attn_out{tag}"), (f"v:x1{tag}",)))
            g.add(Task(f"cache_update{tag}", "cache_update",
                       (f"v:k{tag}", f"v:v{tag}", kc_in, vc_in, "input:lengths"),
                       (f"v:kc2{tag}", f"v:vc2{tag}")))
            return
        g.add(Task(f"cache_update{tag}", "cache_update",
                   (f"v:k{tag}", f"v:v{tag}", kc_in, vc_in, "input:lengths"),
                   (f"v:kc2{tag}", f"v:vc2{tag}")))
        g.add(Task(f"flash_decode{tag}", "flash_decode",
                   (f"v:q{tag}", f"v:kc2{tag}", f"v:vc2{tag}", "input:lengths"),
                   (f"v:attn{tag}",)))
        g.add(Task(f"o_proj_ar{tag}", "linear_allreduce",
                   (f"v:attn{tag}", "param:wo"), (f"v:attn_out{tag}",)))
        g.add(Task(f"resid1{tag}", "add", (x_in, f"v:attn_out{tag}"), (f"v:x1{tag}",)))

    def make_mlp_block(self, *, tag: str = ""):
        g = self.graph
        g.add(Task(f"ln2{tag}", "rmsnorm", (f"v:x1{tag}", "param:ln2"), (f"v:xn2{tag}",)))
        g.add(Task(f"gate_up{tag}", "linear", (f"v:xn2{tag}", "param:mlp_gate", "param:mlp_up"),
                   (f"v:gu{tag}",)))
        g.add(Task(f"swiglu{tag}", "swiglu", (f"v:gu{tag}",), (f"v:h{tag}",)))
        g.add(Task(f"down{tag}", "linear", (f"v:h{tag}", "param:mlp_down"), (f"v:mlp_partial{tag}",)))
        g.add(Task(f"mlp_ar{tag}", "allreduce", (f"v:mlp_partial{tag}",), (f"v:mlp_out{tag}",)))
        g.add(Task(f"resid2{tag}", "add", (f"v:x1{tag}", f"v:mlp_out{tag}"), (f"v:x2{tag}",)))

    def make_moe_block(self, *, tag: str = ""):
        """MoE variant of the MLP block: the routed grouped-expert MLP and its
        all-reduce in one ``moe`` task, lowered through the routed-experts
        kernel (``pin_standalone("moe")``: through ``TP_MoE``)."""
        g = self.graph
        g.add(Task(f"ln2{tag}", "rmsnorm", (f"v:x1{tag}", "param:ln2"), (f"v:xn2{tag}",)))
        g.add(Task(f"moe{tag}", "moe",
                   (f"v:xn2{tag}", "param:router", "param:mlp_gate", "param:mlp_up", "param:mlp_down"),
                   (f"v:mlp_out{tag}",)))
        g.add(Task(f"resid2{tag}", "add", (f"v:x1{tag}", f"v:mlp_out{tag}"), (f"v:x2{tag}",)))

    def _make_mlp(self, *, tag: str = ""):
        if self.config.is_moe:
            self.make_moe_block(tag=tag)
        else:
            self.make_mlp_block(tag=tag)

    def _record_layer(self, i: int):
        tag = f"@{i}"
        x_in = "input:x" if i == 0 else f"v:x2@{i - 1}"
        kc_in = "input:kc" if i == 0 else f"v:kc2@{i - 1}"
        vc_in = "input:vc" if i == 0 else f"v:vc2@{i - 1}"
        self.make_attn_front(tag=tag, x_in=x_in)
        self.make_attn_back(tag=tag, x_in=x_in, kc_in=kc_in, vc_in=vc_in, split_sweep=not self.paged)
        self._make_mlp(tag=tag)

    # --------------------------------------------------------------- lowering
    def _lower_all(self, li_of) -> list:
        """Schedule the recorded graph and lower each group; ``li_of(group)``
        is the group's layer index (None: read it from the cache values).
        Returns the (executor, layer) list in emission order and fills
        ``self.plan``."""
        groups = self.graph.schedule(policy=self.schedule_policy, cost_fn=self.group_cost)
        executors, self.plan = [], []
        for group in groups:
            gname = group[0].group.split(":")[0]
            li = li_of(group)
            ex = self._lower_group(gname, group, li=li)
            self.plan.append(f"{gname}→{ex.__name__}" if li is None else f"{gname}@{li}→{ex.__name__}")
            executors.append((ex, li))
        return executors

    def build_layer_fn(self):
        """Schedule the recorded graph (recording the standard layer if the
        graph is empty) and return ``layer_fn(lp, x, ks, vs, li, lengths) ->
        (x', ks, vs)`` assembled group by group from the schedule. ``ks`` and
        ``vs`` are the stacked caches, updated in place at layer ``li``."""
        if not self.graph.tasks:
            self.make_attn_front()
            self.make_attn_back()
            self._make_mlp()
        executors = self._lower_all(lambda group: None)
        # The layer's results are wherever the graph says they are: the last
        # task's first output is the residual stream, the cache_update
        # task's outputs are the updated caches.
        final_out = self.graph.tasks[-1].outputs[0]
        cu = next((t for t in self.graph.tasks if t.op == "cache_update"), None)
        if cu is None:
            raise ValueError(
                "megakernel graph must contain a cache_update task: build_layer_fn returns "
                "(residual, k_cache, v_cache) and reads the caches off that task's outputs")
        kc_out, vc_out = cu.outputs
        env_of = self._env_fn()

        def layer_fn(lp, x, ks, vs, li, lengths, active=None, tables=None):
            env = env_of(x, ks, vs, lengths, active, tables, li)
            for ex, _ in executors:
                ex(env, lp)
            return env[final_out], env[kc_out][0], env[vc_out][0]

        layer_fn.plan = tuple(self.plan)
        return layer_fn

    def _env_fn(self):
        """The step's input environment: x, positions, lengths, the caches
        (with their layer) and, when paged, the active mask and tables."""
        paged = self.paged

        def env_of(x, ks, vs, lengths, active, tables, li):
            env = {"input:x": x, "input:pos": lengths, "input:lengths": lengths,
                   "input:kc": (ks, li), "input:vc": (vs, li)}
            if paged:
                if active is None or tables is None:
                    raise ValueError("a paged step needs the active and tables operands")
                env["input:active"] = active
                env["input:tables"] = tables
            return env
        return env_of

    def build_step_fn(self, num_layers: int):
        """The whole decode step: ``num_layers`` layers recorded into ONE
        graph and scheduled as one unit. Returns ``step_fn(layers, x, ks, vs,
        lengths, active=None, tables=None) -> (x', ks, vs)``, where
        ``layers`` is the per-layer parameter list
        (``DenseLLM.split_layer_params``) and ``ks``/``vs`` the stacked
        contiguous caches or, with ``paged=True``, the stacked block pools
        with ``tables`` (B, max_blocks) int32 and ``active`` (B,) bool;
        updated in place."""
        if self.graph.tasks:
            raise ValueError("build_step_fn records its own graph — use a fresh builder")
        for i in range(num_layers):
            self._record_layer(i)
        executors = self._lower_all(lambda group: int(group[0].name.rsplit("@", 1)[1]))
        last = num_layers - 1
        final_out = f"v:x2@{last}"
        kc_out, vc_out = f"v:kc2@{last}", f"v:vc2@{last}"

        env_of = self._env_fn()

        def step_fn(layers, x, ks, vs, lengths, active=None, tables=None):
            env = env_of(x, ks, vs, lengths, active, tables, 0)
            for ex, li in executors:
                ex(env, layers[li])
            return env[final_out], env[kc_out][0], env[vc_out][0]

        step_fn.plan = tuple(self.plan)
        return step_fn

    def build_verify_fn(self, num_layers: int, k: int):
        """The k-wide speculative verify program: not ported yet."""
        raise NotImplementedError(_VERIFY)

    def _lower_group(self, gname: str, group, *, li: int | None = None):
        """Return an executor closure ``ex(env, lp)`` for one fusion group
        (or one standalone task); executors read and write the value
        environment. ``li`` binds the layer index at lowering time (each
        group of the step graph belongs to one layer); ``li=None`` reads it
        from the cache values that ``layer_fn`` threads through."""
        c = self.config
        hq, hkv, hd = c.num_q_heads // self.world, c.num_kv_heads // self.world, c.head_dim
        eps = c.rms_eps
        ctx, world = self.ctx, self.world

        def attn_all_reduce(partial, dtype):
            """The o-projection's fp32 partial cast to the model dtype, then
            all-reduced one-shot (the identity at world 1), as JAX's back-leg
            does."""
            return all_reduce_shard(ctx, partial.to(dtype), method=AllReduceMethod.ONE_SHOT)

        def fp32_all_reduce(x, dtype):
            """x all-reduced in fp32 with ``AUTO`` (world > 1), cast to dtype."""
            if world > 1:
                x = all_reduce_shard(ctx, x.float(), method=AllReduceMethod.AUTO)
            return x.to(dtype)

        def param(name):
            return name.split(":", 1)[1]

        def cache_li(env_li):
            return env_li if li is None else li

        # The fused executors consume the GROUP's recorded dataflow (task
        # inputs and outputs), the same contract as the standalone ones.
        if gname == "attn_front":
            # [rmsnorm(x, ln), linear(·, w), head_norm(·, qn, kn), rope(·, pos)]
            ln_t, lin_t, hn_t, rope_t = group
            x_in, ln_p = ln_t.inputs[0], param(ln_t.inputs[1])
            w_p = param(lin_t.inputs[1])
            qn_p, kn_p = param(hn_t.inputs[1]), param(hn_t.inputs[2])
            pos_in = rope_t.inputs[1]
            out_q, out_k, out_v = rope_t.outputs

            def fused_attn_front(env, lp):
                x = env[x_in]
                b = x.shape[0]
                q, k, v = fused_ln_qkv_rope(
                    x, lp[ln_p], lp[w_p], lp[qn_p], lp[kn_p], env[pos_in], num_q_heads=hq,
                    num_kv_heads=hkv, head_dim=hd, rope_theta=c.rope_theta, eps=eps,
                )
                env[out_q] = q.reshape(b, hq, hd)
                env[out_k] = k.reshape(b, hkv, hd)
                env[out_v] = v.reshape(b, hkv, hd)
            return fused_attn_front

        if gname == "attn_back" and self.paged:
            # [cache_update(k, v, pk, pv, len, active, tables), flash_decode(·),
            #  linear_allreduce(·, wo), add(x, ·)]: pool write, block-table
            # walk and o-projection in one fused_paged_attn_back call; the
            # partial is cast to the model dtype and all-reduced, then the
            # residual.
            cu_t, fd_t, oar_t, add_t = group
            k_in, v_in, kc_in, vc_in, len_in, act_in, tab_in = cu_t.inputs
            q_in = fd_t.inputs[0]
            wo_p = param(oar_t.inputs[1])
            resid_in = add_t.inputs[0] if add_t.inputs[1] == oar_t.outputs[0] else add_t.inputs[1]
            kc_out, vc_out = cu_t.outputs
            out_v = add_t.outputs[0]

            def fused_paged_attn_back_ex(env, lp):
                q = env[q_in]
                pk, env_li = env[kc_in]
                pv, _ = env[vc_in]
                li_ = cache_li(env_li)
                at = _paged_at(env, len_in, act_in, tab_in, pk.shape[3])
                partial, pk, pv = fused_paged_attn_back(
                    q, env[k_in], env[v_in], pk, pv, li_, env[tab_in], env[len_in], env[act_in],
                    lp[wo_p], at=at)
                env[out_v] = env[resid_in] + attn_all_reduce(partial, q.dtype)
                env[kc_out] = (pk, li_)
                env[vc_out] = (pv, li_)
            return fused_paged_attn_back_ex

        if gname in ("attn_back", "attn_sweep"):
            # attn_back: [cache_update(k, v, kc, vc, len), flash_decode(q, ·, ·, len),
            #             linear_allreduce(·, wo), add(x, ·)]
            # attn_sweep: [flash_decode_append(q, k, v, kc, vc, len),
            #              linear_allreduce(·, wo), add(x, ·)]
            # One fused_attn_back call (the new row spliced in by the kernel);
            # the o-projection partial is cast to the model dtype and
            # all-reduced, then the residual. The classic group also writes
            # the new row into the cache.
            if gname == "attn_back":
                cu_t, fd_t, oar_t, add_t = group
                q_in, (k_in, v_in, kc_in, vc_in, len_in) = fd_t.inputs[0], cu_t.inputs
            else:
                fd_t, oar_t, add_t = group
                cu_t = None
                q_in, k_in, v_in, kc_in, vc_in, len_in = fd_t.inputs
            wo_p = param(oar_t.inputs[1])
            resid_in = add_t.inputs[0] if add_t.inputs[1] == oar_t.outputs[0] else add_t.inputs[1]
            out_v = add_t.outputs[0]

            def attn_back(env, lp):
                q = env[q_in]
                k_new, v_new = env[k_in], env[v_in]
                ks, env_li = env[kc_in]
                vs, _ = env[vc_in]
                lengths = env[len_in]
                li_ = cache_li(env_li)
                partial = fused_attn_back(q, k_new, v_new, ks[li_], vs[li_], lengths, lp[wo_p])
                env[out_v] = env[resid_in] + attn_all_reduce(partial, q.dtype)
                if cu_t is not None:
                    at = _append_at(env, len_in, ks.shape[3])
                    _write_rows(ks, li_, k_new, at)
                    _write_rows(vs, li_, v_new, at)
                    env[cu_t.outputs[0]] = (ks, li_)
                    env[cu_t.outputs[1]] = (vs, li_)
            # The JAX package's executor names, so the plans compare equal.
            attn_back.__name__ = "fused_attn_back_ex" if gname == "attn_back" else "fused_attn_sweep_ex"
            return attn_back

        if gname == "moe_block":
            # [moe(xn, router, wg, wu, wd)]: the routing, dispatch and the
            # fp32 weighted combine as TP_MoE does them, the routed experts
            # in ONE fused_moe_block call (h never leaves the kernel), the
            # combine all-reduced in fp32, then one cast.
            moe_t = group[0]
            x_in, out_v = moe_t.inputs[0], moe_t.outputs[0]
            r_p, g_p, u_p, d_p = (param(i) for i in moe_t.inputs[1:])

            def fused_moe_ex(env, lp):
                x = env[x_in]
                tkn = x.shape[0]
                n_e = lp[r_p].shape[1]
                idx, wts = topk_routing(matmul_f32(x, lp[r_p]), c.top_k)
                plan = make_routing_plan(idx, n_e, capacity_for(tkn, c.top_k, n_e, MOE_CAPACITY_FACTOR))
                y = fused_moe_block(dispatch(x, plan), lp[g_p], lp[u_p], lp[d_p])
                env[out_v] = fp32_all_reduce(combine(y, plan, wts, tkn, out_dtype=torch.float32), x.dtype)
            return fused_moe_ex

        if gname == "mlp_block":
            # [rmsnorm(x1, ln), linear(·, wg, wu), swiglu, linear(·, wd)]
            ln_t, gu_t, _, dn_t = group
            x_in, ln_p = ln_t.inputs[0], param(ln_t.inputs[1])
            g_p, u_p = param(gu_t.inputs[1]), param(gu_t.inputs[2])
            d_p = param(dn_t.inputs[1])
            out_v = dn_t.outputs[0]

            def fused_mlp(env, lp):
                env[out_v] = fused_mlp_block(env[x_in], lp[ln_p], lp[g_p], lp[u_p], lp[d_p], eps=eps)
            return fused_mlp

        # ----- standalone lowerings (unmatched tasks) -----
        task = group[0]
        op = task.op

        if op == "rmsnorm":
            def standalone_rmsnorm(env, lp, t=task):
                x = env[t.inputs[0]]
                env[t.outputs[0]] = rmsnorm(x, lp[param(t.inputs[1])], eps)
            return standalone_rmsnorm

        if op == "linear":
            def standalone_linear(env, lp, t=task):
                x = env[t.inputs[0]]
                outs = [matmul_f32(x, lp[param(i)]).to(x.dtype) for i in t.inputs[1:]]
                env[t.outputs[0]] = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
            return standalone_linear

        if op == "head_norm":
            def standalone_head_norm(env, lp, t=task):
                qkv = env[t.inputs[0]]
                b = qkv.shape[0]
                h3 = qkv.reshape(b, hq + 2 * hkv, hd)
                q = rmsnorm(h3[:, :hq], lp[param(t.inputs[1])], eps)
                k = rmsnorm(h3[:, hq:hq + hkv], lp[param(t.inputs[2])], eps)
                env[t.outputs[0]] = torch.cat([q, k, h3[:, hq + hkv:]], dim=1).reshape(b, -1)
            return standalone_head_norm

        if op == "rope":
            def standalone_rope(env, lp, t=task):
                qkv = env[t.inputs[0]]
                b = qkv.shape[0]
                pos = env[t.inputs[1]]
                h3 = qkv.reshape(b, hq + 2 * hkv, hd)
                env[t.outputs[0]] = apply_rope(h3[:, :hq], pos, c.rope_theta)
                env[t.outputs[1]] = apply_rope(h3[:, hq:hq + hkv], pos, c.rope_theta)
                env[t.outputs[2]] = h3[:, hq + hkv:].contiguous()
            return standalone_rope

        if op == "cache_update" and self.paged:
            def standalone_cache_update_paged(env, lp, t=task):
                k_new, v_new = env[t.inputs[0]], env[t.inputs[1]]
                pk, env_li = env[t.inputs[2]]
                pv, _ = env[t.inputs[3]]
                li_ = cache_li(env_li)
                at = _paged_at(env, t.inputs[4], t.inputs[5], t.inputs[6], pk.shape[3])
                write_pool_rows(pk, pv, li_, k_new, v_new, at)
                env[t.outputs[0]] = (pk, li_)
                env[t.outputs[1]] = (pv, li_)
            return standalone_cache_update_paged

        if op == "cache_update":
            def standalone_cache_update(env, lp, t=task):
                k_new, v_new = env[t.inputs[0]], env[t.inputs[1]]
                ks, env_li = env[t.inputs[2]]
                vs, _ = env[t.inputs[3]]
                li_ = cache_li(env_li)
                at = _append_at(env, t.inputs[4], ks.shape[3])
                _write_rows(ks, li_, k_new, at)
                _write_rows(vs, li_, v_new, at)
                env[t.outputs[0]] = (ks, li_)
                env[t.outputs[1]] = (vs, li_)
            return standalone_cache_update

        if op == "flash_decode" and self.paged:
            def standalone_paged_flash_decode(env, lp, t=task):
                # The cache_update task already wrote the new rows; walk
                # lengths + active keys.
                q = env[t.inputs[0]]
                pk, env_li = env[t.inputs[1]]
                pv, _ = env[t.inputs[2]]
                lengths, active, tables = (env[i] for i in t.inputs[3:6])
                li_ = cache_li(env_li)
                out = paged_flash_decode(q, pk[li_], pv[li_], tables, lengths + active.to(lengths.dtype))
                env[t.outputs[0]] = out.reshape(q.shape[0], hq * hd)
            return standalone_paged_flash_decode

        if op == "flash_decode":
            def standalone_flash_decode(env, lp, t=task):
                q = env[t.inputs[0]]
                ks, env_li = env[t.inputs[1]]
                vs, _ = env[t.inputs[2]]
                lengths = env[t.inputs[3]]
                li_ = cache_li(env_li)
                env[t.outputs[0]] = flash_decode(q, ks[li_], vs[li_], lengths + 1).reshape(q.shape[0], hq * hd)
            return standalone_flash_decode

        if op == "flash_decode_append":
            def standalone_flash_decode_append(env, lp, t=task):
                # Append-then-attend on a COPY of the layer's cache: the
                # oracle for the fused sweep's splice (the real append stays
                # the cache_update task's job).
                q = env[t.inputs[0]]
                k_new, v_new = env[t.inputs[1]], env[t.inputs[2]]
                ks, env_li = env[t.inputs[3]]
                vs, _ = env[t.inputs[4]]
                lengths = env[t.inputs[5]]
                li_ = cache_li(env_li)
                kl, vl = ks[li_:li_ + 1].clone(), vs[li_:li_ + 1].clone()
                at = _append_at(env, t.inputs[5], ks.shape[3])
                _write_rows(kl, 0, k_new, at)
                _write_rows(vl, 0, v_new, at)
                env[t.outputs[0]] = flash_decode(q, kl[0], vl[0], lengths + 1).reshape(q.shape[0], hq * hd)
            return standalone_flash_decode_append

        if op == "linear_allreduce":
            def standalone_linear_ar(env, lp, t=task):
                # The fp32-accumulated product, cast; all-reduced by the AUTO
                # route of gemm_ar_shard at world > 1.
                x, w = env[t.inputs[0]], lp[param(t.inputs[1])]
                env[t.outputs[0]] = gemm_ar_shard(ctx, x, w) if world > 1 else matmul_f32(x, w).to(x.dtype)
            return standalone_linear_ar

        if op == "add":
            def standalone_add(env, lp, t=task):
                env[t.outputs[0]] = env[t.inputs[0]] + env[t.inputs[1]]
            return standalone_add

        if op == "swiglu":
            def standalone_swiglu(env, lp, t=task):
                gu = env[t.inputs[0]]
                g, u = gu.float().chunk(2, dim=-1)
                env[t.outputs[0]] = (torch.nn.functional.silu(g) * u).to(gu.dtype)
            return standalone_swiglu

        if op == "allreduce":
            def standalone_allreduce(env, lp, t=task):
                x = env[t.inputs[0]]
                env[t.outputs[0]] = fp32_all_reduce(x, x.dtype)
            return standalone_allreduce

        if op == "moe":
            def standalone_moe(env, lp, t=task):
                # The jit-level TP_MoE lowering, in its dist_ar mode.
                moe = TP_MoE(*(lp[param(i)] for i in t.inputs[1:]), top_k=c.top_k, ctx=ctx)
                env[t.outputs[0]] = moe(env[t.inputs[0]], mode="dist_ar")
            return standalone_moe

        raise NotImplementedError(f"no lowering for task op {op!r}")

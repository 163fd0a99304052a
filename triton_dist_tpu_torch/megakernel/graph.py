"""Model-as-task-graph: tasks, dependencies, fusion-group scheduling.

A copy of ``triton_dist_tpu/megakernel/graph.py`` with the same behaviour
(the port imports nothing of the JAX package, not even this jax-free
module). A decode step is recorded as a list of ``Task``s; ``schedule``
merges tasks into the known fusable chains (``FUSABLE_CHAINS``), each of
which ``megakernel/builder.py`` lowers to one fused kernel wrapper, and
everything else lowers to its standalone op.

Scheduling policies:

* ``"static"`` / ``"cost"`` — linear scan over the builder's append order
  (a single layer's tasks are already a topological line); ``"cost"``
  fuses a chain only when the builder's traffic model says fusing saves at
  least ``COST_FUSE_THRESHOLD`` of the group's memory traffic.
* ``"scoreboard"`` — dependency-driven emission: a task becomes runnable
  when its producer tasks have retired, emission walks a Kahn ready set,
  and chains are matched along the dataflow rather than list adjacency.
  ``DEFERRABLE_OPS`` (the cache scatter) yield to any other ready task, so
  layer N's scatter is emitted after layer N+1's attention front.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Task:
    """One op node (reference TaskBuilder output)."""

    name: str
    op: str  # "rmsnorm" | "linear" | "rope" | "cache_update" | ...
    inputs: tuple[str, ...]
    outputs: tuple[str, ...]
    group: str | None = None  # fusion group id assigned by the scheduler
    pinned: bool = False  # pinned tasks never fuse (scheduler override)
    # Producer-task names this task waits on (the scoreboard's dependency
    # row). ``TaskGraph.add`` merges the dataflow-derived producers into
    # whatever the builder passed explicitly (explicit entries express
    # ordering constraints the value names alone don't, e.g. an audit pin).
    deps: tuple[str, ...] = ()


# Minimum modeled fraction of a group's memory traffic that fusion must
# save (intermediates kept on chip) for the "cost" policy to emit the fused
# kernel; the same threshold as the JAX package, so both packages take the
# same decisions. At batch 8 the attention front models ~2.8 % saved and
# the MLP block ~0.7 %; at batch 1 every chain models < 0.4 %.
COST_FUSE_THRESHOLD = 0.005

# Ops the scoreboard defers while other work is ready: the cache scatter
# is off every consumer's critical path within its own layer (the fused
# sweep splices the new token in itself), so emitting it late lets the
# next layer's attn-front start first.
DEFERRABLE_OPS = frozenset({"cache_update"})

# Chains the builder knows how to fuse into one kernel wrapper, checked in
# order (longest first).
FUSABLE_CHAINS = (
    (("rmsnorm", "linear", "head_norm", "rope"), "attn_front"),
    (("cache_update", "flash_decode", "linear_allreduce", "add"), "attn_back"),
    # The serving step graph splits the attention back-leg: the sweep
    # (in-kernel append + online softmax + o-proj partial) fuses here while
    # the cache scatter stays a separate, deferrable task.
    (("flash_decode_append", "linear_allreduce", "add"), "attn_sweep"),
    (("rmsnorm", "linear", "swiglu", "linear"), "mlp_block"),
    # Length-1 "chain": the moe task's fused routed-experts lowering (not
    # ported yet: the builder raises for it).
    (("moe",), "moe_block"),
)


class TaskGraph:
    """Append-only task list + dependency validation + fusion scheduling."""

    def __init__(self):
        self.tasks: list[Task] = []
        self._producers: dict[str, str] = {}
        self._names: set[str] = set()
        self._last_schedule_args = ("static", None)
        #: Stats of the last ``schedule`` run (task/group counts, fusion
        #: hits, peak ready-set depth).
        self.stats: dict[str, float] = {}

    def pin_standalone(self, name: str) -> None:
        """Exclude a task from fusion (scheduler override): any chain window
        containing it falls apart into standalone lowerings. The audit knob
        that makes the graph load-bearing — pinning observably changes the
        generated kernel sequence without changing semantics."""
        for t in self.tasks:
            if t.name == name:
                t.pinned = True
                return
        raise KeyError(f"no task named {name!r}")

    def add(self, task: Task) -> Task:
        if task.name in self._names:
            raise ValueError(f"task name {task.name!r} already recorded")
        for out in task.outputs:
            if out in self._producers:
                raise ValueError(f"value {out!r} already produced by {self._producers[out]!r}")
        for inp in task.inputs:
            if inp not in self._producers and not inp.startswith(("param:", "input:")):
                raise ValueError(f"task {task.name!r} consumes unproduced value {inp!r}")
        for dep in task.deps:
            if dep not in self._names:
                raise ValueError(f"task {task.name!r} declares dep on unknown task {dep!r}")
        derived = [self._producers[i] for i in task.inputs if i in self._producers]
        task.deps = tuple(dict.fromkeys((*task.deps, *derived)))
        for out in task.outputs:
            self._producers[out] = task.name
        self._names.add(task.name)
        self.tasks.append(task)
        return task

    def schedule(self, policy: str = "static", cost_fn=None) -> list[list[Task]]:
        """Fusion grouping: merge tasks into maximal chains matching
        FUSABLE_CHAINS; each group becomes one generated kernel. Returns the
        grouped schedule (in emission order) and stamps task.group.

        ``policy`` decides WHICH chains become fused kernels and in WHAT
        ORDER the groups are emitted:

        * ``"static"`` — linear scan of the append order; fuse every
          matching chain (the generated kernels are measured wins in the
          decode regime).
        * ``"cost"`` — linear scan; fuse a chain only when
          ``cost_fn(gname, window)`` (a modeled fraction of the group's
          memory traffic saved by keeping intermediates on chip) clears
          ``COST_FUSE_THRESHOLD``; below it the tasks lower standalone.
          ``ModelBuilder`` supplies the cost model from its config.
        * ``"scoreboard"`` — dependency-driven emission (reference
          scoreboard model): walk the ready set, match chains along the
          dataflow, defer ``DEFERRABLE_OPS`` while other work is ready so
          adjacent layers' independent groups interleave. Fuses every
          matching chain like "static" (the cost gate stays the "cost"
          policy's job); ``ModelBuilder``'s default.
        """
        if policy not in ("static", "cost", "scoreboard"):
            raise ValueError(f"unknown schedule policy {policy!r}")
        if policy == "cost" and cost_fn is None:
            raise ValueError(
                "schedule(policy='cost') needs a cost_fn — use ModelBuilder"
                "(schedule_policy='cost'), which supplies its traffic model")
        # summary() must report THIS schedule, not re-derive a static one.
        self._last_schedule_args = (policy, cost_fn)

        def fuse_ok(gname, window):
            if policy != "cost":
                return True
            return cost_fn(gname, window) >= COST_FUSE_THRESHOLD

        if policy == "scoreboard":
            groups = self._schedule_scoreboard(fuse_ok)
        else:
            groups = self._schedule_linear(fuse_ok)
        fusion_hits = sum(1 for g in groups if g[0].group.split(":")[0] in
                          {gn for _, gn in FUSABLE_CHAINS})
        self.stats.update(
            policy=policy, tasks=len(self.tasks), groups=len(groups),
            fusion_hits=fusion_hits,
        )
        self.stats.setdefault("max_ready_depth", 1)
        return groups

    def _schedule_linear(self, fuse_ok) -> list[list[Task]]:
        """Append-order scan (the builders append in dependency order, so a
        single layer's task list is already a topological line)."""
        self.stats = {"max_ready_depth": 1}
        groups: list[list[Task]] = []
        i = 0
        gid = 0
        while i < len(self.tasks):
            matched = False
            for ops, gname in FUSABLE_CHAINS:
                window = self.tasks[i : i + len(ops)]
                if len(window) == len(ops) and all(
                    t.op == o and not t.pinned for t, o in zip(window, ops)
                ):
                    # The chain must be a straight line: each task feeds the
                    # next.
                    chained = all(
                        set(window[j].outputs) & set(window[j + 1].inputs)
                        for j in range(len(window) - 1)
                    )
                    if chained and fuse_ok(gname, window):
                        g = f"{gname}:{gid}"
                        for t in window:
                            t.group = g
                        groups.append(window)
                        i += len(ops)
                        gid += 1
                        matched = True
                        break
            if not matched:
                t = self.tasks[i]
                t.group = f"{t.op}:{gid}"
                groups.append([t])
                i += 1
                gid += 1
        return groups

    def _schedule_scoreboard(self, fuse_ok) -> list[list[Task]]:
        """Kahn ready-set emission over ``Task.deps`` with dataflow-driven
        chain matching. Ties in the ready set break by append order
        (deterministic: the same graph always gives the same plan), except
        that DEFERRABLE_OPS yield to any other ready task."""
        by_name = {t.name: t for t in self.tasks}
        order = {t.name: i for i, t in enumerate(self.tasks)}
        indeg = {t.name: len(t.deps) for t in self.tasks}
        consumers: dict[str, list[str]] = {t.name: [] for t in self.tasks}
        for t in self.tasks:
            for d in t.deps:
                consumers[d].append(t.name)
        for lst in consumers.values():
            lst.sort(key=order.__getitem__)

        emitted: set[str] = set()

        def grow_chain(head: Task):
            """Try to grow a fusable chain from ``head`` along the dataflow:
            each next link is a direct consumer of the previous link whose
            other producers have all retired (or sit earlier in the same
            window) — the fused kernel must be runnable as one unit."""
            if head.pinned:
                return None, None
            for ops, gname in FUSABLE_CHAINS:
                if head.op != ops[0]:
                    continue
                window = [head]
                names = {head.name}
                ok = True
                for nxt_op in ops[1:]:
                    prev = window[-1]
                    cand = None
                    for cn in consumers[prev.name]:
                        ct = by_name[cn]
                        if (ct.op != nxt_op or ct.pinned or ct.name in emitted
                                or not (set(prev.outputs) & set(ct.inputs))):
                            continue
                        if all(d in emitted or d in names for d in ct.deps):
                            cand = ct
                            break
                    if cand is None:
                        ok = False
                        break
                    window.append(cand)
                    names.add(cand.name)
                if ok and fuse_ok(gname, window):
                    return window, gname
            return None, None

        ready = sorted((t for t in self.tasks if indeg[t.name] == 0),
                       key=lambda t: order[t.name])
        groups: list[list[Task]] = []
        gid = 0
        max_ready = 0
        while ready:
            max_ready = max(max_ready, len(ready))
            head = ready[0]
            if head.op in DEFERRABLE_OPS and len(ready) > 1:
                head = ready[1]
            window, gname = grow_chain(head)
            if window is not None:
                g = f"{gname}:{gid}"
                for t in window:
                    t.group = g
            else:
                window = [head]
                head.group = f"{head.op}:{gid}"
            groups.append(window)
            gid += 1
            for t in window:
                emitted.add(t.name)
            released: list[Task] = []
            for t in window:
                for cn in consumers[t.name]:
                    if cn in emitted:
                        continue
                    indeg[cn] -= 1
                    if indeg[cn] == 0:
                        released.append(by_name[cn])
            ready = [r for r in ready if r.name not in emitted]
            ready.extend(r for r in released if r not in ready)
            ready.sort(key=lambda t: order[t.name])
        if len(emitted) != len(self.tasks):
            stuck = [t.name for t in self.tasks if t.name not in emitted]
            raise ValueError(
                f"scoreboard schedule never released {stuck!r} — dependency "
                "cycle or a dep on a task that was never recorded")
        self.stats = {"max_ready_depth": max_ready}
        return groups

    def summary(self) -> str:
        # Re-derives the LAST-built schedule (policy + cost model), so the
        # audit trail matches what was actually lowered.
        policy, cost_fn = self._last_schedule_args
        lines = []
        for g in self.schedule(policy=policy, cost_fn=cost_fn):
            ops = "+".join(t.op for t in g)
            lines.append(f"[{g[0].group}] {ops}")
        return "\n".join(lines)

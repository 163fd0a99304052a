"""Ranks and the plain collectives: counterpart of
``triton_dist_tpu/runtime/mesh.py`` (``DistContext``,
``initialize_distributed``).

JAX runs one program over a device mesh; here every rank is its own
process, as the reference's torchrun ranks are. ``initialize_distributed``
joins a ``gloo`` group (host bootstrap only: handle exchange, host
barriers, and the collectives of CPU tensors) and, on CUDA, maps the rank's
symmetric heap (``shmem/symm.py``). Rank r takes card ``r %
torch.cuda.device_count()``, so four ranks may own four cards or share one.
No NCCL is used.

A context may carry named axes, laid out as JAX's ``_build_mesh`` lays
devices out (a row-major reshape, ``triton_dist_tpu/runtime/mesh.py:95-107``):
at ``("pp", "tp")`` of ``(2, 2)`` global rank r sits at ``pp = r // 2``,
``tp = r % 2``. ``ctx.axis(name)`` is then a one-axis context over the
ranks that differ from this one along that axis alone, with its own
``gloo`` subgroup and, on CUDA, its own heap (its own barrier pads, flags,
epoch, plain slot and workspaces: a rank in two groups must not read one
group's signal as the other's). Every function here runs over the ranks of
the context it is given.

``all_gather``, ``psum``, ``psum_scatter``, ``all_to_all``, ``ppermute``
and ``ring_ag_chunks`` stand in for XLA's collectives (the ``xla`` mode,
the small-M routes of the collective matmuls, the expert-parallel
all-to-all's plain transport and the training rings' KV rotation). CPU
tensors go through ``gloo``. CUDA tensors go
through the heap: copy into this rank's plain slot, the barrier kernel,
copies from every rank's slot, the barrier again. ``psum`` adds the parts
in rank order 0..world-1, so every rank holds the same bits.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.runtime.platform import resolve_device
from triton_dist_tpu_torch.shmem.symm import PLAIN_BYTES, SymmHeap


@dataclasses.dataclass
class DistContext:
    """One rank's handle on a group of ranks: ``rank``, ``world``, its
    ``device``, the ``gloo`` ``group`` and, on CUDA, its ``heap``. A context
    of one axis (``axis_names``, by default the tensor-parallel ``("tp",)``)
    is that axis; a context of several (``split_axes``) spans all of them
    and holds one context per axis in ``axes``."""

    rank: int
    world: int
    device: torch.device
    group: object = None
    heap: SymmHeap | None = None
    axis_names: tuple[str, ...] = ("tp",)
    axes: dict[str, "DistContext"] = dataclasses.field(default_factory=dict)

    def axis(self, name: str) -> "DistContext":
        """The one-axis context of axis ``name`` (this context when it is its
        only axis)."""
        if name in self.axes:
            return self.axes[name]
        if self.axis_names == (name,):
            return self
        raise KeyError(f"no mesh axis {name!r} in {self.axis_names}")

    def on_cpu(self) -> "DistContext":
        """The same ranks and groups with CPU tensors (plain versions)."""
        return DistContext(self.rank, self.world, torch.device("cpu"), self.group, None, self.axis_names,
                           {n: a.on_cpu() for n, a in self.axes.items()})

    def check_status(self) -> None:
        """Raise ``CollectiveAbort`` if a device-side wait of this rank
        expired, on any of its axes (waits for the card); nothing on the
        CPU."""
        if self.heap is not None:
            self.heap.check()
        for a in self.axes.values():
            a.check_status()

    def host_barrier(self) -> None:
        """A ``gloo`` barrier of the host processes."""
        import torch.distributed as dist

        dist.barrier(group=self.group)


def initialize_distributed(rank: int, world: int, init_method: str,
                           device: str | torch.device | None = None, *,
                           axis_names: tuple[str, ...] = ("tp",),
                           axis_sizes: tuple[int, ...] | None = None) -> DistContext:
    """Join the group of ``world`` ranks at ``init_method`` (for instance
    ``tcp://localhost:<port>`` or ``file://<path>``) as ``rank``. ``device``
    None means CUDA card ``rank % device_count`` (raises without CUDA);
    ``"cpu"`` runs the plain versions. More than one of ``axis_names``
    (with ``axis_sizes``, whose product is ``world``) lays the ranks out
    over those axes (``split_axes``)."""
    import torch.distributed as dist

    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        resolve_device(device)  # raises without CUDA
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
    group = dist.group.WORLD
    heap = SymmHeap(rank, world, dev, group) if dev.type == "cuda" else None
    ctx = DistContext(rank, world, dev, group, heap, tuple(axis_names[:1]))
    return ctx if len(axis_names) == 1 else split_axes(ctx, axis_names, axis_sizes)


def split_axes(ctx: DistContext, axis_names: tuple[str, ...], axis_sizes: tuple[int, ...]) -> DistContext:
    """``ctx``'s ranks laid out row-major over named axes (JAX
    ``_build_mesh``): a context over all of them whose ``axes`` hold one
    context per axis, each with its own ``gloo`` subgroup and, on CUDA, its
    own heap. Every rank of ``ctx`` calls it with the same arguments (the
    subgroups are made collectively, in one order). One axis: ``ctx``'s
    group and heap under that name."""
    import math

    import torch.distributed as dist

    names, sizes = tuple(axis_names), tuple(int(n) for n in axis_sizes)
    if len(names) != len(sizes) or len(set(names)) != len(names):
        raise ValueError(f"axis names {names} and sizes {sizes} do not pair up")
    if math.prod(sizes) != ctx.world:
        raise ValueError(f"axis sizes {sizes} do not multiply to the world {ctx.world}")
    if len(names) == 1:
        return DistContext(ctx.rank, ctx.world, ctx.device, ctx.group, ctx.heap, names)
    if ctx.world != dist.get_world_size():
        raise ValueError("split_axes lays out the whole process group (initialize_distributed's context)")
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    coord = [(ctx.rank // st) % n for st, n in zip(strides, sizes)]
    axes = {}
    for a, name in enumerate(names):
        for base in range(ctx.world):
            if (base // strides[a]) % sizes[a]:
                continue  # each group once, from its member at coordinate 0
            ranks = [base + i * strides[a] for i in range(sizes[a])]
            group = dist.new_group(ranks=ranks, backend="gloo")
            if ctx.rank in ranks:
                mine, my_ranks = group, ranks
        heap = None
        if ctx.device.type == "cuda":
            heap = SymmHeap(coord[a], sizes[a], ctx.device, mine, axis=name, global_ranks=my_ranks)
        axes[name] = DistContext(coord[a], sizes[a], ctx.device, mine, heap, (name,))
    return DistContext(ctx.rank, ctx.world, ctx.device, ctx.group, ctx.heap, names, axes)


def close(ctx: DistContext) -> None:
    """Free the heaps of ``ctx`` and of its axes (after a synchronize); the
    CPU has none."""
    for a in ctx.axes.values():
        close(a)
    if ctx.heap is not None:
        ctx.heap.close()


def _parts(ctx: DistContext, x: torch.Tensor, rows: tuple[int, int] | None = None) -> torch.Tensor:
    """(world, *shape) stack of every rank's ``x`` (rows ``[lo, hi)`` of
    dim 0 only, when given), in rank order."""
    x = x.contiguous()
    lo, hi = rows if rows is not None else (0, x.shape[0])
    if ctx.device.type == "cpu":
        import torch.distributed as dist

        parts = [torch.empty_like(x) for _ in range(ctx.world)]
        dist.all_gather(parts, x, group=ctx.group)
        return torch.stack([p[lo:hi] for p in parts])
    if x.device != ctx.device:
        raise ValueError(f"tensor on {x.device}, context on {ctx.device}")
    from triton_dist_tpu_torch.kernels.common_ops import barrier_all_on_device

    heap = ctx.heap
    nbytes = x.numel() * x.element_size()
    if nbytes > PLAIN_BYTES:
        raise ValueError(f"a {nbytes}-byte tensor exceeds the heap's plain slot ({PLAIN_BYTES} bytes)")
    row_bytes = nbytes // max(x.shape[0], 1)
    out = torch.empty((ctx.world, hi - lo, *x.shape[1:]), dtype=x.dtype, device=x.device)
    heap.copy(heap.ptr(heap.plain_off), x.data_ptr(), nbytes)
    barrier_all_on_device(ctx)
    for r in range(ctx.world):
        heap.copy(out[r].data_ptr(), heap.ptr(heap.plain_off, r) + lo * row_bytes, (hi - lo) * row_bytes)
    barrier_all_on_device(ctx)
    return out


def _ordered_sum(parts: torch.Tensor) -> torch.Tensor:
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out


def all_gather(ctx: DistContext, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order
    (``lax.all_gather(..., tiled=True)``)."""
    return torch.cat(tuple(_parts(ctx, x)), dim=dim)


def psum(ctx: DistContext, x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``x``, added in rank order. On CUDA a tensor
    larger than the plain slot goes in pieces along dim 0."""
    nbytes = x.numel() * x.element_size()
    if ctx.device.type == "cuda" and nbytes > PLAIN_BYTES and x.dim() > 0 and x.shape[0] > 1:
        step = max(1, PLAIN_BYTES // (nbytes // x.shape[0]))
        return torch.cat([psum(ctx, x[i:i + step]) for i in range(0, x.shape[0], step)])
    return _ordered_sum(_parts(ctx, x))


def psum_scatter(ctx: DistContext, x: torch.Tensor) -> torch.Tensor:
    """This rank's row chunk of the sum of every rank's ``x`` (dim 0 split in
    ``world`` equal chunks; ``lax.psum_scatter(..., tiled=True)``), added in
    rank order."""
    m = x.shape[0]
    if m % ctx.world:
        raise ValueError(f"{m} rows do not split over {ctx.world} ranks")
    c = m // ctx.world
    return _ordered_sum(_parts(ctx, x, (ctx.rank * c, (ctx.rank + 1) * c)))


def all_to_all(ctx: DistContext, x: torch.Tensor) -> torch.Tensor:
    """Exchange per-peer chunks: x (world, chunk, ...) with ``x[p]`` bound for
    rank p; returns ``out`` of the same shape with ``out[p]`` = rank p's
    ``x[me]`` (``lax.all_to_all(x, axis, 0, 0, tiled=False)``). Any dtype: it
    moves bytes. On CUDA a call larger than the plain slot goes in pieces
    along the chunk dimension, each a round of publish, barrier, copy,
    barrier."""
    if x.dim() < 2 or x.shape[0] != ctx.world:
        raise ValueError(f"all_to_all needs ({ctx.world}, chunk, ...), got {tuple(x.shape)}")
    if ctx.device.type == "cpu":
        return _parts(ctx, x, (ctx.rank, ctx.rank + 1))[:, 0].clone()
    if x.device != ctx.device:
        raise ValueError(f"tensor on {x.device}, context on {ctx.device}")
    from triton_dist_tpu_torch.kernels.common_ops import barrier_all_on_device

    heap, w, me = ctx.heap, ctx.world, ctx.rank
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    chunk = x.shape[1]
    row_bytes = x[0, 0].numel() * x.element_size()
    step = PLAIN_BYTES // max(w * row_bytes, 1)
    if step < 1:
        raise ValueError(f"all_to_all: one row of {row_bytes} bytes per rank exceeds the plain slot "
                         f"({PLAIN_BYTES} bytes)")
    for c0 in range(0, chunk, step):
        c1 = min(chunk, c0 + step)
        piece = x[:, c0:c1].contiguous()
        nbytes = (c1 - c0) * row_bytes
        heap.copy(heap.ptr(heap.plain_off), piece.data_ptr(), w * nbytes)
        barrier_all_on_device(ctx)
        for r in range(w):
            heap.copy(out[r, c0:c1].data_ptr(), heap.ptr(heap.plain_off, r) + me * nbytes, nbytes)
        barrier_all_on_device(ctx)
    return out


def ppermute(ctx: DistContext, x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """Shift along the ring: rank r receives rank ``(r - shift) % world``'s
    ``x`` (``lax.ppermute`` with the pairs ``(i, (i + shift) % world)``).
    Every rank's ``x`` has one shape; it goes through one gather."""
    return _parts(ctx, x)[(ctx.rank - shift) % ctx.world].clone()


def ring_ag_chunks(ctx: DistContext, x: torch.Tensor):
    """Every rank's ``x`` in the ring's order: step s yields rank ``(rank -
    s) % world``'s (step 0 is this rank's own), as JAX's ``ring_ag_chunks``
    does; all chunks come from one gather here."""
    parts = _parts(ctx, x)
    for s in range(ctx.world):
        yield parts[(ctx.rank - s) % ctx.world]


def ring_ag_concat(ctx: DistContext, parts: list[torch.Tensor]) -> torch.Tensor:
    """Per-step ring results (``parts[s]`` belongs to rank ``(rank - s) %
    world``) stacked back in rank order."""
    order = [(ctx.rank - s) % ctx.world for s in range(ctx.world)]
    by_rank = [None] * ctx.world
    for s, src in enumerate(order):
        by_rank[src] = parts[s]
    return torch.cat(by_rank, dim=0)

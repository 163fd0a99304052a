"""The device barrier: counterpart of ``barrier_all_on_device`` in
``triton_dist_tpu/kernels/common_ops.py`` (its TPU kernel at ``:29``).

On a CUDA context it launches ``barrier_kernel`` (``csrc/shmem.cu``): one
block whose thread r signals rank r's pad and waits, bounded, for rank r's
signal on its own. On a CPU context its plain version is the ``gloo``
barrier. ``copy_tensor_shard`` is not ported (ROADMAP queue 2, row 24).
"""

from __future__ import annotations

import ctypes


def barrier_all_on_device(ctx) -> None:
    """A barrier over the ranks of ``ctx`` (``runtime.mesh.DistContext``),
    on the card's current stream: no rank's later work on the stream starts
    before every rank's earlier work has."""
    if ctx.device.type == "cpu":
        import torch.distributed as dist

        dist.barrier(group=ctx.group)
        return
    from triton_dist_tpu_torch.kernels import _build

    heap = ctx.heap
    code = heap._lib.tdt_barrier(*heap.args(heap.next_epoch()), ctypes.c_uint64(heap.barrier_off),
                                 _build.stream_ptr(ctx.device))
    heap._check(code, "barrier_all_on_device")
    barrier_all_on_device.launches += 1


#: Kernel launches so far (CUDA contexts only).
barrier_all_on_device.launches = 0

"""Pipeline-parallel communication layer: counterpart of
``triton_dist_tpu/layers/pp.py`` (``PPCommLayer``).

The stage handoff is a ring shift over the ``pp`` axis of a mesh context:
``send_next`` pushes to stage + 1 and returns what stage - 1 pushed,
``send_prev`` the reverse (the backward pass's direction). The backend
names are JAX's: ``"pallas"`` is the one-sided kernel (row 23,
``kernels/p2p.py``), ``"xla"`` the plain collective (``mesh.ppermute``). The
microbatch schedule lives in ``layers/pp_schedule.py``; this layer is only
the transport, as in JAX.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.kernels.p2p import p2p_put_shard


@dataclasses.dataclass(frozen=True)
class PPCommLayer:
    """Transport between adjacent stages of ``ctx``'s ``axis``
    (``runtime.mesh.DistContext``). ``backend``: "pallas" (the one-sided
    kernel on CUDA tensors, its plain version on CPU tensors) or "xla" (the
    plain collective)."""

    ctx: object
    axis: str = "pp"
    backend: str = "pallas"

    def __post_init__(self):
        if self.backend not in ("pallas", "xla"):
            raise ValueError(f"unknown backend {self.backend!r}; expected 'pallas' or 'xla'")

    def send_next(self, x: torch.Tensor) -> torch.Tensor:
        """Push activations to stage + 1; returns what stage - 1 pushed
        (ring semantics: stage 0 receives the last stage's output, which
        the schedules ignore). Differentiable."""
        return p2p_put_shard(self.ctx, x, self.axis, 1, self.backend == "xla")

    def send_prev(self, x: torch.Tensor) -> torch.Tensor:
        """The backward pass's direction (gradients to stage - 1)."""
        return p2p_put_shard(self.ctx, x, self.axis, -1, self.backend == "xla")

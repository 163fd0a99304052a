"""The symmetric heap: counterpart of ``triton_dist_tpu/shmem/symm.py``
(``symm_zeros``) and of the host side of ``shmem/kernel.py`` (the status
buffer and ``consume_status``).

On the TPU a symmetric buffer is a mesh-sharded array and XLA places it.
Here every rank ``cudaMalloc``s one heap of ``HEAP_BYTES`` at start, exports
it as a CUDA IPC handle and opens every other rank's (``csrc/shmem.cu``),
so a kernel reaches a peer's copy of a buffer at the same offset in that
peer's heap. The handles travel over the ``gloo`` group, which carries
only host bootstrap; no NCCL is involved.

Regions are handed out by a bump allocator, and every rank must make the
same allocations in the same order: ``SymmHeap.alloc`` checks over
``gloo`` that all ranks got the same offset. The layout, from the start:

* the barrier pads: one ``uint64`` per source rank;
* the signal pads, twice (one half per parity of the call's epoch): one
  ``uint64`` per (phase, source rank, slot), ``MAX_WORLD`` sources and
  ``MAX_SLOTS`` slots (output tiles) per phase;
* the plain slot (``PLAIN_BYTES``): where the plain CUDA collectives of
  ``runtime/mesh.py`` publish a rank's tensor;
* the kernel workspace, twice (``WS_BYTES`` each), by epoch parity.

Every collective call advances the context's epoch, the same on every rank,
and signals carry it, so no pad is ever reset. The status word (code,
phase, peer, epoch of the first expired wait) is this rank's alone; the
engine reads it where it already waits for the card (after sampling) and
``check`` raises ``CollectiveAbort`` naming the phase and the peer.
"""

from __future__ import annotations

import ctypes

import torch

#: Largest world the kernels take, and signal slots per (phase, source).
MAX_WORLD = 8
MAX_SLOTS = 1024
FLAG_PHASES = 2
FLAG_BYTES = FLAG_PHASES * MAX_WORLD * MAX_SLOTS * 8
#: Sized for Qwen3-8B (hidden 4096) at world 4 and a prompt of 2048 tokens
#: in bf16. The largest workspace is the fused GEMM-AR's on the down
#: projection: fp32 partials of (world, 2048 / world, 4096), 32 MiB, plus
#: the broadcast (2048, 4096) bf16, 16 MiB. The GEMM-RS partials (32 MiB)
#: and the AG-GEMM gather (world, 512, 4096) bf16 (16 MiB) fit in it. The
#: plain slot holds one rank's fp32 (2048, 4096) partial for ``psum``.
WS_BYTES = 48 << 20
PLAIN_BYTES = 32 << 20
ALIGN = 256
#: Bound of every device-side wait, seconds: generous, since four ranks may
#: share one card and then run in turns.
WAIT_TIMEOUT_S = 30.0

#: Phase ids of the status word, in the order of ``csrc/shmem.cuh``.
PHASES = ("barrier", "ag_recv", "rs_recv", "ar_recv", "ar_bcast", "a2a_recv", "ep_dispatch", "ep_combine",
          "ag_kv_recv", "pp_recv")

_SIGNATURES = {
    "tdt_heap_alloc": [ctypes.c_size_t, ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p],
    "tdt_heap_handle_bytes": [],
    "tdt_heap_open": [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)],
    "tdt_heap_close": [ctypes.c_void_p],
    "tdt_heap_free": [ctypes.c_void_p],
    "tdt_copy": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p],
    "tdt_barrier": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
                    ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p],
}


class CollectiveAbort(RuntimeError):
    """A bounded device-side wait expired: the message names the phase, the
    peer rank waited for and the call (epoch)."""


#: Bytes of one rank's heap: the regions above, each aligned.
HEAP_BYTES = -(-8 * MAX_WORLD // ALIGN) * ALIGN + 2 * FLAG_BYTES + PLAIN_BYTES + 2 * WS_BYTES


def library():
    """The loaded ``csrc/shmem.cu``."""
    from triton_dist_tpu_torch.kernels import _build

    return _build.load("shmem", _SIGNATURES)


class SymmHeap:
    """One rank's symmetric heap, mapped into every rank of ``group``.

    ``peers`` is the device table of heap bases as this process maps them
    (int64, one per rank); ``status`` the status word (4 int64). ``epoch``
    counts collective calls; kernels signal with it and read the halves of
    the pads and the workspace of its parity."""

    def __init__(self, rank: int, world: int, device: torch.device, group, *, axis: str | None = None,
                 global_ranks: list[int] | None = None):
        import torch.distributed as dist

        if not 1 <= world <= MAX_WORLD:
            raise ValueError(f"world {world} outside 1..{MAX_WORLD}")
        self.rank, self.world, self.device, self.group = rank, world, device, group
        #: The mesh axis the group spans and the global rank of each of its
        #: ranks (an axis context's heap), for the abort message.
        self.axis, self.global_ranks = axis, global_ranks
        self.nbytes = HEAP_BYTES
        #: Bound of this rank's waits (ns); a test may shorten it.
        self.timeout_ns = int(WAIT_TIMEOUT_S * 1e9)
        self.epoch = 0
        self._lib = lib = library()
        from triton_dist_tpu_torch.kernels import _build

        self._check = lambda code, what: _build.check(lib, code, what)
        handle = ctypes.create_string_buffer(lib.tdt_heap_handle_bytes())
        base = ctypes.c_void_p()
        with torch.cuda.device(device):
            self._check(lib.tdt_heap_alloc(self.nbytes, ctypes.byref(base), handle), "heap alloc")
        self._base = base.value
        handles = [None] * world
        dist.all_gather_object(handles, bytes(handle.raw), group=group)
        self.bases = []
        self._opened = []
        with torch.cuda.device(device):
            for r, h in enumerate(handles):
                if r == rank:
                    self.bases.append(self._base)
                    continue
                p = ctypes.c_void_p()
                self._check(lib.tdt_heap_open(h, ctypes.byref(p)), f"opening rank {r}'s heap")
                self.bases.append(p.value)
                self._opened.append(p.value)
        self.peers = torch.tensor(self.bases, dtype=torch.int64, device=device)
        self.status = torch.zeros(4, dtype=torch.int64, device=device)
        self._next = 0
        self.barrier_off = self.alloc(8 * MAX_WORLD)
        self.flags_off = (self.alloc(FLAG_BYTES), self.alloc(FLAG_BYTES))
        self.plain_off = self.alloc(PLAIN_BYTES)
        self.ws_off = (self.alloc(WS_BYTES), self.alloc(WS_BYTES))

    def alloc(self, nbytes: int) -> int:
        """Offset of a new region of ``nbytes`` (aligned to ``ALIGN``); the
        same on every rank, which is checked over ``gloo``."""
        import torch.distributed as dist

        off = self._next
        end = off + -(-nbytes // ALIGN) * ALIGN
        if end > self.nbytes:
            raise ValueError(f"symmetric heap of {self.nbytes} bytes is full ({end} needed)")
        offs = [None] * self.world
        dist.all_gather_object(offs, off, group=self.group)
        if len(set(offs)) != 1:
            raise RuntimeError(f"ranks allocated the symmetric heap differently: offsets {offs}")
        self._next = end
        return off

    def next_epoch(self) -> int:
        """The epoch of the next collective call."""
        self.epoch += 1
        return self.epoch

    def ptr(self, off: int, rank: int | None = None) -> int:
        """Address of heap offset ``off`` in ``rank``'s heap (default this
        rank's), as this process maps it."""
        return self.bases[self.rank if rank is None else rank] + off

    def args(self, epoch: int) -> list:
        """The leading C arguments of every collective entry point."""
        return [ctypes.c_void_p(self.peers.data_ptr()), ctypes.c_void_p(self.status.data_ptr()), self.rank,
                self.world, ctypes.c_uint64(epoch), ctypes.c_uint64(self.timeout_ns)]

    def copy(self, dst: int, src: int, nbytes: int) -> None:
        """``nbytes`` from address ``src`` to ``dst`` on the current stream
        (``cudaMemcpyAsync``); either may lie in a peer's heap. A torch view
        of a peer's heap would belong to the peer's card and open a second
        CUDA context there, so peers' bytes are read by address."""
        from triton_dist_tpu_torch.kernels import _build

        stream = _build.stream_ptr(self.device)
        self._check(self._lib.tdt_copy(ctypes.c_void_p(dst), ctypes.c_void_p(src), nbytes, stream), "heap copy")

    def check(self) -> None:
        """Raise ``CollectiveAbort`` if a wait of this rank expired (reads the
        status word: waits for the card)."""
        code, phase, peer, epoch = self.status.tolist()
        if code:
            name = PHASES[phase] if 0 <= phase < len(PHASES) else f"phase {phase}"
            raise CollectiveAbort(
                f"{self._who(self.rank)}: a collective wait expired in phase {name!r} waiting for "
                f"{self._who(peer)} (call {epoch}, bound {self.timeout_ns / 1e9:g} s)")

    def _who(self, rank: int) -> str:
        if self.axis is None:
            return f"rank {rank}"
        return f"{self.axis} rank {rank} (global rank {self.global_ranks[rank]})"

    def close(self) -> None:
        """Unmap the peers' heaps and free this one (after a synchronize)."""
        torch.cuda.synchronize(self.device)
        with torch.cuda.device(self.device):
            for p in self._opened:
                self._check(self._lib.tdt_heap_close(ctypes.c_void_p(p)), "closing a peer's heap")
            self._opened = []
            if self._base:
                self._check(self._lib.tdt_heap_free(ctypes.c_void_p(self._base)), "freeing the heap")
                self._base = 0

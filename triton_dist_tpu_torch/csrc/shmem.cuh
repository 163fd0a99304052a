// The device side of the one-sided layer: ranks, peer addresses, puts with
// a signal, bounded waits and the barrier. Counterpart of the JAX package's
// `language/core.py` (rank, num_ranks, putmem_signal, wait) and
// `shmem/kernel.py:209-364` (init_status, bounded_wait, bounded_barrier_all).
//
// The symmetric heap (shmem/symm.py) is one cudaMalloc per rank, mapped into
// every other rank's process with CUDA IPC. A buffer lives at the same byte
// offset in every rank's heap, so a peer's copy of it is `peers[r] + off`;
// `peers` is the device-side table of the heap bases as this process maps
// them (its own base at index `rank`).
//
// Signals are uint64 words. A writer stores the call's epoch (a per-context
// call counter that every rank advances alike), so pads are never reset: a
// waiter of call e waits for a value >= e. Every wait is bounded by
// `%globaltimer`; on expiry the block records (phase, peer, epoch) in the
// rank's status word and leaves its kernel, and later kernels that find the
// status set skip their waits, so a dead peer ends in a named abort on the
// host (CollectiveAbort) instead of a hang.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace tdt {

// Status word (4 x uint64 at the heap's start, local to its rank): code
// (0 = ok, 1 = a wait expired), phase, peer, epoch of the first expiry.
struct Status {
  uint64_t code, phase, peer, epoch;
};

// Phase ids: the order of shmem/symm.py's PHASES.
enum Phase : uint64_t {
  PHASE_BARRIER = 0,
  PHASE_AG_RECV = 1,
  PHASE_RS_RECV = 2,
  PHASE_AR_RECV = 3,
  PHASE_AR_BCAST = 4,
  PHASE_A2A_RECV = 5,
  PHASE_EP_DISPATCH = 6,
  PHASE_EP_COMBINE = 7,
  PHASE_AG_KV_RECV = 8,
};

// What a collective kernel needs of the layer; passed by value.
struct Shmem {
  const uint64_t* peers;  // device table: heap base of every rank, as mapped here
  Status* status;         // this rank's status word
  int rank, world;
  uint64_t epoch;         // this call's epoch
  uint64_t timeout_ns;    // bound of every wait
};

__device__ __forceinline__ int rank(const Shmem& s) { return s.rank; }
__device__ __forceinline__ int num_ranks(const Shmem& s) { return s.world; }

// The address of a symmetric buffer (heap offset `off`) in rank `peer`'s heap.
template <typename T>
__device__ __forceinline__ T* peer_ptr(const Shmem& s, uint64_t off, int peer) {
  return reinterpret_cast<T*>(s.peers[peer] + off);
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ uint64_t ld_acquire_sys(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(uint64_t* p, uint64_t v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void fence_acq_rel_sys() { asm volatile("fence.acq_rel.sys;" ::: "memory"); }

__device__ __forceinline__ bool poisoned(const Shmem& s) {
  return *reinterpret_cast<volatile const uint64_t*>(&s.status->code) != 0;
}

// Record the first expiry of this rank; later ones leave it as it is.
__device__ __forceinline__ void record_expiry(const Shmem& s, uint64_t phase, int peer) {
  if (atomicCAS(reinterpret_cast<unsigned long long*>(&s.status->code), 0ull, 1ull) == 0ull) {
    s.status->phase = phase;
    s.status->peer = static_cast<uint64_t>(peer);
    s.status->epoch = s.epoch;
    __threadfence_system();
  }
}

// Spin (acquire, system scope) until *flag >= the call's epoch. False when
// the bound expired or the status was already set; the caller then leaves
// its kernel.
__device__ __forceinline__ bool signal_wait_until(const Shmem& s, const uint64_t* flag, uint64_t phase,
                                                  int peer) {
  if (ld_acquire_sys(flag) >= s.epoch) return true;
  const uint64_t t0 = globaltimer();
  for (uint32_t i = 1;; ++i) {
    if (ld_acquire_sys(flag) >= s.epoch) return true;
    if ((i & 255u) == 0) {
      if (poisoned(s)) return false;
      if (globaltimer() - t0 > s.timeout_ns) {
        record_expiry(s, phase, peer);
        return false;
      }
    }
  }
}

// Make this thread's earlier stores (to any rank) visible system-wide, then
// the block's, then signal `flag` (in some rank's heap) with the epoch. Every
// thread of the block calls it.
__device__ __forceinline__ void block_signal(const Shmem& s, uint64_t* flag) {
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    fence_acq_rel_sys();
    st_release_sys(flag, s.epoch);
  }
}

// Thread 0 waits for `flag`; the whole block learns the outcome. Every
// thread of the block calls it; false means leave the kernel.
__device__ __forceinline__ bool block_wait(const Shmem& s, const uint64_t* flag, uint64_t phase, int peer) {
  __shared__ int ok;
  if (threadIdx.x == 0) ok = signal_wait_until(s, flag, phase, peer) ? 1 : 0;
  __syncthreads();
  const bool r = ok != 0;
  __syncthreads();  // `ok` may be rewritten by the next call
  return r;
}

// putmem_signal: `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from `src` to `dst` (a peer's heap) by the whole block in 16-byte stores,
// then `flag` set to the epoch after every store is visible.
__device__ __forceinline__ void putmem_signal(const Shmem& s, void* dst, const void* src, size_t bytes,
                                              uint64_t* flag) {
  const uint4* in = reinterpret_cast<const uint4*>(src);
  uint4* out = reinterpret_cast<uint4*>(dst);
  for (size_t i = threadIdx.x; i < bytes / 16; i += blockDim.x) out[i] = in[i];
  block_signal(s, flag);
}

// barrier_all over the ranks: thread r < world signals rank r's pad for this
// rank, then waits for rank r's signal on its own pad. `pads_off` is the
// heap offset of the pads (one uint64 per source rank). One block.
__device__ __forceinline__ void barrier_all(const Shmem& s, uint64_t pads_off) {
  const int r = threadIdx.x;
  if (r < s.world && !poisoned(s)) {
    __threadfence_system();
    st_release_sys(peer_ptr<uint64_t>(s, pads_off, r) + s.rank, s.epoch);
    signal_wait_until(s, peer_ptr<uint64_t>(s, pads_off, s.rank) + r, PHASE_BARRIER, r);
  }
  __syncthreads();
}

}  // namespace tdt

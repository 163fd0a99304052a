// The one-sided all-to-all legs shared by the expert-parallel kernels
// (ep_a2a.cu, row 25; ep_fused.cu, row 26), on the symmetric heap
// (shmem.cuh).
//
// A chunk is the bytes one rank sends one peer. `a2a_push_kernel` puts this
// rank's chunk for every peer into that peer's landing buffer at slot [me],
// piece by piece, and signals each piece; it waits for nothing, so it always
// finishes. Whatever reads a landing buffer runs in a later launch and waits
// only for the pieces it reads, so no block spins on a block of its own grid
// (the pattern of collective_gemm.cu), and four ranks on one card make
// progress as the card switches between them.
#pragma once

#include "shmem.cuh"

namespace tdt {

// The signal pads of one parity (shmem/symm.py): [phase][source][slot].
constexpr int A2A_MAX_WORLD = 8;
constexpr int A2A_MAX_SLOTS = 1024;

__device__ __forceinline__ uint64_t* a2a_pad(const Shmem& s, uint64_t flags_off, int owner, int phase, int src,
                                             int slot) {
  return peer_ptr<uint64_t>(s, flags_off, owner) + ((size_t)phase * A2A_MAX_WORLD + src) * A2A_MAX_SLOTS + slot;
}

// `bytes` from src to dst by the whole block, in the widest word that both
// addresses and the length allow. `cg`: read through L2 only (the bytes were
// written by another rank).
__device__ __forceinline__ void block_copy(void* dst, const void* src, size_t bytes, bool cg) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) | bytes;
  if ((a & 15) == 0) {
    const uint4* in = static_cast<const uint4*>(src);
    uint4* out = static_cast<uint4*>(dst);
    for (size_t i = threadIdx.x; i < bytes / 16; i += blockDim.x) out[i] = cg ? __ldcg(in + i) : in[i];
  } else if ((a & 3) == 0) {
    const unsigned int* in = static_cast<const unsigned int*>(src);
    unsigned int* out = static_cast<unsigned int*>(dst);
    for (size_t i = threadIdx.x; i < bytes / 4; i += blockDim.x) out[i] = cg ? __ldcg(in + i) : in[i];
  } else {
    const unsigned char* in = static_cast<const unsigned char*>(src);
    unsigned char* out = static_cast<unsigned char*>(dst);
    for (size_t i = threadIdx.x; i < bytes; i += blockDim.x) out[i] = cg ? __ldcg(in + i) : in[i];
  }
}

// grid (pieces, world - 1): block (b, j) puts piece b (`piece_bytes`, the
// last one short) of this rank's chunk for dest = (me + 1 + j) mod world,
// which starts at x + dest * x_stride, into dest's landing buffer at
// land_off + me * land_stride, then signals dest's pad (phase, me, b).
__global__ void __launch_bounds__(256)
    a2a_push_kernel(Shmem s, const unsigned char* __restrict__ x, size_t x_stride, size_t chunk_bytes,
                    size_t piece_bytes, uint64_t land_off, size_t land_stride, uint64_t flags_off, int phase) {
  if (poisoned(s)) return;
  const int b = blockIdx.x, dest = (s.rank + 1 + blockIdx.y) % s.world;
  const size_t lo = (size_t)b * piece_bytes;
  const size_t n = chunk_bytes - lo < piece_bytes ? chunk_bytes - lo : piece_bytes;
  unsigned char* dst = peer_ptr<unsigned char>(s, land_off, dest) + (size_t)s.rank * land_stride + lo;
  block_copy(dst, x + (size_t)dest * x_stride + lo, n, false);
  block_signal(s, a2a_pad(s, flags_off, dest, phase, s.rank, b));
}

inline int a2a_cdiv(size_t a, size_t b) { return static_cast<int>((a + b - 1) / b); }

inline bool a2a_bad_layer(int rank, int world) {
  return world < 1 || world > A2A_MAX_WORLD || rank < 0 || rank >= world;
}

inline Shmem a2a_shmem(const void* peers, void* status, int rank, int world, uint64_t epoch, uint64_t timeout_ns) {
  return Shmem{static_cast<const uint64_t*>(peers), static_cast<Status*>(status), rank, world, epoch, timeout_ns};
}

// Launch the push of `chunk_bytes` per peer in pieces of `piece_bytes`.
inline cudaError_t a2a_launch_push(const Shmem& s, const void* x, size_t x_stride, size_t chunk_bytes,
                                   size_t piece_bytes, uint64_t land_off, size_t land_stride, uint64_t flags_off,
                                   int phase, cudaStream_t st) {
  if (s.world == 1) return cudaSuccess;
  a2a_push_kernel<<<dim3(a2a_cdiv(chunk_bytes, piece_bytes), s.world - 1), 256, 0, st>>>(
      s, static_cast<const unsigned char*>(x), x_stride, chunk_bytes, piece_bytes, land_off, land_stride, flags_off,
      phase);
  return cudaGetLastError();
}

}  // namespace tdt

#define A2A_SHMEM_ARGS const void *peers, void *status, int rank, int world, uint64_t epoch, uint64_t timeout_ns

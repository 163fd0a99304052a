// The host side of the symmetric heap, and the barrier kernel.
//
// Heap: one cudaMalloc per rank, zeroed, exported as a CUDA IPC handle and
// opened by every other rank (cudaIpcMemLazyEnablePeerAccess). IPC works
// between processes on one card as well as across the cards of a host, so
// four ranks may share a card (the GPU time-slices their contexts) or
// own one each (NVLink).
//
// Barrier: replaces the TPU kernel of `barrier_all_on_device`
// (triton_dist_tpu/kernels/common_ops.py:29, launched at :33): one block,
// thread r signals rank r and waits for rank r's signal. Bound: one
// NVLink round trip, a few microseconds; its design has nothing to hide.

#include <string.h>

#include "shmem.cuh"

using namespace tdt;

namespace {

__global__ void barrier_kernel(Shmem s, uint64_t pads_off) { barrier_all(s, pads_off); }

}  // namespace

extern "C" int tdt_heap_alloc(size_t bytes, void** ptr, char* handle) {
  cudaError_t err = cudaMalloc(ptr, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemset(*ptr, 0, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t h;
  err = cudaIpcGetMemHandle(&h, *ptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  memcpy(handle, &h, sizeof(h));
  return 0;
}

extern "C" int tdt_heap_handle_bytes() { return static_cast<int>(sizeof(cudaIpcMemHandle_t)); }

extern "C" int tdt_heap_open(const char* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return static_cast<int>(cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int tdt_heap_close(void* ptr) { return static_cast<int>(cudaIpcCloseMemHandle(ptr)); }

extern "C" int tdt_heap_free(void* ptr) { return static_cast<int>(cudaFree(ptr)); }

// bytes from src to dst on the stream; either may lie in a peer's heap.
extern "C" int tdt_copy(void* dst, const void* src, size_t bytes, void* stream) {
  return static_cast<int>(
      cudaMemcpyAsync(dst, src, bytes, cudaMemcpyDefault, static_cast<cudaStream_t>(stream)));
}

extern "C" int tdt_barrier(const void* peers, void* status, int rank, int world, uint64_t epoch,
                           uint64_t timeout_ns, uint64_t pads_off, void* stream) {
  if (world < 1 || world > 32 || rank < 0 || rank >= world) return static_cast<int>(cudaErrorInvalidValue);
  const Shmem s{static_cast<const uint64_t*>(peers), static_cast<Status*>(status), rank, world, epoch,
                timeout_ns};
  barrier_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(s, pads_off);
  return static_cast<int>(cudaGetLastError());
}

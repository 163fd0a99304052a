// Row 23, the pipeline stage handoff for Hopper: out = the x of rank
// (me - offset) mod S along one mesh axis (a ring shift), on the symmetric
// heap of that axis's group (shmem.cuh).
//
// Replaces the TPU kernel `_p2p_kernel` (triton_dist_tpu/kernels/p2p.py:26,
// launched by `_p2p_put_impl`, pallas_call at :86 via `dist_pallas_call`):
// one remote DMA into rank + offset's output with a receive semaphore, a
// bounded wait for the arrival from rank - offset (phase pp_recv, naming
// that rank) and a closing bounded barrier. Here it is one launch; block b
// owns piece b of x:
//
// * it stores its piece, in 16-byte vectors where the addresses allow,
//   straight into the destination rank's zone (the heap workspace half of
//   this call's epoch parity) and raises its own signal slot there (pad 0,
//   source me, slot b);
// * it then waits, bounded by %globaltimer, for slot b from the source rank
//   (phase pp_recv, naming the source in the status word) and copies piece b
//   of its own zone out, since the call after next reuses the zone.
//
// A block waits only for the block of the same index on the source rank,
// which puts before it waits; a launch has at most 128 blocks of 256
// threads and no shared memory beyond a flag, so every block of every rank's
// grid is resident at once (on one card shared by the ranks the contexts run
// in turns, and a spinning block yields at the end of its time slice).
//
// The closing barrier. On S = 2 ranks it is dropped: the zone and the pads a
// call e writes alternate by e's parity, and the next write into the same
// half of a peer's heap comes from a call e + 2k (k >= 1). The writer starts
// that call only after its call e + 1 has ended (stream order), and every
// call on a two-rank heap (this kernel, the barrier, the plain collectives'
// barriers, the ring kernels) ends on one rank only after the other rank
// has started the same call, so after the other rank's call e, and its read
// of the zone, has ended. With a shift of +1 or -1 (the only ones at S = 2)
// the rank written to is the rank waited for, so this holds for every
// schedule that calls the handoff, forward and backward alike. At S > 2 the
// rank written to is not the one waited for, a rank may run ahead of its
// downstream neighbour, and the wrapper (kernels/p2p.py) keeps the barrier
// as a second launch.
//
// What bounds it on the H100: bytes over NVLink, 450 GB/s one way. The
// prefill handoff of Qwen3-8B, one prompt row of (seq, 4096) bf16, is 1.18
// MB at seq 144 (2.6 us); the decode handoff, (2, 4096) bf16 at B 4 over two
// stages, is 16 KiB, so one put and its flag, a few microseconds of latency.

#include "a2a.cuh"

using namespace tdt;

namespace {

// Whether this rank's status is set, one answer for the whole block.
__device__ __forceinline__ bool block_poisoned(const Shmem& s) {
  __shared__ int p;
  if (threadIdx.x == 0) p = poisoned(s) ? 1 : 0;
  __syncthreads();
  const bool r = p != 0;
  __syncthreads();
  return r;
}

// grid (pieces): see the header. x and out: this rank's `bytes`; the zone:
// `bytes` at heap offset zone_off in every rank's heap.
__global__ void __launch_bounds__(256)
    p2p_kernel(Shmem s, const unsigned char* __restrict__ x, unsigned char* __restrict__ out, size_t bytes,
               size_t piece, int dst, int src, uint64_t zone_off, uint64_t flags_off) {
  const int b = blockIdx.x;
  const size_t lo = (size_t)b * piece;
  const size_t n = bytes - lo < piece ? bytes - lo : piece;
  if (block_poisoned(s)) return;
  block_copy(peer_ptr<unsigned char>(s, zone_off, dst) + lo, x + lo, n, false);
  block_signal(s, a2a_pad(s, flags_off, dst, 0, s.rank, b));
  if (!block_wait(s, a2a_pad(s, flags_off, s.rank, 0, src, b), PHASE_PP_RECV, src)) return;
  block_copy(out + lo, peer_ptr<unsigned char>(s, zone_off, s.rank) + lo, n, true);
}

}  // namespace

// x, out: `bytes` each on this rank's card; piece: bytes a block (a multiple
// of 16, at most A2A_MAX_SLOTS pieces); dst / src: the ranks of the axis
// group sent to and received from; zone_off, flags_off: the heap workspace
// and pads of the epoch's parity. One launch.
extern "C" int tdt_p2p(A2A_SHMEM_ARGS, const void* x, void* out, size_t bytes, size_t piece, int dst, int src,
                       uint64_t zone_off, uint64_t flags_off, void* stream) {
  if (a2a_bad_layer(rank, world) || bytes == 0 || piece == 0 || piece % 16 != 0 ||
      a2a_cdiv(bytes, piece) > A2A_MAX_SLOTS || dst < 0 || dst >= world || src < 0 || src >= world)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shmem s = a2a_shmem(peers, status, rank, world, epoch, timeout_ns);
  p2p_kernel<<<a2a_cdiv(bytes, piece), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      s, static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out), bytes, piece, dst, src, zone_off,
      flags_off);
  return static_cast<int>(cudaGetLastError());
}

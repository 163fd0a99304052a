// The expert-parallel all-to-all for Hopper: out[p] = rank p's x[me], x and
// out (world, chunk) of any type, moved as bytes.
//
// Replaces the TPU kernel `_a2a_kernel` (triton_dist_tpu/kernels/ep_a2a.py:46,
// launched by `all_to_all_single_shard`, pallas_call at :102 via
// `dist_pallas_call`): full-mesh one-sided puts, one chunk per peer, the own
// chunk copied locally, bounded waits. The TPU kernel starts one DMA per
// peer and drains an anonymous arrival count behind a barrier; here:
//
// * launch 1 (`a2a_push_kernel`, a2a.cuh) cuts each peer's chunk into
//   pieces of at most 32 KB and puts every piece straight into the peer's
//   landing buffer at [me] (NVLink joins every card to every other: no
//   ring), one block a piece, each piece signalled with the call's epoch;
// * launch 2 (`a2a_recv_kernel`) copies every piece into out[src] once its
//   signal arrives (bounded by %globaltimer; an expiry records the phase
//   and the peer in the status word), and out[me] from x[me] in place.
//
// No entry barrier: the landing buffer and the pads alternate by the
// parity of the call's epoch (shmem/symm.py), and a rank ends call e only
// after every peer's pushes of call e arrived, so no peer is two calls
// behind. What bounds it on the H100: bytes. At Qwen3-30B-A3B world 4 on
// the decode route a leg moves 3/4 of (4, 256, 2048) bf16 (1 MB a peer)
// over NVLink, 7 us at 450 GB/s, and reads and writes 4 MB of HBM; the
// payload's fp8 leg is half that, the scales' leg 1 KB a peer, all
// latency.

#include "a2a.cuh"

using namespace tdt;

namespace {

// grid (pieces, world): block (b, src) fills piece b of out[src].
__global__ void __launch_bounds__(256)
    a2a_recv_kernel(Shmem s, const unsigned char* __restrict__ x, size_t x_stride, unsigned char* __restrict__ out,
                    size_t out_stride, size_t chunk_bytes, size_t piece_bytes, uint64_t land_off, size_t land_stride,
                    uint64_t flags_off) {
  const int b = blockIdx.x, src = blockIdx.y;
  const size_t lo = (size_t)b * piece_bytes;
  const size_t n = chunk_bytes - lo < piece_bytes ? chunk_bytes - lo : piece_bytes;
  unsigned char* dst = out + (size_t)src * out_stride + lo;
  if (src == s.rank) {
    block_copy(dst, x + (size_t)s.rank * x_stride + lo, n, false);
    return;
  }
  if (!block_wait(s, a2a_pad(s, flags_off, s.rank, 0, src, b), PHASE_A2A_RECV, src)) return;
  block_copy(dst, peer_ptr<unsigned char>(s, land_off, s.rank) + (size_t)src * land_stride + lo, n, true);
}

}  // namespace

// x: this rank's chunks, chunk p at x + p * x_stride; out: chunk p at
// out + p * out_stride; chunk_bytes each. land_off: a landing buffer of
// world * land_stride bytes in the heap (land_stride >= chunk_bytes, a
// multiple of 16); piece_bytes: at most A2A_MAX_SLOTS pieces a chunk. Two
// launches.
extern "C" int tdt_all_to_all(A2A_SHMEM_ARGS, const void* x, size_t x_stride, void* out, size_t out_stride,
                              size_t chunk_bytes, size_t piece_bytes, uint64_t land_off, size_t land_stride,
                              uint64_t flags_off, void* stream) {
  if (a2a_bad_layer(rank, world) || chunk_bytes == 0 || piece_bytes == 0 || land_stride < chunk_bytes ||
      a2a_cdiv(chunk_bytes, piece_bytes) > A2A_MAX_SLOTS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shmem s = a2a_shmem(peers, status, rank, world, epoch, timeout_ns);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = a2a_launch_push(s, x, x_stride, chunk_bytes, piece_bytes, land_off, land_stride, flags_off, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  a2a_recv_kernel<<<dim3(a2a_cdiv(chunk_bytes, piece_bytes), world), 256, 0, st>>>(
      s, static_cast<const unsigned char*>(x), x_stride, static_cast<unsigned char*>(out), out_stride, chunk_bytes,
      piece_bytes, land_off, land_stride, flags_off);
  return static_cast<int>(cudaGetLastError());
}

// The standalone collectives for Hopper, on the symmetric heap (shmem.cuh):
// all-gather (ring and full mesh), ring reduce-scatter and one-shot
// all-reduce. Each replaces a TPU kernel:
//
// * row 20, `_ring_ag_kernel` (triton_dist_tpu/kernels/allgather.py:96) and
//   `_fullmesh_ag_kernel` (:174), both launched by `_ag_pallas` (pallas_call
//   at :259): out (world, m, n) = every rank's (m, n) shard, bit for bit.
//   - `ring_ag_kernel`, one launch: block b owns piece b of the shard. It
//     copies its own piece into out[me] and puts it into its right
//     neighbour's landing slot [me]; then, for each of world - 1 steps, it
//     waits for the piece its left neighbour put (origin me - 1 - s), copies
//     it into out and forwards it to the right (all but the last step).
//   - full mesh, two launches: `a2a_push_kernel` (a2a.cuh, the same chunk
//     for every peer) puts the shard into every peer's landing slot [me];
//     `fullmesh_ag_kernel` copies each peer's slot into out[src] once it is
//     signalled, and the own shard from x.
// * row 21, `_ring_rs_kernel` (reduce_scatter.py:54, launched by
//   `reduce_scatter_shard`, pallas_call at :198): x (world, c, n) partials,
//   out (c, n) = this rank's chunk of the sum. `ring_rs_kernel`, one launch:
//   chunk c starts at rank c + 1 and travels right, ending at rank c. Block
//   b owns piece b of a chunk: it puts its partial of chunk me - 1 into the
//   right neighbour's step-0 slot; at step s it waits for the left
//   neighbour's running sum of chunk me - s - 2, adds its own partial in
//   fp32 and rounds to the wire dtype (as reduce_scatter.py:140-141 does),
//   then forwards it into the right neighbour's step s + 1 slot or, at the
//   last step, writes out. The sum is x_{c+1} + x_{c+2} + ... + x_c in that
//   order, rounded after every hop.
// * row 22, `_one_shot_ar_kernel` (allreduce.py:114, launched by
//   `one_shot_ar_call`, pallas_call at :227): out = the sum of every rank's
//   x. Two launches: `a2a_push_kernel` puts x into every peer's landing slot
//   [me]; `one_shot_ar_kernel` waits per (source, piece), then adds the
//   slots 0 .. world - 1 in fp32 from zero in rank order and casts once, so
//   every rank holds the same bits.
//
// The TPU kernels stage a whole chunk in VMEM and enter and leave behind a
// barrier. Here a landing slot is a region of the heap's workspace of this
// call's epoch parity; a rank ends call e only after every rank has started
// it (every result depends on a put from every rank), so no rank is two
// calls ahead of a reader and no entry or exit barrier is needed. The ring
// RS's credits (reduce_scatter.py:103-112) become one landing slot per step,
// each with its own flag. A ring block waits only for the same piece of its
// left neighbour's kernel, and a ring launch has at most 128 blocks of 256
// threads with no shared memory, so all of them are resident together; the
// two-launch collectives wait only for another launch. What bounds them on
// the H100 is bytes: the (world - 1) shards or partials that cross NVLink
// at 450 GB/s a direction, and for decode-sized messages (16-64 KB) the
// latency of a put and its flag.

#include "a2a.cuh"

using namespace tdt;

namespace {

// One element of T read through L2 only (written by another rank), widened.
template <typename T>
__device__ __forceinline__ float ld_cg(const T* p);
template <>
__device__ __forceinline__ float ld_cg<float>(const float* p) {
  return __ldcg(p);
}
template <>
__device__ __forceinline__ float ld_cg<bf16>(const bf16* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldcg(reinterpret_cast<const unsigned short*>(p))) << 16);
}

// Whether this rank's status is set, the same answer for every thread of
// the block (a ring block may start while another block of its launch
// records an expiry).
__device__ __forceinline__ bool block_poisoned(const Shmem& s) {
  __shared__ int p;
  if (threadIdx.x == 0) p = poisoned(s) ? 1 : 0;
  __syncthreads();
  const bool r = p != 0;
  __syncthreads();
  return r;
}

// Elements [lo, hi) of piece b: pieces of `piece` elements, the last short.
__device__ __forceinline__ void piece_range(size_t count, size_t piece, size_t& lo, size_t& hi) {
  lo = (size_t)blockIdx.x * piece;
  hi = lo + piece < count ? lo + piece : count;
}

// ------------------------------------------------------------------ row 20

// grid (pieces): see the header. x: this rank's `count` elements (bytes
// here: the ring moves bits); out: (world, ...) with slot r at
// out + r * out_stride; land_off: world slots of land_stride bytes.
__global__ void __launch_bounds__(256)
    ring_ag_kernel(Shmem s, const unsigned char* __restrict__ x, unsigned char* __restrict__ out, size_t out_stride,
                   size_t bytes, size_t piece, uint64_t land_off, size_t land_stride, uint64_t flags_off) {
  size_t lo, hi;
  piece_range(bytes, piece, lo, hi);
  const int np = gridDim.x, b = blockIdx.x;
  const int right = (s.rank + 1) % s.world, left = (s.rank + s.world - 1) % s.world;
  block_copy(out + (size_t)s.rank * out_stride + lo, x + lo, hi - lo, false);
  if (s.world == 1 || block_poisoned(s)) return;
  block_copy(peer_ptr<unsigned char>(s, land_off, right) + (size_t)s.rank * land_stride + lo, x + lo, hi - lo, false);
  block_signal(s, a2a_pad(s, flags_off, right, 0, s.rank, b));
  for (int step = 0; step < s.world - 1; ++step) {
    const int origin = (s.rank - 1 - step + 2 * s.world) % s.world;
    if (!block_wait(s, a2a_pad(s, flags_off, s.rank, 0, left, step * np + b), PHASE_AG_RECV, left)) return;
    const unsigned char* in = peer_ptr<unsigned char>(s, land_off, s.rank) + (size_t)origin * land_stride + lo;
    block_copy(out + (size_t)origin * out_stride + lo, in, hi - lo, true);
    if (step + 1 < s.world - 1) {
      block_copy(peer_ptr<unsigned char>(s, land_off, right) + (size_t)origin * land_stride + lo, in, hi - lo, true);
      block_signal(s, a2a_pad(s, flags_off, right, 0, s.rank, (step + 1) * np + b));
    }
  }
}

// grid (pieces, world): block (b, src) fills piece b of out[src] from src's
// landing slot once signalled (from x when src is this rank).
__global__ void __launch_bounds__(256)
    fullmesh_ag_kernel(Shmem s, const unsigned char* __restrict__ x, unsigned char* __restrict__ out,
                       size_t out_stride, size_t bytes, size_t piece, uint64_t land_off, size_t land_stride,
                       uint64_t flags_off) {
  size_t lo, hi;
  piece_range(bytes, piece, lo, hi);
  const int src = blockIdx.y;
  unsigned char* dst = out + (size_t)src * out_stride + lo;
  if (src == s.rank) {
    block_copy(dst, x + lo, hi - lo, false);
    return;
  }
  if (!block_wait(s, a2a_pad(s, flags_off, s.rank, 0, src, blockIdx.x), PHASE_AG_RECV, src)) return;
  block_copy(dst, peer_ptr<unsigned char>(s, land_off, s.rank) + (size_t)src * land_stride + lo, hi - lo, true);
}

// ------------------------------------------------------------------ row 21

// grid (pieces): see the header. x: chunk c at x + c * x_stride (elements),
// `count` elements a chunk; out: this rank's chunk; land_off: world - 1
// step slots of land_stride bytes.
template <typename T>
__global__ void __launch_bounds__(256)
    ring_rs_kernel(Shmem s, const T* __restrict__ x, size_t x_stride, T* __restrict__ out, size_t count,
                   size_t piece, uint64_t land_off, size_t land_stride, uint64_t flags_off) {
  size_t lo, hi;
  piece_range(count, piece, lo, hi);
  const int np = gridDim.x, b = blockIdx.x, w = s.world;
  const int right = (s.rank + 1) % w, left = (s.rank + w - 1) % w;
  if (block_poisoned(s)) return;
  auto land = [&](int rank, int step) {
    return reinterpret_cast<T*>(peer_ptr<unsigned char>(s, land_off, rank) + (size_t)step * land_stride);
  };
  {
    const T* src = x + (size_t)((s.rank + w - 1) % w) * x_stride;
    T* dst = land(right, 0);
    for (size_t i = lo + threadIdx.x; i < hi; i += blockDim.x) dst[i] = src[i];
    block_signal(s, a2a_pad(s, flags_off, right, 0, s.rank, b));
  }
  for (int step = 0; step < w - 1; ++step) {
    if (!block_wait(s, a2a_pad(s, flags_off, s.rank, 0, left, step * np + b), PHASE_RS_RECV, left)) return;
    const int c = (s.rank - step - 2 + 2 * w) % w;
    const T* in = land(s.rank, step);
    const T* mine = x + (size_t)c * x_stride;
    T* dst = step + 1 < w - 1 ? land(right, step + 1) : out;
    for (size_t i = lo + threadIdx.x; i < hi; i += blockDim.x)
      dst[i] = from_float<T>(ld_cg(in + i) + to_float(mine[i]));
    if (step + 1 < w - 1) block_signal(s, a2a_pad(s, flags_off, right, 0, s.rank, (step + 1) * np + b));
  }
}

// ------------------------------------------------------------------ row 22

// grid (pieces): waits for piece b of every peer's slot, then adds slots
// 0 .. world - 1 (x itself for this rank) in fp32 from zero and casts once.
template <typename T>
__global__ void __launch_bounds__(256)
    one_shot_ar_kernel(Shmem s, const T* __restrict__ x, T* __restrict__ out, size_t count, size_t piece,
                           uint64_t land_off, size_t land_stride, uint64_t flags_off) {
  size_t lo, hi;
  piece_range(count, piece, lo, hi);
  for (int src = 0; src < s.world; ++src)
    if (src != s.rank && !block_wait(s, a2a_pad(s, flags_off, s.rank, 0, src, blockIdx.x), PHASE_AR_RECV, src))
      return;
  const unsigned char* land = peer_ptr<unsigned char>(s, land_off, s.rank);
  for (size_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    float acc = 0.f;
    for (int src = 0; src < s.world; ++src)
      acc += src == s.rank ? to_float(x[i]) : ld_cg(reinterpret_cast<const T*>(land + (size_t)src * land_stride) + i);
    out[i] = from_float<T>(acc);
  }
}

inline size_t cdiv(size_t a, size_t b) { return (a + b - 1) / b; }

// Pieces of `piece` elements a chunk of `count`: at most `max_pieces`, and
// the piece's bytes a multiple of 16.
inline bool bad_pieces(size_t count, size_t piece, size_t elem, size_t max_pieces) {
  return count == 0 || piece == 0 || (piece * elem) % 16 || cdiv(count, piece) > max_pieces;
}

}  // namespace

// All-gather: x this rank's `bytes`; out[r] at out + r * out_stride; the
// landing slots at land_off, land_stride bytes apart (>= bytes, a multiple
// of 16). ring: one launch of at most 128 pieces, world - 1 flags a piece;
// else full mesh: two launches, at most A2A_MAX_SLOTS pieces.
extern "C" int tdt_all_gather(A2A_SHMEM_ARGS, const void* x, void* out, size_t out_stride, size_t bytes,
                              size_t piece, int ring, uint64_t land_off, size_t land_stride, uint64_t flags_off,
                              void* stream) {
  const size_t max_pieces = ring ? 128 : A2A_MAX_SLOTS;
  if (a2a_bad_layer(rank, world) || bad_pieces(bytes, piece, 1, max_pieces) || land_stride < bytes ||
      land_stride % 16 || (ring && (size_t)(world - 1) * cdiv(bytes, piece) > A2A_MAX_SLOTS))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shmem s = a2a_shmem(peers, status, rank, world, epoch, timeout_ns);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const unsigned char*>(x);
  auto* ob = static_cast<unsigned char*>(out);
  const int np = static_cast<int>(cdiv(bytes, piece));
  if (ring) {
    ring_ag_kernel<<<np, 256, 0, st>>>(s, xb, ob, out_stride, bytes, piece, land_off, land_stride, flags_off);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = a2a_launch_push(s, x, 0, bytes, piece, land_off, land_stride, flags_off, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  fullmesh_ag_kernel<<<dim3(np, world), 256, 0, st>>>(s, xb, ob, out_stride, bytes, piece, land_off,
                                                       land_stride, flags_off);
  return static_cast<int>(cudaGetLastError());
}

// Ring reduce-scatter: x chunk c at x + c * x_stride elements, `count`
// elements a chunk; out `count` elements. dtype: 0 = fp32, 1 = bf16. The
// world - 1 step slots at land_off, land_stride bytes apart. One launch of
// at most 128 pieces.
extern "C" int tdt_ring_reduce_scatter(A2A_SHMEM_ARGS, const void* x, size_t x_stride, void* out, size_t count,
                                       size_t piece, int dtype, uint64_t land_off, size_t land_stride,
                                       uint64_t flags_off, void* stream) {
  const size_t elem = dtype == 1 ? 2 : 4;
  if (a2a_bad_layer(rank, world) || world < 2 || (dtype != 0 && dtype != 1) || bad_pieces(count, piece, elem, 128) ||
      land_stride < count * elem || land_stride % 16 ||
      (size_t)(world - 1) * cdiv(count, piece) > A2A_MAX_SLOTS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shmem s = a2a_shmem(peers, status, rank, world, epoch, timeout_ns);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int np = static_cast<int>(cdiv(count, piece));
  if (dtype == 1)
    ring_rs_kernel<bf16><<<np, 256, 0, st>>>(s, static_cast<const bf16*>(x), x_stride, static_cast<bf16*>(out), count,
                                             piece, land_off, land_stride, flags_off);
  else
    ring_rs_kernel<float><<<np, 256, 0, st>>>(s, static_cast<const float*>(x), x_stride, static_cast<float*>(out),
                                              count, piece, land_off, land_stride, flags_off);
  return static_cast<int>(cudaGetLastError());
}

// One-shot all-reduce: x and out `count` elements; dtype 0 = fp32, 1 = bf16;
// the world landing slots at land_off, land_stride bytes apart. Two
// launches, at most A2A_MAX_SLOTS pieces.
extern "C" int tdt_one_shot_all_reduce(A2A_SHMEM_ARGS, const void* x, void* out, size_t count, size_t piece,
                                       int dtype, uint64_t land_off, size_t land_stride, uint64_t flags_off,
                                       void* stream) {
  const size_t elem = dtype == 1 ? 2 : 4;
  if (a2a_bad_layer(rank, world) || (dtype != 0 && dtype != 1) || bad_pieces(count, piece, elem, A2A_MAX_SLOTS) ||
      land_stride < count * elem || land_stride % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shmem s = a2a_shmem(peers, status, rank, world, epoch, timeout_ns);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = a2a_launch_push(s, x, 0, count * elem, piece * elem, land_off, land_stride, flags_off, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int np = static_cast<int>(cdiv(count, piece));
  if (dtype == 1)
    one_shot_ar_kernel<bf16><<<np, 256, 0, st>>>(s, static_cast<const bf16*>(x), static_cast<bf16*>(out), count,
                                                     piece, land_off, land_stride, flags_off);
  else
    one_shot_ar_kernel<float><<<np, 256, 0, st>>>(s, static_cast<const float*>(x), static_cast<float*>(out),
                                                      count, piece, land_off, land_stride, flags_off);
  return static_cast<int>(cudaGetLastError());
}

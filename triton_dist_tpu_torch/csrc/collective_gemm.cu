// The four collective matmuls of tensor-parallel serving, for Hopper, on
// the symmetric heap (shmem.cuh). Each replaces a TPU kernel:
//
// * AG-GEMM, `_ag_gemm_fused_kernel` (triton_dist_tpu/kernels/allgather_gemm.py:336,
//   launched by `_ag_gemm_pallas_core`, pallas_call at :674): out = AG(A) @ B,
//   and its SwiGLU variant silu(AG(x) @ Wg) * (AG(x) @ Wu). Launch 1
//   (`ag_push_kernel`) puts this rank's A shard, 64-row tile by tile, into
//   every peer's gather workspace with a signal per tile. Launch 2
//   (`ag_gemm_kernel`) computes the (world * m, n) output tile by tile in
//   rank-swizzled order: step 0 is the local shard (read in place, no wait),
//   step s the shard of rank (me - s) mod world, each tile waiting only for
//   the signal of the A tile it reads. On the TPU a ring carries the shards
//   over ICI; NVLink joins every card to every other, so each shard is put
//   once, straight to its reader. Bound at Qwen3-8B world 4 (S = 1500, the
//   SwiGLU pair): 2 * 1500 * 4096 * 6144 FLOP, 77 us at 989 TFLOP/s; the
//   3/4 of the gathered A that crosses NVLink (9.2 MB) takes 20 us at
//   450 GB/s. The tile core is mma.sync, not wgmma, so it runs well below
//   the FLOP bound; the pushes overlap the local step's GEMM.
// * GEMM-RS, `_gemm_rs_fused_kernel` (gemm_reduce_scatter.py:170, launched
//   by `_gemm_rs_fused`, pallas_call at :476): out = RS(A_local @ B_local) over
//   rows. Launch 1 (`partial_kernel`) computes every row tile's fp32 partial,
//   peers' chunks first, and stores each tile into its owner's workspace
//   slot for this source, signalling per tile. Launch 2 (`reduce_kernel`)
//   waits, tile by tile, for the world partials of this rank's chunk and adds
//   them in rank order 0..world-1, so the sum does not depend on arrival
//   order. The TPU kernel rides one accumulator round a ring; here each
//   partial moves once, owner-bound. Bound (S = 1500, down projection):
//   37.7 GFLOP, 38 us; fp32 partials over NVLink, 3/4 of 24.6 MB, 41 us.
// * GEMM-AR, `_gemm_ar_fused_kernel` (gemm_allreduce.py:143, launched by
//   `_gemm_ar_fused`, pallas_call at :450): the reduce-scatter above, then
//   each owner broadcasts its rounded chunk into every rank's workspace
//   (`reduce_kernel` with bcast) and launch 3 (`gather_kernel`) copies the
//   chunks out as they are signalled. Every rank ends with the same bits: the
//   owner rounds once and everyone copies.
// * LL GEMM-AR, `_gemm_ar_ll_kernel` (gemm_allreduce.py:501, launched by
//   `gemm_ar_ll_call`, pallas_call at :701): for tiny or ragged m (decode).
//   Launch 1 computes the fp32 partial tiles and pushes each to every rank;
//   launch 2 waits per source and tile and adds the world partials in rank
//   order on every rank, so all ranks hold bitwise equal results. Bound at
//   m = 4: the weights, 8 or 24 MB of bf16, 2.5 or 7.5 us at 3.35 TB/s.
//
// The quantized A operand (rows 16q-19q: the `quant` branches of the same
// four TPU kernels, allgather_gemm.py:338-460, gemm_reduce_scatter.py:201-290,
// gemm_allreduce.py:143-250 and :501-573): A is int8 or fp8 e4m3 with one
// f32 power-of-two scale a row (models/quant.py). `ag_push_quant_kernel`
// puts the 1-byte payload and the scales of each 64-row tile on the peers'
// workspaces under one signal, so the gather moves half the bytes of a bf16
// A; every GEMM tile dequantizes its A values exactly, q * scale in fp32,
// as it stages them (tile_gemm.cuh, QuantA), before the mma.sync. The
// products stay fp32 partials, so `reduce_kernel` and `gather_kernel` are
// the same; the output is in B's dtype. Each quant form computes the same
// bits as its unquantized form on the dequantized A.
//
// No block waits on a block of its own grid: every wait is on a kernel of
// another rank (or an earlier launch of this one) that waits for nothing
// itself, which is why each collective is two or three launches. Landing
// workspaces and signal pads come in two halves chosen by the parity of the
// call's epoch: a rank finishes call e only after every rank started it, so
// no rank is more than one call ahead of a reader, and the half it writes
// is never the half a slower rank still reads.

#include "shmem.cuh"
#include "tile_gemm.cuh"

using namespace tdt;

namespace {

// The signal pads of one parity: [phase][source][slot].
constexpr int MAX_WORLD = 8;
constexpr int MAX_SLOTS = 1024;

__device__ __forceinline__ uint64_t* pad(const Shmem& s, uint64_t flags_off, int owner, int phase, int src,
                                         int slot) {
  return peer_ptr<uint64_t>(s, flags_off, owner) + ((size_t)phase * MAX_WORLD + src) * MAX_SLOTS + slot;
}

__device__ __forceinline__ float silu_mul(float g, float u) { return g / (1.f + expf(-g)) * u; }

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float lo, float hi);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}
template <>
__device__ __forceinline__ void store_pair<bf16>(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// ------------------------------------------------------------- AG-GEMM

// grid (tiles of the m-row shard, world - 1): block (t, j) puts rows
// [64t, 64t + 64) of A into rank (me + 1 + j)'s workspace at [me][64t].
template <typename T>
__global__ void __launch_bounds__(256) ag_push_kernel(Shmem s, const T* __restrict__ a, int m, int K,
                                                      uint64_t ws_off, uint64_t flags_off) {
  if (poisoned(s)) return;
  const int t = blockIdx.x;
  const int dest = (s.rank + 1 + blockIdx.y) % s.world;
  const int r0 = t * TILE_M, rows = min(TILE_M, m - r0);
  T* dst = peer_ptr<T>(s, ws_off, dest) + ((size_t)s.rank * m + r0) * K;
  putmem_signal(s, dst, a + (size_t)r0 * K, (size_t)rows * K * sizeof(T), pad(s, flags_off, dest, 0, s.rank, t));
}

// The quantized A: grid as ag_push_kernel; block (t, j) puts the payload
// rows [64t, 64t + 64) (K bytes each; K % 8 == 0) into rank (me + 1 + j)'s
// gather workspace at [me][64t] and their scales into its scale workspace
// at [me][64t], then signals once for both.
template <typename P>
__global__ void __launch_bounds__(256) ag_push_quant_kernel(Shmem s, const P* __restrict__ a,
                                                            const float* __restrict__ a_scale, int m, int K,
                                                            uint64_t ws_off, uint64_t scale_off,
                                                            uint64_t flags_off) {
  if (poisoned(s)) return;
  const int t = blockIdx.x;
  const int dest = (s.rank + 1 + blockIdx.y) % s.world;
  const int r0 = t * TILE_M, rows = min(TILE_M, m - r0);
  const uint2* in = reinterpret_cast<const uint2*>(a + (size_t)r0 * K);
  uint2* dst = reinterpret_cast<uint2*>(peer_ptr<P>(s, ws_off, dest) + ((size_t)s.rank * m + r0) * K);
  for (size_t i = threadIdx.x; i < (size_t)rows * K / 8; i += blockDim.x) dst[i] = in[i];
  float* sdst = peer_ptr<float>(s, scale_off, dest) + (size_t)s.rank * m + r0;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) sdst[i] = a_scale[r0 + i];
  block_signal(s, pad(s, flags_off, dest, 0, s.rank, t));
}

// grid (n tiles, world * m tiles): row tile y = step * mt + t reads the shard
// of rank (me - step) mod world. P is A's element type: T, or int8 / e4m3
// for a quantized A, whose scales are at a_scale (this rank's) and at
// scale_off (the gathered ones).
template <typename T, typename P, int NB>
__global__ void __launch_bounds__(TileGemm<T, NB>::THREADS)
    ag_gemm_kernel(Shmem s, const P* __restrict__ a, const float* __restrict__ a_scale, const T* __restrict__ b0,
                   const T* __restrict__ b1, T* __restrict__ out, int m, int K, int N, uint64_t ws_off,
                   uint64_t scale_off, uint64_t flags_off) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int mt = (m + TILE_M - 1) / TILE_M;
  const int step = blockIdx.y / mt, t = blockIdx.y % mt;
  const int src = (s.rank - step + s.world) % s.world;
  const int n0 = blockIdx.x * TILE_N, r0 = t * TILE_M, rows = min(TILE_M, m - r0);
  const P* A = a + (size_t)r0 * K;
  const float* AS = a_scale + r0;  // read only for a quantized A
  if (src != s.rank) {
    if (!block_wait(s, pad(s, flags_off, s.rank, 0, src, t), PHASE_AG_RECV, src)) return;
    A = peer_ptr<P>(s, ws_off, s.rank) + ((size_t)src * m + r0) * K;
    AS = peer_ptr<float>(s, scale_off, s.rank) + (size_t)src * m + r0;
  }
  const T* B[NB];
  B[0] = b0;
  if constexpr (NB == 2) B[1] = b1;
  TileGemm<T, NB> tile;
  if constexpr (is_wire<P>::value)
    tile.run_a(QuantA<P>{A, AS}, rows, K, B, N, n0, reinterpret_cast<T*>(smem_raw));
  else
    tile.run(A, rows, K, B, N, n0, reinterpret_cast<T*>(smem_raw));
  T* o = out + ((size_t)src * m + r0) * N + n0;
  tile.epilogue(rows, N, n0, [&](int r, int c, const float (&v)[NB][2]) {
    if constexpr (NB == 2)
      store_pair(o + (size_t)r * N + c, silu_mul(v[0][0], v[1][0]), silu_mul(v[0][1], v[1][1]));
    else
      store_pair(o + (size_t)r * N + c, v[0][0], v[0][1]);
  });
}

// ----------------------------------------------- partial products (RS, AR, LL)

// fp32 partial tiles of A (m, K) @ B (K, N), each stored into a workspace of
// (world sources, rows, N) fp32 at [me][row] and signalled per tile
// (slot = t * n tiles + n tile, phase 0).
//   all_dest == 0 (RS, AR): rows go to their owner; chunk = m / world rows
//     each, grid (n tiles, world * chunk tiles), peers' chunks first.
//   all_dest == 1 (LL): every tile goes to every rank; chunk = m, grid
//     (n tiles, m tiles).
// P is A's element type: T, or int8 / e4m3 with the row scales at a_scale.
template <typename T, typename P>
__global__ void __launch_bounds__(TileGemm<T, 1>::THREADS)
    partial_kernel(Shmem s, const P* __restrict__ a, const float* __restrict__ a_scale, const T* __restrict__ b,
                   int m, int K, int N, int chunk, int all_dest, uint64_t ws_off, uint64_t flags_off) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (poisoned(s)) return;
  const int ct = (chunk + TILE_M - 1) / TILE_M;
  const int ci = blockIdx.y / ct, t = blockIdx.y % ct;
  const int owner = all_dest ? 0 : (s.rank + 1 + ci) % s.world;
  const int n0 = blockIdx.x * TILE_N, r0 = t * TILE_M, rows = min(TILE_M, chunk - r0);
  const T* B[1] = {b};
  TileGemm<T, 1> tile;
  const size_t row0 = (size_t)owner * chunk + r0;
  if constexpr (is_wire<P>::value)
    tile.run_a(QuantA<P>{a + row0 * K, a_scale + row0}, rows, K, B, N, n0, reinterpret_cast<T*>(smem_raw));
  else
    tile.run(a + row0 * K, rows, K, B, N, n0, reinterpret_cast<T*>(smem_raw));
  const int d0 = all_dest ? 0 : owner, d1 = all_dest ? s.world : owner + 1;
  const int slot = t * gridDim.x + blockIdx.x;
  for (int d = d0; d < d1; ++d) {
    float* w = peer_ptr<float>(s, ws_off, d) + ((size_t)s.rank * chunk + r0) * N + n0;
    tile.epilogue(rows, N, n0, [&](int r, int c, const float (&v)[1][2]) {
      store_pair(w + (size_t)r * N + c, v[0][0], v[0][1]);
    });
    block_signal(s, pad(s, flags_off, d, 0, s.rank, slot));
  }
}

// grid (n tiles, tiles of this rank's `chunk` rows): waits for tile (t, n)
// from every source, adds the fp32 partials in rank order and rounds once.
//   bcast == 0: writes `out` (chunk, N), this rank's rows.
//   bcast == 1 (AR): writes the rounded tile into every rank's broadcast
//     workspace (world * chunk, N) at rows me * chunk + ..., signalling per
//     tile (phase 1).
template <typename T>
__global__ void __launch_bounds__(256)
    reduce_kernel(Shmem s, T* __restrict__ out, int chunk, int N, uint64_t ws_off, uint64_t flags_off, int phase,
                  int bcast, uint64_t bcast_off) {
  const int t = blockIdx.y, n0 = blockIdx.x * TILE_N, r0 = t * TILE_M;
  const int rows = min(TILE_M, chunk - r0), slot = t * gridDim.x + blockIdx.x;
  for (int src = 0; src < s.world; ++src)
    if (!block_wait(s, pad(s, flags_off, s.rank, 0, src, slot), phase, src)) return;
  const float* w = peer_ptr<float>(s, ws_off, s.rank);
  const size_t plane = (size_t)chunk * N;
  const int d0 = bcast ? 0 : s.rank, d1 = bcast ? s.world : s.rank + 1;
  // Pairs of columns: N % 8 == 0, so a pair never straddles the edge.
  for (int i = threadIdx.x; i < TILE_M * TILE_N / 2; i += blockDim.x) {
    const int r = i / (TILE_N / 2), c = 2 * (i % (TILE_N / 2));
    if (r >= rows || n0 + c >= N) continue;
    const size_t e = (size_t)(r0 + r) * N + n0 + c;
    float2 acc = __ldcg(reinterpret_cast<const float2*>(w + e));
    for (int src = 1; src < s.world; ++src) {
      const float2 p = __ldcg(reinterpret_cast<const float2*>(w + src * plane + e));
      acc.x += p.x;
      acc.y += p.y;
    }
    if (!bcast) {
      store_pair(out + e, acc.x, acc.y);
    } else {
      for (int d = d0; d < d1; ++d)
        store_pair(peer_ptr<T>(s, bcast_off, d) + (size_t)s.rank * plane + e, acc.x, acc.y);
    }
  }
  if (bcast)
    for (int d = d0; d < d1; ++d) block_signal(s, pad(s, flags_off, d, 1, s.rank, slot));
}

// grid (n tiles, world * chunk tiles): copies each owner's broadcast tile
// into `out` (world * chunk, N) once it is signalled.
template <typename T>
__global__ void __launch_bounds__(256)
    gather_kernel(Shmem s, T* __restrict__ out, int chunk, int N, uint64_t bcast_off, uint64_t flags_off) {
  const int ct = (chunk + TILE_M - 1) / TILE_M;
  const int owner = blockIdx.y / ct, t = blockIdx.y % ct;
  const int n0 = blockIdx.x * TILE_N, r0 = t * TILE_M, rows = min(TILE_M, chunk - r0);
  if (!block_wait(s, pad(s, flags_off, s.rank, 1, owner, t * gridDim.x + blockIdx.x), PHASE_AR_BCAST, owner))
    return;
  const T* w = peer_ptr<T>(s, bcast_off, s.rank);
  for (int i = threadIdx.x; i < TILE_M * TILE_N / 2; i += blockDim.x) {
    const int r = i / (TILE_N / 2), c = 2 * (i % (TILE_N / 2));
    if (r >= rows || n0 + c >= N) continue;
    const size_t e = ((size_t)owner * chunk + r0 + r) * N + n0 + c;
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(out + e) = __ldcg(reinterpret_cast<const float2*>(w + e));
    } else {
      *reinterpret_cast<uint32_t*>(out + e) = __ldcg(reinterpret_cast<const unsigned int*>(w + e));
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

inline bool bad_shape(int m, int K, int N) { return m <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8; }

template <typename T, typename P, int NB>
int launch_ag(const Shmem& s, const void* a, const float* a_scale, const void* b0, const void* b1, void* out, int m,
              int K, int N, uint64_t ws_off, uint64_t scale_off, uint64_t flags_off, cudaStream_t st) {
  const int mt = cdiv(m, TILE_M);
  if (mt > MAX_SLOTS) return static_cast<int>(cudaErrorInvalidValue);
  if (s.world > 1) {
    if constexpr (is_wire<P>::value)
      ag_push_quant_kernel<P><<<dim3(mt, s.world - 1), 256, 0, st>>>(s, static_cast<const P*>(a), a_scale, m, K,
                                                                      ws_off, scale_off, flags_off);
    else
      ag_push_kernel<T><<<dim3(mt, s.world - 1), 256, 0, st>>>(s, static_cast<const T*>(a), m, K, ws_off,
                                                               flags_off);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr int SMEM = TileGemm<T, NB>::SMEM_BYTES;
  cudaError_t err = set_smem(ag_gemm_kernel<T, P, NB>, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  ag_gemm_kernel<T, P, NB><<<dim3(cdiv(N, TILE_N), s.world * mt), TileGemm<T, NB>::THREADS, SMEM, st>>>(
      s, static_cast<const P*>(a), a_scale, static_cast<const T*>(b0), static_cast<const T*>(b1),
      static_cast<T*>(out), m, K, N, ws_off, scale_off, flags_off);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int launch_partial(const Shmem& s, const void* a, const float* a_scale, const void* b, int m, int K, int N, int chunk,
                   int all_dest, uint64_t ws_off, uint64_t flags_off, cudaStream_t st) {
  constexpr int SMEM = TileGemm<T, 1>::SMEM_BYTES;
  cudaError_t err = set_smem(partial_kernel<T, P>, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nchunks = all_dest ? 1 : s.world;
  partial_kernel<T, P><<<dim3(cdiv(N, TILE_N), nchunks * cdiv(chunk, TILE_M)), TileGemm<T, 1>::THREADS, SMEM,
                         st>>>(s, static_cast<const P*>(a), a_scale, static_cast<const T*>(b), m, K, N, chunk,
                               all_dest, ws_off, flags_off);
  return static_cast<int>(cudaGetLastError());
}

// GEMM-RS (bcast = 0) or GEMM-AR (bcast = 1) of A's element type P.
template <typename T, typename P>
int launch_rs_ar(const Shmem& s, const void* a, const float* a_scale, const void* b, void* out, int m, int K, int N,
                 int bcast, uint64_t ws_off, uint64_t bcast_off, uint64_t flags_off, cudaStream_t st) {
  const int chunk = m / s.world;
  const dim3 rgrid(cdiv(N, TILE_N), cdiv(chunk, TILE_M)), ggrid(cdiv(N, TILE_N), s.world * cdiv(chunk, TILE_M));
  const uint64_t phase = bcast ? PHASE_AR_RECV : PHASE_RS_RECV;
  const int err = launch_partial<T, P>(s, a, a_scale, b, m, K, N, chunk, 0, ws_off, flags_off, st);
  if (err) return err;
  reduce_kernel<T><<<rgrid, 256, 0, st>>>(s, static_cast<T*>(out), chunk, N, ws_off, flags_off, phase, bcast,
                                          bcast_off);
  if (bcast) gather_kernel<T><<<ggrid, 256, 0, st>>>(s, static_cast<T*>(out), chunk, N, bcast_off, flags_off);
  return static_cast<int>(cudaGetLastError());
}

// LL GEMM-AR of A's element type P.
template <typename T, typename P>
int launch_ar_ll(const Shmem& s, const void* a, const float* a_scale, const void* b, void* out, int m, int K, int N,
                 uint64_t ws_off, uint64_t flags_off, cudaStream_t st) {
  const int err = launch_partial<T, P>(s, a, a_scale, b, m, K, N, m, 1, ws_off, flags_off, st);
  if (err) return err;
  reduce_kernel<T><<<dim3(cdiv(N, TILE_N), cdiv(m, TILE_M)), 256, 0, st>>>(s, static_cast<T*>(out), m, N, ws_off,
                                                                           flags_off, PHASE_AR_RECV, 0, 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename X>
struct Type {
  using type = X;
};

// Calls f(Type<T>{}, Type<P>{}) for the output dtype T (0 = fp32, 1 = bf16)
// and A's element type P (wire -1: A in T; 0: int8; 1: fp8 e4m3).
template <typename F>
int by_types(int dtype, int wire, F&& f) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (wire == -1) return dtype == 1 ? f(Type<bf16>{}, Type<bf16>{}) : f(Type<float>{}, Type<float>{});
  if (wire == WIRE_INT8) return dtype == 1 ? f(Type<bf16>{}, Type<int8_t>{}) : f(Type<float>{}, Type<int8_t>{});
  if (wire == WIRE_FP8) return dtype == 1 ? f(Type<bf16>{}, Type<fp8e4m3>{}) : f(Type<float>{}, Type<fp8e4m3>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

Shmem make_shmem(const void* peers, void* status, int rank, int world, uint64_t epoch, uint64_t timeout_ns) {
  return Shmem{static_cast<const uint64_t*>(peers), static_cast<Status*>(status), rank, world, epoch, timeout_ns};
}

bool bad_layer(int rank, int world) { return world < 1 || world > MAX_WORLD || rank < 0 || rank >= world; }

}  // namespace

#define SHMEM_ARGS const void *peers, void *status, int rank, int world, uint64_t epoch, uint64_t timeout_ns

namespace {

int ag_gemm(SHMEM_ARGS, const void* a, const float* a_scale, const void* b0, const void* b1, void* out, int m, int K,
            int N, int swiglu, int dtype, int wire, uint64_t ws_off, uint64_t scale_off, uint64_t flags_off,
            void* stream) {
  if (bad_layer(rank, world) || bad_shape(m, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  const Shmem s = make_shmem(peers, status, rank, world, epoch, timeout_ns);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_types(dtype, wire, [&](auto t, auto p) {
    using T = typename decltype(t)::type;
    using P = typename decltype(p)::type;
    return swiglu ? launch_ag<T, P, 2>(s, a, a_scale, b0, b1, out, m, K, N, ws_off, scale_off, flags_off, st)
                  : launch_ag<T, P, 1>(s, a, a_scale, b0, b1, out, m, K, N, ws_off, scale_off, flags_off, st);
  });
}

int gemm_rs_ar(SHMEM_ARGS, const void* a, const float* a_scale, const void* b, void* out, int m, int K, int N,
               int bcast, int dtype, int wire, uint64_t ws_off, uint64_t bcast_off, uint64_t flags_off,
               void* stream) {
  if (bad_layer(rank, world) || bad_shape(m, K, N) || m % world) return static_cast<int>(cudaErrorInvalidValue);
  if (cdiv(m / world, TILE_M) * cdiv(N, TILE_N) > MAX_SLOTS) return static_cast<int>(cudaErrorInvalidValue);
  const Shmem s = make_shmem(peers, status, rank, world, epoch, timeout_ns);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_types(dtype, wire, [&](auto t, auto p) {
    using T = typename decltype(t)::type;
    using P = typename decltype(p)::type;
    return launch_rs_ar<T, P>(s, a, a_scale, b, out, m, K, N, bcast, ws_off, bcast_off, flags_off, st);
  });
}

int gemm_ar_ll(SHMEM_ARGS, const void* a, const float* a_scale, const void* b, void* out, int m, int K, int N,
               int dtype, int wire, uint64_t ws_off, uint64_t flags_off, void* stream) {
  if (bad_layer(rank, world) || bad_shape(m, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  if (cdiv(m, TILE_M) * cdiv(N, TILE_N) > MAX_SLOTS) return static_cast<int>(cudaErrorInvalidValue);
  const Shmem s = make_shmem(peers, status, rank, world, epoch, timeout_ns);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_types(dtype, wire, [&](auto t, auto p) {
    using T = typename decltype(t)::type;
    using P = typename decltype(p)::type;
    return launch_ar_ll<T, P>(s, a, a_scale, b, out, m, K, N, ws_off, flags_off, st);
  });
}

}  // namespace

#define SHMEM_PASS peers, status, rank, world, epoch, timeout_ns

// AG-GEMM: a (m, K) this rank's shard; b0 (and b1 when swiglu) (K, N);
// out (world * m, N). ws_off: gather workspace (world, m, K); flags_off:
// this parity's pads. dtype: 0 = fp32, 1 = bf16. Two launches.
extern "C" int tdt_ag_gemm(SHMEM_ARGS, const void* a, const void* b0, const void* b1, void* out, int m, int K, int N,
                           int swiglu, int dtype, uint64_t ws_off, uint64_t flags_off, void* stream) {
  return ag_gemm(SHMEM_PASS, a, nullptr, b0, b1, out, m, K, N, swiglu, dtype, -1, ws_off, 0, flags_off, stream);
}

// Row 16q: as tdt_ag_gemm with a quantized A: a (m, K) int8 (wire 0) or fp8
// e4m3 (wire 1), K % 8 == 0, a_scale (m, 1) f32; out in B's dtype.
// ws_off: payload workspace (world, m, K) bytes; scale_off: (world, m) f32.
extern "C" int tdt_ag_gemm_quant(SHMEM_ARGS, const void* a, const void* a_scale, const void* b0, const void* b1,
                                 void* out, int m, int K, int N, int swiglu, int dtype, int wire, uint64_t ws_off,
                                 uint64_t scale_off, uint64_t flags_off, void* stream) {
  if (wire < 0 || a_scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return ag_gemm(SHMEM_PASS, a, static_cast<const float*>(a_scale), b0, b1, out, m, K, N, swiglu, dtype, wire,
                 ws_off, scale_off, flags_off, stream);
}

// GEMM-RS (bcast = 0) and GEMM-AR (bcast = 1): a (m, K), b (K, N), m % world
// == 0. RS: out (m / world, N), this rank's rows. AR: out (m, N). ws_off:
// partials (world, m / world, N) fp32; bcast_off: (m, N) of the dtype (AR).
// Two launches (RS) or three (AR).
extern "C" int tdt_gemm_rs_ar(SHMEM_ARGS, const void* a, const void* b, void* out, int m, int K, int N, int bcast,
                              int dtype, uint64_t ws_off, uint64_t bcast_off, uint64_t flags_off, void* stream) {
  return gemm_rs_ar(SHMEM_PASS, a, nullptr, b, out, m, K, N, bcast, dtype, -1, ws_off, bcast_off, flags_off, stream);
}

// Rows 17q and 18q: as tdt_gemm_rs_ar with a quantized A (a_scale (m, 1)
// f32, wire as tdt_ag_gemm_quant); out in B's dtype.
extern "C" int tdt_gemm_rs_ar_quant(SHMEM_ARGS, const void* a, const void* a_scale, const void* b, void* out, int m,
                                    int K, int N, int bcast, int dtype, int wire, uint64_t ws_off, uint64_t bcast_off,
                                    uint64_t flags_off, void* stream) {
  if (wire < 0 || a_scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return gemm_rs_ar(SHMEM_PASS, a, static_cast<const float*>(a_scale), b, out, m, K, N, bcast, dtype, wire, ws_off,
                    bcast_off, flags_off, stream);
}

// LL GEMM-AR: a (m, K), b (K, N), any m; out (m, N), equal on every rank.
// ws_off: (world, m, N) fp32 landing zones. Two launches.
extern "C" int tdt_gemm_ar_ll(SHMEM_ARGS, const void* a, const void* b, void* out, int m, int K, int N, int dtype,
                              uint64_t ws_off, uint64_t flags_off, void* stream) {
  return gemm_ar_ll(SHMEM_PASS, a, nullptr, b, out, m, K, N, dtype, -1, ws_off, flags_off, stream);
}

// Row 19q: as tdt_gemm_ar_ll with a quantized A; out in B's dtype.
extern "C" int tdt_gemm_ar_ll_quant(SHMEM_ARGS, const void* a, const void* a_scale, const void* b, void* out, int m,
                                    int K, int N, int dtype, int wire, uint64_t ws_off, uint64_t flags_off,
                                    void* stream) {
  if (wire < 0 || a_scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return gemm_ar_ll(SHMEM_PASS, a, static_cast<const float*>(a_scale), b, out, m, K, N, dtype, wire, ws_off,
                    flags_off, stream);
}

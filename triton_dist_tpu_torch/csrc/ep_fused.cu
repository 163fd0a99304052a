// Fused expert-parallel MoE for Hopper: the dispatch all-to-all, every local
// expert's gate/up -> SwiGLU -> down, and the return all-to-all that carries
// each output row home, on the symmetric heap (shmem.cuh, a2a.cuh).
//
// Replaces the TPU kernel `_fused_ep_kernel` (triton_dist_tpu/kernels/ep_fused.py:50,
// launched by `_fused_ep_call`, pallas_call at :408) in its combine=True,
// fp8=False form. send (world, E_local * C, d) holds this rank's capacity
// slots, destination-major; for every local expert e and source rank s the
// owner computes, on s's C rows of e,
//
//   h = (silu(x @ wg[e]) * (x @ wu[e])).astype(dtype)   (both products fp32)
//   y = (h @ wd[e]).astype(dtype)                         (fp32 accumulate)
//
// and puts y into s's combine buffer at [me, e * C]. comb (world, E_local * C,
// d) ends with rank p's experts' outputs for this rank's slots; the weighted
// unpermute (moe_utils.combine) stays outside, as in JAX.
//
// The TPU kernel sweeps a (E_local, ff tiles) grid in order with VMEM
// staging and overlaps the weight stream with the a2a drain. That does not
// carry over: blocks run in parallel and in no order, and a block that
// spins on an arrival must not hold an SM that its own rank's sends still
// need. So four launches, none waiting on a block of its own grid:
//
// 1. push (a2a.cuh): one block per (expert, peer) puts send[p, e * C:(e + 1) * C]
//    into p's dispatch landing buffer at [me], then signals (phase 0, me, e);
// 2. gate/up: a 64 x 64 tile of h per (ff tile, source, 64-row tile of C,
//    expert), the tile core of tile_gemm.cuh; it waits for the one source
//    its rows come from (its own rows are read from send in place) and
//    writes h into a local scratch (E_local, world * C, ff);
// 3. down: per (column group, source, row tile, expert) the h rows times
//    wd[e], tile by tile over the group's columns of d, each rounded tile
//    stored straight into the source's combine landing buffer, then one
//    signal (phase 1, me, slot);
// 4. combine: per (slot, source) a wait for that signal and a copy into comb.
//
// A row tile never spans two sources, so a row's result does not depend on
// where it sits in the expert's panel: when every rank routes the same
// tokens (the replicated `dist_ar` route), every rank gets the same bits.
// The landing buffers alternate by the parity of the call's epoch, as in
// collective_gemm.cu. What bounds it on the H100, Qwen3-30B-A3B world 4 at a
// 1500-token prefill (C = 48, E_local = 32, d = 2048, ff = 768, bf16): the
// weights, 302 MB a rank, 90 us at 3.35 TB/s, and 58 GFLOP, 59 us at
// 989 TFLOP/s; the 3/4 of both legs that cross NVLink, 2 x 18.9 MB, take
// 84 us at 450 GB/s. The tiles are mma.sync, not wgmma, and every source's
// row tile reads its expert's weights again (from L2 when the tiles of one
// expert run together), so it runs well below those bounds.

#include "a2a.cuh"
#include "tile_gemm.cuh"

using namespace tdt;

namespace {

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

// What launches 2-4 share. Experts are this call's group [e0, e0 + G) of the
// E_local local ones; row tiles of C are ct = ceil(C / 64).
struct EP {
  int G, C, d, ff, ct;
  size_t send_stride;  // elements between two peers' chunks in send (E_local * C * d)
  uint64_t recv_off;   // dispatch landing buffer (world, G * C, d)
  uint64_t comb_off;   // combine landing buffer (world, G * C, d)
  uint64_t flags_off;
};

// grid (ff tiles, world * ct, G).
template <typename T>
__global__ void __launch_bounds__(TileGemm<T, 2>::THREADS)
    ep_gate_up_kernel(Shmem s, EP p, const T* __restrict__ send, const T* __restrict__ wg, const T* __restrict__ wu,
                      T* __restrict__ h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int e = blockIdx.z, src = blockIdx.y / p.ct, t = blockIdx.y % p.ct;
  const int r0 = t * TILE_M, rows = min(TILE_M, p.C - r0), n0 = blockIdx.x * TILE_N;
  const T* A;
  if (src == s.rank) {
    A = send + (size_t)s.rank * p.send_stride + ((size_t)e * p.C + r0) * p.d;
  } else {
    if (!block_wait(s, a2a_pad(s, p.flags_off, s.rank, 0, src, e), PHASE_EP_DISPATCH, src)) return;
    A = peer_ptr<T>(s, p.recv_off, s.rank) + (((size_t)src * p.G + e) * p.C + r0) * p.d;
  }
  const T* B[2] = {wg + (size_t)e * p.d * p.ff, wu + (size_t)e * p.d * p.ff};
  TileGemm<T, 2> tile;
  tile.run(A, rows, p.d, B, p.ff, n0, reinterpret_cast<T*>(smem_raw));
  T* o = h + (((size_t)e * s.world + src) * p.C + r0) * p.ff + n0;
  tile.epilogue(rows, p.ff, n0, [&](int r, int c, const float (&v)[2][2]) {
    store_pair(o + (size_t)r * p.ff + c, silu_mul(v[0][0], v[1][0]), silu_mul(v[0][1], v[1][1]));
  });
}

// grid (column groups, world * ct, G): group g covers n tiles [g * per, ...).
template <typename T>
__global__ void __launch_bounds__(TileGemm<T, 1>::THREADS)
    ep_down_kernel(Shmem s, EP p, const T* __restrict__ h, const T* __restrict__ wd, int per) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (poisoned(s)) return;
  const int e = blockIdx.z, src = blockIdx.y / p.ct, t = blockIdx.y % p.ct, g = blockIdx.x;
  const int r0 = t * TILE_M, rows = min(TILE_M, p.C - r0);
  const int nt = (p.d + TILE_N - 1) / TILE_N, j1 = min(nt, (g + 1) * per);
  const T* A = h + (((size_t)e * s.world + src) * p.C + r0) * p.ff;
  const T* B[1] = {wd + (size_t)e * p.ff * p.d};
  T* dst = peer_ptr<T>(s, p.comb_off, src) + (((size_t)s.rank * p.G + e) * p.C + r0) * p.d;
  for (int j = g * per; j < j1; ++j) {
    __syncthreads();  // the previous tile's last stage is no longer read
    const int n0 = j * TILE_N;
    TileGemm<T, 1> tile;
    tile.run(A, rows, p.ff, B, p.d, n0, reinterpret_cast<T*>(smem_raw));
    tile.epilogue(rows, p.d, n0, [&](int r, int c, const float (&v)[1][2]) {
      store_pair(dst + (size_t)r * p.d + n0 + c, v[0][0], v[0][1]);
    });
  }
  block_signal(s, a2a_pad(s, p.flags_off, src, 1, s.rank, (e * p.ct + t) * gridDim.x + g));
}

// grid (G * ct * groups, world): block (slot, src) copies its region of the
// combine landing buffer into comb once src has signalled it.
template <typename T>
__global__ void __launch_bounds__(256)
    ep_combine_kernel(Shmem s, EP p, T* __restrict__ comb, size_t comb_stride, int groups, int per) {
  const int slot = blockIdx.x, src = blockIdx.y;
  const int g = slot % groups, et = slot / groups, t = et % p.ct, e = et / p.ct;
  if (!block_wait(s, a2a_pad(s, p.flags_off, s.rank, 1, src, slot), PHASE_EP_COMBINE, src)) return;
  const int r0 = t * TILE_M, rows = min(TILE_M, p.C - r0);
  const int c0 = g * per * TILE_N, cols = min(p.d, (g + 1) * per * TILE_N) - c0;
  constexpr int V = 16 / sizeof(T);  // d % 8 == 0: rows and column groups are whole 16-byte words
  const T* in = peer_ptr<T>(s, p.comb_off, s.rank) + (((size_t)src * p.G + e) * p.C + r0) * p.d + c0;
  T* out = comb + (size_t)src * comb_stride + ((size_t)e * p.C + r0) * p.d + c0;
  const int wpr = cols / V;
  for (int i = threadIdx.x; i < rows * wpr; i += blockDim.x) {
    const int r = i / wpr, c = (i % wpr) * V;
    *reinterpret_cast<uint4*>(out + (size_t)r * p.d + c) = __ldcg(reinterpret_cast<const uint4*>(in + (size_t)r * p.d + c));
  }
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
int launch(const Shmem& s, const EP& p, const void* send, const void* wg, const void* wu, const void* wd, void* h,
           void* comb, size_t comb_stride, int groups, cudaStream_t st) {
  cudaError_t err = a2a_launch_push(s, send, p.send_stride * sizeof(T), (size_t)p.G * p.C * p.d * sizeof(T),
                                    (size_t)p.C * p.d * sizeof(T), p.recv_off, (size_t)p.G * p.C * p.d * sizeof(T),
                                    p.flags_off, 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int SMEM2 = TileGemm<T, 2>::SMEM_BYTES, SMEM1 = TileGemm<T, 1>::SMEM_BYTES;
  if ((err = set_smem(ep_gate_up_kernel<T>, SMEM2)) != cudaSuccess) return static_cast<int>(err);
  if ((err = set_smem(ep_down_kernel<T>, SMEM1)) != cudaSuccess) return static_cast<int>(err);
  ep_gate_up_kernel<T><<<dim3(a2a_cdiv(p.ff, TILE_N), s.world * p.ct, p.G), TileGemm<T, 2>::THREADS, SMEM2, st>>>(
      s, p, static_cast<const T*>(send), static_cast<const T*>(wg), static_cast<const T*>(wu), static_cast<T*>(h));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int per = a2a_cdiv(a2a_cdiv(p.d, TILE_N), groups);
  ep_down_kernel<T><<<dim3(groups, s.world * p.ct, p.G), TileGemm<T, 1>::THREADS, SMEM1, st>>>(
      s, p, static_cast<const T*>(h), static_cast<const T*>(wd), per);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ep_combine_kernel<T><<<dim3(p.G * p.ct * groups, s.world), 256, 0, st>>>(s, p, static_cast<T*>(comb), comb_stride,
                                                                          groups, per);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One call over the local experts [e0, e0 + G), with send, wg, wu, wd and
// comb already offset to expert e0: send and comb hold a peer's chunk every
// e_stride elements (E_local * C * d), wg and wu are (G, d, ff), wd (G, ff,
// d); h is a scratch of (G, world * C, ff). ws_off: world * G * C * d
// elements of landing buffer for each leg, dispatch then combine. groups:
// column groups of d in the down launch, G * ceil(C / 64) * groups <= 1024
// signal slots. dtype: 0 = fp32, 1 = bf16; d and ff multiples of 8. Four
// launches.
extern "C" int tdt_ep_fused(A2A_SHMEM_ARGS, const void* send, const void* wg, const void* wu, const void* wd, void* h,
                            void* comb, size_t e_stride, int G, int C, int d, int ff, int groups, int dtype,
                            uint64_t ws_off, uint64_t flags_off, void* stream) {
  if (a2a_bad_layer(rank, world) || G < 1 || C < 1 || d < 8 || ff < 8 || d % 8 || ff % 8 || groups < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ct = a2a_cdiv(C, TILE_M);
  if (G > A2A_MAX_SLOTS || G * ct * groups > A2A_MAX_SLOTS || groups > a2a_cdiv(d, TILE_N))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shmem s = a2a_shmem(peers, status, rank, world, epoch, timeout_ns);
  const size_t itemsize = dtype == 1 ? 2 : 4;
  const size_t leg = (size_t)world * G * C * d * itemsize;
  const EP p{G, C, d, ff, ct, e_stride, ws_off, ws_off + leg, flags_off};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<bf16>(s, p, send, wg, wu, wd, h, comb, e_stride, groups, st);
  if (dtype == 0) return launch<float>(s, p, send, wg, wu, wd, h, comb, e_stride, groups, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Routed-experts panel compute of the mega decode step: per expert, gate/up
// products, SwiGLU and the down product, for Hopper.
//
// Replaces the TPU kernel `_moe_block_kernel` (triton_dist_tpu/megakernel/kernels.py:239,
// launched by `fused_moe_block`, pallas_call at :284). For the capacity-
// padded token panels xe (E, C, d) of the dispatch and each expert's
// w_gate, w_up (E, d, ff) and w_down (E, ff, d):
//
//   h[e] = silu(xe[e] @ w_gate[e]) * (xe[e] @ w_up[e])   fp32, rounded to xe's dtype
//   y[e] = h[e] @ w_down[e]                               fp32 sums, fp32 out (E, C, d)
//
// What bounds it on the H100: the experts' weights, all of which are read
// (an empty expert's panel is zero rows, and so is its y). At
// Qwen3-30B-A3B (E 128, d 2048, ff 768, bf16) that is 1.208 GB, 0.36 ms at
// 3.35 TB/s, against 1.2 GFLOP at C = 8: far below the ~295 FLOP/byte
// ridge, so the arithmetic stays on the SIMT cores in fp32.
//
// Design. The TPU kernel walks (expert, ff tile) as a sequential grid with
// the expert's (C, d) fp32 accumulator in VMEM. Here every (expert, 64-wide
// ff tile, 8-row chunk of the panel) is a block of its own (1536 blocks at
// Qwen3-30B-A3B with C = 8), built from the weight-streaming pieces of the
// dense MLP block (mega_gemv.cuh): it stages its 8 panel rows in shared
// memory, half of its warps stream the tile's w_gate columns and the other
// half its w_up columns, forms h for the tile in shared memory, then
// streams the tile's 64 rows of w_down and writes its fp32 (8, d) partial
// to a workspace (ntiles, E, C, d). Each weight element is read from memory
// once for C <= 8; for larger C the row chunks of one tile are neighbouring
// blocks, so the second read of a tile mostly hits L2. A second launch of
// this source adds the tiles' partials in tile order: no atomics, so the
// result does not change from run to run. The workspace costs 2 * ntiles *
// E * C * d * 4 bytes of traffic (201 MB at C = 8 on Qwen3-30B-A3B, 17 %
// of the weights' bytes). Skipping an expert with no routed token is exact and
// would cut the weight read about 4x at decode batch 4; it is later work.

#include "mega_gemv.cuh"

using namespace tdt;

namespace {

constexpr int CHUNK = 8;  // panel rows per block
static_assert(CHUNK == MAXB, "a chunk is one full set of mega_gemv rows");

template <typename T>
__global__ void __launch_bounds__(MEGA_THREADS)
    moe_tile_kernel(const T* __restrict__ XE, const T* __restrict__ WG, const T* __restrict__ WU,
                    const T* __restrict__ WD, float* __restrict__ Part, int E, int C, int d,
                    int ff) {
  constexpr int NB = CHUNK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // d x NB, the panel rows transposed
  __shared__ float red[MEGA_WARPS][NB][TILE_N];
  __shared__ __align__(16) float hs[TILE_N][NB];  // h of the tile, transposed

  const int r0 = blockIdx.x * CHUNK, tile = blockIdx.y, e = blockIdx.z;
  const int f0 = tile * TILE_N;
  const int nr = min(CHUNK, C - r0);  // real rows of this chunk
  const size_t we = (size_t)e * d * ff;  // this expert's weight matrices
  const T* X = XE + ((size_t)e * C + r0) * d;

  // Stage the chunk's rows, zero past nr.
  const int groups = d / 8;
  for (int i = threadIdx.x; i < NB * groups; i += MEGA_THREADS) {
    const int b = i / groups, k = (i % groups) * 8;
    T* dst = xs + k * NB + b;
    float xv[8];
    if (b < nr) {
      load_vec<8>(X + (size_t)b * d + k, xv);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) xv[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[j * NB] = from_float<T>(xv[j]);
  }
  __syncthreads();

  // Warps 0-3: gate columns; warps 4-7: up columns; 16 rows per step each.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = f0 + (lane & 7) * VEC;
  float acc[NB][VEC];
  zero_acc(acc);
  tile_dot<T, NB>((warp < 4 ? WG : WU) + we, ff, col, col < ff, (warp & 3) * 4 + (lane >> 3), d,
                  16, xs, acc);
  warp_tile_sums<NB>(acc, red);
  __syncthreads();
  for (int i = threadIdx.x; i < NB * TILE_N; i += MEGA_THREADS) {
    const int c = i / NB, b = i % NB;
    float h = 0.f;
    if (f0 + c < ff) {
      const float g = ((red[0][b][c] + red[1][b][c]) + red[2][b][c]) + red[3][b][c];
      const float u = ((red[4][b][c] + red[5][b][c]) + red[6][b][c]) + red[7][b][c];
      h = round_to<T>(g / (1.f + expf(-g)) * u);
    }
    hs[c][b] = h;
  }
  __syncthreads();

  // The tile's rows of w_down against h: 8 columns of d per thread.
  constexpr int DEPTH = depth<T>();
  const int rows = min(TILE_N, ff - f0);
  const T* WDe = WD + we + (size_t)f0 * d;
  float* P = Part + (((size_t)tile * E + e) * C + r0) * d;
  for (int c0 = threadIdx.x * VEC; c0 < d; c0 += MEGA_THREADS * VEC) {
    float acc2[NB][VEC];
    zero_acc(acc2);
    const T* wp = WDe + c0;
    int j = 0;
    for (; j + DEPTH - 1 < rows; j += DEPTH) {
      RawVec<T> w[DEPTH];
#pragma unroll
      for (int u = 0; u < DEPTH; ++u) w[u].load(wp + (size_t)(j + u) * d);
#pragma unroll
      for (int u = 0; u < DEPTH; ++u) {
        float f[VEC], hv[NB];
        w[u].widen(f);
        load_vec<NB>(&hs[j + u][0], hv);
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int q = 0; q < VEC; ++q) acc2[b][q] = fmaf(hv[b], f[q], acc2[b][q]);
      }
    }
    for (; j < rows; ++j) {
      RawVec<T> w;
      w.load(wp + (size_t)j * d);
      float f[VEC], hv[NB];
      w.widen(f);
      load_vec<NB>(&hs[j][0], hv);
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc2[b][q] = fmaf(hv[b], f[q], acc2[b][q]);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < nr) {
        float4* dst = reinterpret_cast<float4*>(P + (size_t)b * d + c0);
        dst[0] = make_float4(acc2[b][0], acc2[b][1], acc2[b][2], acc2[b][3]);
        dst[1] = make_float4(acc2[b][4], acc2[b][5], acc2[b][6], acc2[b][7]);
      }
    }
  }
}

// y[i] = sum over tiles, in order, of part[tile, i], for i < E * C * d.
__global__ void __launch_bounds__(MEGA_THREADS)
    moe_reduce_kernel(const float* __restrict__ Part, float* __restrict__ Y, size_t n,
                      int ntiles) {
  const size_t i = (size_t)blockIdx.x * MEGA_THREADS + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int t = 0; t < ntiles; ++t) s += Part[(size_t)t * n + i];
  Y[i] = s;
}

template <typename T>
cudaError_t launch(const void* xe, const void* wg, const void* wu, const void* wd, float* y,
                   float* part, int E, int C, int d, int ff, cudaStream_t s) {
  const int ntiles = (ff + TILE_N - 1) / TILE_N;
  const int smem = d * CHUNK * (int)sizeof(T);
  if (smem > MEGA_MAX_DYN_SMEM) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(moe_tile_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((C + CHUNK - 1) / CHUNK, ntiles, E);
  moe_tile_kernel<T><<<grid, MEGA_THREADS, smem, s>>>(
      static_cast<const T*>(xe), static_cast<const T*>(wg), static_cast<const T*>(wu),
      static_cast<const T*>(wd), part, E, C, d, ff);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t n = (size_t)E * C * d;
  moe_reduce_kernel<<<(unsigned)((n + MEGA_THREADS - 1) / MEGA_THREADS), MEGA_THREADS, 0, s>>>(
      part, y, n, ntiles);
  return cudaGetLastError();
}

}  // namespace

// xe: (E, C, d); w_gate, w_up: (E, d, ff); w_down: (E, ff, d), all of one
// dtype (0 = fp32, 1 = bf16); y: (E, C, d) fp32; part: (ceil(ff / 64), E,
// C, d) fp32 workspace. All contiguous on one device. d and ff multiples
// of 8, E <= 65535, C >= 1. Returns cudaGetLastError() after the second
// launch.
extern "C" int tdt_moe_block(const void* xe, const void* w_gate, const void* w_up,
                             const void* w_down, void* y, void* part, int E, int C, int d, int ff,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > 65535 || C < 1 || d <= 0 || ff <= 0 || d % 8 || ff % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  float* yy = static_cast<float*>(y);
  float* p = static_cast<float*>(part);
  if (dtype == 1) return static_cast<int>(launch<bf16>(xe, w_gate, w_up, w_down, yy, p, E, C, d, ff, s));
  if (dtype == 0) return static_cast<int>(launch<float>(xe, w_gate, w_up, w_down, yy, p, E, C, d, ff, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// RMSNorm, gate/up products, SwiGLU and the down product, for Hopper.
//
// Replaces the TPU kernel `_mlp_block_kernel` (triton_dist_tpu/megakernel/kernels.py:31,
// launched by `fused_mlp_block`, pallas_call at :84). For x (B, d),
// w_gate and w_up (d, ff), w_down (ff, d):
//
//   xn  = RMSNorm(x)                                  in x's dtype
//   h   = silu(xn @ w_gate) * (xn @ w_up)             fp32, rounded to x's dtype
//   out = h @ w_down (+ x if residual)                fp32 sums, cast once
//
// What bounds it on the H100: the three weights. At Qwen3-8B (d = 4096,
// ff = 12288, bf16) that is 302 MB, 0.090 ms at 3.35 TB/s, against at most
// 2.4 GFLOP at B = 8.
//
// Design. The TPU kernel walks ff as a sequential grid axis with the (B, d)
// fp32 output accumulating in VMEM. Here every 64-wide ff tile is a block
// of its own (192 at Qwen3-8B): it normalises x into shared memory, half
// of its warps stream the tile's w_gate columns and the other half its
// w_up columns (mega_gemv.cuh), forms h for the tile in shared memory,
// then streams the tile's 64 rows of w_down and writes its fp32 (B, d)
// partial to a workspace. Each weight element is read once. A second
// launch of this source adds the tiles' partials in tile order (no
// atomics, so the result does not change from run to run), adds x where
// asked, and casts. The workspace costs 2 * ntiles * B * d * 4 bytes of
// traffic (25 MB at B = 4 on Qwen3-8B, 8 % of the weights).

#include "mega_gemv.cuh"

using namespace tdt;

namespace {

template <typename T, int NB>
__global__ void __launch_bounds__(MEGA_THREADS)
    mlp_tile_kernel(const T* __restrict__ X, const T* __restrict__ LNW, const T* __restrict__ WG,
                    const T* __restrict__ WU, const T* __restrict__ WD, float* __restrict__ Part,
                    int d, int ff, float eps) {
  constexpr int NBP = padded_rows<NB>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // d x NBP
  __shared__ float s_rinv[MAXB];
  __shared__ float red[MEGA_WARPS][NB][TILE_N];
  __shared__ __align__(16) float hs[TILE_N][NBP];  // h of the tile, transposed

  const int tile = blockIdx.x, f0 = tile * TILE_N;
  row_rinv<T>(X, NB, d, eps, s_rinv);
  stage_norm<T, NB>(X, LNW, d, 0, d, s_rinv, xs);
  __syncthreads();

  // Warps 0-3: gate columns; warps 4-7: up columns; 16 rows per step each.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = f0 + (lane & 7) * VEC;
  float acc[NB][VEC];
  zero_acc(acc);
  tile_dot<T, NB>(warp < 4 ? WG : WU, ff, col, col < ff, (warp & 3) * 4 + (lane >> 3), d, 16, xs,
                  acc);
  warp_tile_sums<NB>(acc, red);
  __syncthreads();
  for (int i = threadIdx.x; i < NBP * TILE_N; i += MEGA_THREADS) {
    const int c = i / NBP, b = i % NBP;
    float h = 0.f;
    if (b < NB && f0 + c < ff) {
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
  for (int c0 = threadIdx.x * VEC; c0 < d; c0 += MEGA_THREADS * VEC) {
    float acc2[NB][VEC];
    zero_acc(acc2);
    const T* wp = WD + (size_t)f0 * d + c0;
    int j = 0;
    for (; j + DEPTH - 1 < rows; j += DEPTH) {
      RawVec<T> w[DEPTH];
#pragma unroll
      for (int u = 0; u < DEPTH; ++u) w[u].load(wp + (size_t)(j + u) * d);
#pragma unroll
      for (int u = 0; u < DEPTH; ++u) {
        float f[VEC], hv[NBP];
        w[u].widen(f);
        load_vec<NBP>(&hs[j + u][0], hv);
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int q = 0; q < VEC; ++q) acc2[b][q] = fmaf(hv[b], f[q], acc2[b][q]);
      }
    }
    for (; j < rows; ++j) {
      RawVec<T> w;
      w.load(wp + (size_t)j * d);
      float f[VEC], hv[NBP];
      w.widen(f);
      load_vec<NBP>(&hs[j][0], hv);
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc2[b][q] = fmaf(hv[b], f[q], acc2[b][q]);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float4* dst = reinterpret_cast<float4*>(Part + ((size_t)tile * NB + b) * d + c0);
      dst[0] = make_float4(acc2[b][0], acc2[b][1], acc2[b][2], acc2[b][3]);
      dst[1] = make_float4(acc2[b][4], acc2[b][5], acc2[b][6], acc2[b][7]);
    }
  }
}

// out[b, c] = (sum over tiles, in order, of part[tile, b, c] (+ x[b, c])) in T.
template <typename T>
__global__ void __launch_bounds__(MEGA_THREADS)
    mlp_reduce_kernel(const float* __restrict__ Part, const T* __restrict__ X, T* __restrict__ Out,
                      int nb, int d, int ntiles, int residual) {
  const int i = blockIdx.x * MEGA_THREADS + threadIdx.x;
  if (i >= nb * d) return;
  float s = 0.f;
  for (int t = 0; t < ntiles; ++t) s += Part[(size_t)t * nb * d + i];
  if (residual) s += to_float(X[i]);
  Out[i] = from_float<T>(s);
}

template <typename T>
cudaError_t launch(const void* x, const void* ln_w, const void* wg, const void* wu, const void* wd,
                   void* out, float* part, int B, int d, int ff, int residual, float eps,
                   cudaStream_t s) {
  const int ntiles = (ff + TILE_N - 1) / TILE_N;
  const T* xx = static_cast<const T*>(x);
  cudaError_t err = with_rows(B, [&](auto rows) {
    constexpr int NB = decltype(rows)::value;
    const int smem = d * padded_rows<NB>() * (int)sizeof(T);
    if (smem > MEGA_MAX_DYN_SMEM) return cudaErrorInvalidValue;
    cudaError_t e = allow_smem(mlp_tile_kernel<T, NB>, smem);
    if (e != cudaSuccess) return e;
    mlp_tile_kernel<T, NB><<<ntiles, MEGA_THREADS, smem, s>>>(
        xx, static_cast<const T*>(ln_w), static_cast<const T*>(wg), static_cast<const T*>(wu),
        static_cast<const T*>(wd), part, d, ff, eps);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  mlp_reduce_kernel<T><<<(B * d + MEGA_THREADS - 1) / MEGA_THREADS, MEGA_THREADS, 0, s>>>(
      part, xx, static_cast<T*>(out), B, d, ntiles, residual);
  return cudaGetLastError();
}

}  // namespace

// x, out: (B, d); ln_w: (d,); w_gate, w_up: (d, ff); w_down: (ff, d);
// part: (ceil(ff / 64), B, d) fp32 workspace. All contiguous on one device,
// x, the weights and out of one dtype: 0 = fp32, 1 = bf16. 1 <= B <= 8,
// d and ff multiples of 8. Returns cudaGetLastError() after the second
// launch.
extern "C" int tdt_mlp_block(const void* x, const void* ln_w, const void* w_gate, const void* w_up,
                             const void* w_down, void* out, void* part, int B, int d, int ff,
                             int residual, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > MAXB || d <= 0 || ff <= 0 || d % 8 || ff % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  float* p = static_cast<float*>(part);
  if (dtype == 1)
    return static_cast<int>(launch<bf16>(x, ln_w, w_gate, w_up, w_down, out, p, B, d, ff, residual,
                                         eps, s));
  if (dtype == 0)
    return static_cast<int>(launch<float>(x, ln_w, w_gate, w_up, w_down, out, p, B, d, ff,
                                          residual, eps, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// RMSNorm, QKV projection, per-head q/k RMSNorm and RoPE, for Hopper.
//
// Replaces the TPU kernel `_ln_qkv_rope_kernel` (triton_dist_tpu/megakernel/kernels.py:113,
// launched by `fused_ln_qkv_rope`, pallas_call at :205). For x (B, d) and
// wqkv (d, (Hq + 2 Hkv) D):
//
//   qkv = (RMSNorm(x) @ wqkv)            fp32 sums, rounded to x's dtype
//   q, k heads: RMSNorm over D with q_norm / k_norm (rounded as the plain
//               version rounds), then split-half RoPE at pos[b] with
//               freq_i = theta^(-i / (D/2)), in fp32, cast once
//   v heads:    the rounded projection as it is
//
// What bounds it on the H100: the wqkv read. At Qwen3-8B (d = 4096,
// 6144 columns, bf16) that is 50.3 MB, 0.015 ms at 3.35 TB/s; the products
// are at most 0.4 GFLOP at B = 8.
//
// Design. The TPU kernel walks the columns as a sequential grid axis, one
// head-aligned tile per step, and normalises x once into VMEM. Here the
// columns are 64-wide tiles (mega_gemv.cuh) and the d sweep is split into
// `splits` slices, so that at Qwen3-8B 96 tiles x 3 slices give about two
// blocks per SM; each block normalises only its slice of x (after a pass
// over the whole rows for their RMS) and writes fp32 partial sums to a
// workspace. A second launch of this source, one block per (row, head),
// adds the slices in order, rounds, and applies the head norm and RoPE to
// whole heads, so no tile has to hold a whole head and q, k and v tiles
// never mix. RoPE uses the accurate powf and sincosf.

#include "mega_gemv.cuh"

using namespace tdt;

namespace {

template <typename T, int NB>
__global__ void __launch_bounds__(MEGA_THREADS)
    qkv_partial_kernel(const T* __restrict__ X, const T* __restrict__ LNW,
                       const T* __restrict__ Wqkv, float* __restrict__ Part, int d, int cols,
                       int kslice, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // kslice x NBP
  __shared__ float s_rinv[MAXB];
  __shared__ float red[MEGA_WARPS][NB][TILE_N];

  const int n0 = blockIdx.x * TILE_N, split = blockIdx.y;
  const int k0 = split * kslice;
  const int klen = max(0, min(kslice, d - k0));
  row_rinv<T>(X, NB, d, eps, s_rinv);
  stage_norm<T, NB>(X, LNW, d, k0, klen, s_rinv, xs);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = n0 + (lane & 7) * VEC;
  float acc[NB][VEC];
  zero_acc(acc);
  tile_dot<T, NB>(Wqkv + (size_t)k0 * cols, cols, col, col < cols, warp * 4 + (lane >> 3), klen,
                  32, xs, acc);
  warp_tile_sums<NB>(acc, red);
  __syncthreads();
  store_tile_sums<NB>(red, n0, cols, Part + (size_t)split * NB * cols, cols);
}

// One block per (row b, head h) of the (Hq + 2 Hkv) heads; D <= 256.
template <typename T>
__global__ void __launch_bounds__(MEGA_THREADS)
    qkv_epilogue_kernel(const float* __restrict__ Part, const T* __restrict__ QN,
                        const T* __restrict__ KN, const int* __restrict__ Pos, T* __restrict__ Qo,
                        T* __restrict__ Ko, T* __restrict__ Vo, int nb, int hq, int hkv, int D,
                        int splits, float theta, float eps) {
  __shared__ float sv[256];
  __shared__ float sred[MEGA_WARPS];
  const int b = blockIdx.x, h = blockIdx.y, t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int cols = (hq + 2 * hkv) * D;

  float v = 0.f;
  if (t < D) {
    for (int s = 0; s < splits; ++s) v += Part[((size_t)s * nb + b) * cols + (size_t)h * D + t];
    v = round_to<T>(v);
  }
  if (h >= hq + hkv) {  // a v head: the rounded projection
    if (t < D) Vo[((size_t)b * hkv + (h - hq - hkv)) * D + t] = from_float<T>(v);
    return;
  }
  float ss = warp_sum(t < D ? v * v : 0.f);
  if (lane == 0) sred[warp] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < MEGA_WARPS; ++w) total += sred[w];
  const float rinv = 1.f / sqrtf(total / (float)D + eps);
  const T* nw = h < hq ? QN : KN;
  if (t < D) sv[t] = round_to<T>(round_to<T>(v * rinv) * to_float(nw[t]));
  __syncthreads();

  const int half = D / 2;
  if (t < half) {
    const float freq = powf(theta, -(float)t / (float)half);
    const float ang = (float)Pos[b] * freq;
    float sn, cs;
    sincosf(ang, &sn, &cs);
    const float x1 = sv[t], x2 = sv[t + half];
    T* out = h < hq ? Qo + ((size_t)b * hq + h) * D : Ko + ((size_t)b * hkv + (h - hq)) * D;
    out[t] = from_float<T>(x1 * cs - x2 * sn);
    out[t + half] = from_float<T>(x2 * cs + x1 * sn);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* ln_w, const void* wqkv, const void* q_norm,
                   const void* k_norm, const int* pos, void* q, void* k, void* v, float* part,
                   int B, int d, int hq, int hkv, int D, int splits, float theta, float eps,
                   cudaStream_t s) {
  const int cols = (hq + 2 * hkv) * D;
  const int kslice = (((d + splits - 1) / splits) + 7) / 8 * 8;
  cudaError_t err = with_rows(B, [&](auto rows) {
    constexpr int NB = decltype(rows)::value;
    const int smem = kslice * padded_rows<NB>() * (int)sizeof(T);
    if (smem > MEGA_MAX_DYN_SMEM) return cudaErrorInvalidValue;
    cudaError_t e = allow_smem(qkv_partial_kernel<T, NB>, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((cols + TILE_N - 1) / TILE_N, splits);
    qkv_partial_kernel<T, NB><<<grid, MEGA_THREADS, smem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(ln_w), static_cast<const T*>(wqkv), part,
        d, cols, kslice, eps);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  const dim3 grid2(B, hq + 2 * hkv);
  qkv_epilogue_kernel<T><<<grid2, MEGA_THREADS, 0, s>>>(
      part, static_cast<const T*>(q_norm), static_cast<const T*>(k_norm), pos, static_cast<T*>(q),
      static_cast<T*>(k), static_cast<T*>(v), B, hq, hkv, D, splits, theta, eps);
  return cudaGetLastError();
}

}  // namespace

// x: (B, d); ln_w: (d,); wqkv: (d, (hq + 2 hkv) D); q_norm, k_norm: (D,);
// pos: (B,) int32; q: (B, hq D), k, v: (B, hkv D); part: (splits, B,
// (hq + 2 hkv) D) fp32 workspace. All contiguous on one device, x, the
// weights and the outputs of one dtype: 0 = fp32, 1 = bf16. 1 <= B <= 8,
// d and the column count multiples of 8, D even and <= 256. Returns
// cudaGetLastError() after the second launch.
extern "C" int tdt_ln_qkv_rope(const void* x, const void* ln_w, const void* wqkv,
                               const void* q_norm, const void* k_norm, const void* pos, void* q,
                               void* k, void* v, void* part, int B, int d, int hq, int hkv, int D,
                               int splits, float theta, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > MAXB || d <= 0 || d % 8 || hq <= 0 || hkv <= 0 || D <= 0 || D % 2 ||
      D > 256 || (hq + 2 * hkv) * D % 8 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* p = static_cast<const int*>(pos);
  float* w = static_cast<float*>(part);
  if (dtype == 1)
    return static_cast<int>(launch<bf16>(x, ln_w, wqkv, q_norm, k_norm, p, q, k, v, w, B, d, hq,
                                         hkv, D, splits, theta, eps, s));
  if (dtype == 0)
    return static_cast<int>(launch<float>(x, ln_w, wqkv, q_norm, k_norm, p, q, k, v, w, B, d, hq,
                                          hkv, D, splits, theta, eps, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

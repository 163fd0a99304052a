// Pieces shared by the mega backend's weight-streaming kernels
// (mega_ln_qkv_rope.cu, mega_mlp_block.cu, mega_norm_head.cu and the
// o-projection of mega_attn_back.cu).
//
// All of them stream a row-major weight W (K, N) against NB <= 8 rows of an
// activation. At a decode batch of <= 8 rows a product does at most 16 FLOP
// per weight element (2 per bf16 byte at B = 4), far below the H100's ~295
// FLOP/byte ridge, so the weight read from HBM bounds them and the
// arithmetic can stay on the SIMT cores in fp32.
//
// The tile scheme: a block of 256 threads (8 warps) owns TILE_N = 64
// columns of W. A thread owns one 8-column group (16 bytes of bf16, 32 of
// fp32) and every kstep-th row of W, so a warp reads four whole 128-byte
// rows per step. The loads are the latency to hide: a thread keeps 128
// bytes of W in flight (eight 16-byte loads of bf16, four 32-byte loads of
// fp32), held raw in registers and widened only when used, and marks them
// evict-first (each weight byte is read once). The activation rows sit in
// shared memory transposed, row k holding the NB values of every batch row
// (padded to NBP, a power of two), so one vector load feeds all NB rows;
// NB is a template parameter, so the accumulators and loops carry no
// guards. The fp32 partial sums of the rows a warp covers are folded with
// shuffles, the warps' sums go through shared memory, and one thread per
// output adds them in warp order: no atomics, so every result is the same
// from run to run.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace tdt {

constexpr int MEGA_THREADS = 256;
constexpr int MEGA_WARPS = MEGA_THREADS / 32;
constexpr int MAXB = 8;     // rows per launch (decode slots)
constexpr int TILE_N = 64;  // columns per tile
constexpr int VEC = 8;      // columns per thread
static_assert(MAXB <= MEGA_WARPS, "row_rinv gives each row one warp");
static_assert(TILE_N == 8 * VEC, "a tile is eight column groups");

// NB rounded up to a power of two: the stride of the transposed rows.
template <int NB>
__host__ __device__ constexpr int padded_rows() {
  return NB <= 1 ? 1 : NB <= 2 ? 2 : NB <= 4 ? 4 : 8;
}

// Largest dynamic shared memory a launch asks for (the staged rows); the
// static tiles of each kernel stay under 24 KB, so this fits the 227 KB a
// block may use.
constexpr int MEGA_MAX_DYN_SMEM = 200 * 1024;

// s_rinv[b] = 1 / sqrt(mean(x[b]^2) + eps) over the K columns of each of
// the nb rows, one warp per row. K % 8 == 0. Ends with a block barrier.
template <typename T>
__device__ __forceinline__ void row_rinv(const T* __restrict__ X, int nb, int K, float eps,
                                         float* s_rinv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < nb) {
    const T* xr = X + (size_t)warp * K;
    float ss = 0.f;
    for (int k = lane * 8; k < K; k += 256) {
      float v[8];
      load_vec<8>(xr + k, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) ss = fmaf(v[j], v[j], ss);
    }
    ss = warp_sum(ss);
    if (lane == 0) s_rinv[warp] = 1.f / sqrtf(ss / (float)K + eps);
  }
  __syncthreads();
}

// VEC values of T at p, loaded with one streaming (evict-first) access and
// kept raw until widened.
template <typename T>
struct RawVec;

template <>
struct RawVec<bf16> {
  uint4 u;
  __device__ __forceinline__ void load(const bf16* p) { u = __ldcs(reinterpret_cast<const uint4*>(p)); }
  __device__ __forceinline__ void widen(float (&f)[VEC]) const {
    unpack_bf16x2(u.x, f[0], f[1]);
    unpack_bf16x2(u.y, f[2], f[3]);
    unpack_bf16x2(u.z, f[4], f[5]);
    unpack_bf16x2(u.w, f[6], f[7]);
  }
};

template <>
struct RawVec<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldcs(reinterpret_cast<const float4*>(p));
    b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void widen(float (&f)[VEC]) const {
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  }
};

// Loads of W a thread keeps in flight: 128 bytes.
template <typename T>
__host__ __device__ constexpr int depth() { return 128 / (VEC * (int)sizeof(T)); }

// xs[k * NBP + b] = RMSNorm(x)[b, k0 + k] in T for k < klen, b < NB (zero
// for NB <= b < NBP), as the plain version rounds it: the normalised value
// is cast to T, then multiplied by the weight and cast again (the product
// of two bf16 is exact in fp32, so this is the bf16 multiply). k0, klen and
// K are multiples of 8. No barrier at the end.
template <typename T, int NB>
__device__ __forceinline__ void stage_norm(const T* __restrict__ X, const T* __restrict__ W, int K,
                                           int k0, int klen, const float* s_rinv, T* xs) {
  constexpr int NBP = padded_rows<NB>();
  const int groups = klen / 8;
  for (int i = threadIdx.x; i < NBP * groups; i += MEGA_THREADS) {
    const int b = i / groups, k = (i % groups) * 8;
    T* dst = xs + k * NBP + b;
    if (b >= NB) {
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j * NBP] = from_float<T>(0.f);
      continue;
    }
    float xv[8], wv[8];
    load_vec<8>(X + (size_t)b * K + k0 + k, xv);
    load_vec<8>(W + k0 + k, wv);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[j * NBP] = from_float<T>(round_to<T>(xv[j] * s_rinv[b]) * wv[j]);
  }
}

// acc[b][j] += sum over rows k = k_begin, k_begin + kstep, ... < k_end of
// xs[k * NBP + b] * W[k * ldw + col + j], for b < NB. W and xs start at the
// same row. Does nothing when !col_ok.
template <typename T, int NB>
__device__ __forceinline__ void tile_dot(const T* __restrict__ W, int ldw, int col, bool col_ok,
                                         int k_begin, int k_end, int kstep, const T* xs,
                                         float (&acc)[NB][VEC]) {
  constexpr int DEPTH = depth<T>();
  constexpr int NBP = padded_rows<NB>();
  if (!col_ok) return;
  const T* wp = W + col;
  int k = k_begin;
  for (; k + (DEPTH - 1) * kstep < k_end; k += DEPTH * kstep) {
    RawVec<T> w[DEPTH];
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) w[u].load(wp + (size_t)(k + u * kstep) * ldw);
#pragma unroll
    for (int u = 0; u < DEPTH; ++u) {
      float f[VEC], xv[NBP];
      w[u].widen(f);
      load_vec<NBP>(xs + (k + u * kstep) * NBP, xv);
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[b][j] = fmaf(xv[b], f[j], acc[b][j]);
    }
  }
  for (; k < k_end; k += kstep) {
    RawVec<T> w;
    w.load(wp + (size_t)k * ldw);
    float f[VEC], xv[NBP];
    w.widen(f);
    load_vec<NBP>(xs + k * NBP, xv);
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[b][j] = fmaf(xv[b], f[j], acc[b][j]);
  }
}

template <int NB>
__device__ __forceinline__ void zero_acc(float (&acc)[NB][VEC]) {
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[b][j] = 0.f;
}

// Fold the four row groups of a warp (lanes cg, cg + 8, cg + 16, cg + 24
// share a column group) and store the warp's sums in red[warp][b][*].
template <int NB>
__device__ __forceinline__ void warp_tile_sums(float (&acc)[NB][VEC], float (*red)[NB][TILE_N]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      acc[b][j] += __shfl_xor_sync(0xffffffffu, acc[b][j], 8);
      acc[b][j] += __shfl_xor_sync(0xffffffffu, acc[b][j], 16);
    }
  }
  if (lane < 8) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int j = 0; j < VEC; ++j) red[warp][b][lane * VEC + j] = acc[b][j];
  }
}

// Block-wide: Part[b * ldp + n0 + c] = sum over warps, in order, of
// red[w][b][c] for b < NB and the tile's columns below N.
template <int NB>
__device__ __forceinline__ void store_tile_sums(float (*red)[NB][TILE_N], int n0, int N,
                                                float* Part, size_t ldp) {
  for (int i = threadIdx.x; i < NB * TILE_N; i += MEGA_THREADS) {
    const int b = i / TILE_N, c = i % TILE_N;
    if (n0 + c >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < MEGA_WARPS; ++w) s += red[w][b][c];
    Part[b * ldp + n0 + c] = s;
  }
}

// Lets a kernel take `bytes` of dynamic shared memory beside its static
// tiles (under 24 KB): past 48 KB in all a block needs the opt-in.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 24 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// f(std::integral_constant<int, B>()) for 1 <= B <= MAXB: a launch picks the
// kernel instantiated for its row count.
template <typename F>
inline cudaError_t with_rows(int B, F f) {
  switch (B) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    case 6: return f(std::integral_constant<int, 6>());
    case 7: return f(std::integral_constant<int, 7>());
    case 8: return f(std::integral_constant<int, 8>());
  }
  return cudaErrorInvalidValue;
}

}  // namespace tdt

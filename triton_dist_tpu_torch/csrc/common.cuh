// Helpers shared by the port's CUDA kernels. Each csrc/*.cu is built into
// its own shared library with a plain C interface (kernels/_build.py), so
// the one non-inline function here is defined once per library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tdt {

typedef __nv_bfloat16 bf16;

// The TPU kernels' masking constant and exp2-domain factor.
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

// x rounded to T and back: the TPU kernels cast P to V's dtype before PV.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_float(from_float<T>(x)); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// N contiguous values of T at p, widened to float. p must be aligned to
// N * sizeof(T) bytes for the vector loads below.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[N]) {
  static_assert(N == 1 || N == 2 || N % 4 == 0, "unsupported vector width");
  if constexpr (N == 1) {
    out[0] = p[0];
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      out[i] = v.x;
      out[i + 1] = v.y;
      out[i + 2] = v.z;
      out[i + 3] = v.w;
    }
  }
}

// Two bf16 packed in one 32-bit word (low half first), widened exactly.
__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

template <int N>
__device__ __forceinline__ void load_vec(const bf16* p, float (&out)[N]) {
  static_assert(N == 1 || N == 2 || N == 4 || N % 8 == 0, "unsupported vector width");
  if constexpr (N == 1) {
    out[0] = __bfloat162float(p[0]);
  } else if constexpr (N == 2) {
    unpack_bf16x2(*reinterpret_cast<const uint32_t*>(p), out[0], out[1]);
  } else if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    unpack_bf16x2(u.x, out[0], out[1]);
    unpack_bf16x2(u.y, out[2], out[3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + i);
      unpack_bf16x2(u.x, out[i], out[i + 1]);
      unpack_bf16x2(u.y, out[i + 2], out[i + 3]);
      unpack_bf16x2(u.z, out[i + 4], out[i + 5]);
      unpack_bf16x2(u.w, out[i + 6], out[i + 7]);
    }
  }
}

}  // namespace tdt

extern "C" const char* tdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The int8 / fp8 (e4m3) number format of models/quant.py on the device:
// x = q * scale, one f32 power-of-two scale a row, so q * scale is exact in
// fp32 (and in bf16: at most 8 significant bits times a power of two).
// Used by the quantized paged-pool walk (flash_decode.cu) and the quantized
// A tiles of the collective matmuls (tile_gemm.cuh).
#pragma once

#include <cuda_fp8.h>

#include "common.cuh"

namespace tdt {

typedef __nv_fp8_e4m3 fp8e4m3;

// The wrappers' wire codes (kernels/_build.py callers pass these).
constexpr int WIRE_INT8 = 0;
constexpr int WIRE_FP8 = 1;

template <typename P>
struct is_wire {
  static constexpr bool value = false;
};
template <>
struct is_wire<int8_t> {
  static constexpr bool value = true;
};
template <>
struct is_wire<fp8e4m3> {
  static constexpr bool value = true;
};

// One payload byte (the low 8 bits of b) as a float, exactly.
template <typename P>
__device__ __forceinline__ float wire_byte_to_float(uint32_t b);
template <>
__device__ __forceinline__ float wire_byte_to_float<int8_t>(uint32_t b) {
  return static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(b & 0xffu)));
}
template <>
__device__ __forceinline__ float wire_byte_to_float<fp8e4m3>(uint32_t b) {
  fp8e4m3 f;
  f.__x = static_cast<__nv_fp8_storage_t>(b & 0xffu);
  return static_cast<float>(f);
}

// Four payload bytes packed in a word (the lowest address in the low byte),
// each times s.
template <typename P>
__device__ __forceinline__ void dequant4(uint32_t w, float s, float* out) {
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = wire_byte_to_float<P>(w >> (8 * j)) * s;
}

// N consecutive payload values at p (aligned to N bytes), dequantized with
// the row's scale s.
template <int N, typename P>
__device__ __forceinline__ void load_dequant(const P* p, float s, float (&out)[N]) {
  static_assert(N == 1 || N == 2 || N == 4 || N % 8 == 0, "unsupported vector width");
  if constexpr (N == 1) {
    out[0] = wire_byte_to_float<P>(*reinterpret_cast<const uint8_t*>(p)) * s;
  } else if constexpr (N == 2) {
    const uint32_t w = *reinterpret_cast<const uint16_t*>(p);
    out[0] = wire_byte_to_float<P>(w) * s;
    out[1] = wire_byte_to_float<P>(w >> 8) * s;
  } else if constexpr (N == 4) {
    dequant4<P>(*reinterpret_cast<const uint32_t*>(p), s, out);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(p + i);
      dequant4<P>(u.x, s, out + i);
      dequant4<P>(u.y, s, out + i + 4);
    }
  }
}

}  // namespace tdt

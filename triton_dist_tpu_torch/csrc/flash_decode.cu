// One-token GQA flash decode for Hopper.
//
// Replaces the TPU kernel `_decode_kernel` (triton_dist_tpu/kernels/flash_decode.py:71,
// launched by `flash_decode`, pallas_call at :169). It computes the same
// function: q (B, Hq, D) attends over a padded cache k, v (B, Hkv, S, D)
// up to lengths[b] keys, online softmax in the natural-exp domain, P cast
// to V's dtype before the PV product, o (B, Hq, D) and lse (B, Hq) fp32 in
// nats, with o = 0 and lse = -1e30 where a row has no key.
//
// What bounds it on the H100: the cache. Every valid K and V row is read
// once and used by the G = Hq / Hkv query heads of its group, about G
// FLOP per byte (4 at Qwen3-8B), far below the ~295 FLOP/byte ridge: HBM
// bandwidth bounds it, at sum(lengths) * Hkv * D * 4 bytes (bf16, K and V).
//
// Design. One block per (b, kv head); the G query rows of the group sit in
// shared memory, so a K/V row read from memory serves all G heads and no
// head's cache is read twice. The TPU kernel's sequential KV grid axis is
// a loop inside the block: 8 warps take 32-key tiles in turn up to
// lengths[b] (tiles past the end are never read). In a tile a lane owns one
// key for QK^T (vector loads of its K row) and D/32 columns for PV; each
// warp keeps its own running max/sum and the 8 partial results are merged
// through shared memory at the end. At the main path's batch of 4 with
// 8 kv heads this launches 32 blocks on 132 SMs, so it sits well under the
// bandwidth bound: splitting the KV sweep across blocks (split-KV with a
// combine pass) is the fix, left for a later change.

#include "common.cuh"

using namespace tdt;

namespace {

constexpr int DEC_WARPS = 8;
constexpr int DEC_THREADS = DEC_WARPS * 32;
constexpr int DEC_TILE = 32;  // keys per warp step, one per lane

template <typename T, int D, int G>
__global__ void __launch_bounds__(DEC_THREADS)
    flash_decode_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                        const T* __restrict__ V, const int* __restrict__ lengths,
                        T* __restrict__ O, float* __restrict__ LSE, int Hkv, int S,
                        float scale) {
  constexpr int DPL = D / 32;  // PV columns per lane
  __shared__ __align__(16) float sQ[G][D];
  __shared__ float sM[DEC_WARPS][G];
  __shared__ float sL[DEC_WARPS][G];
  __shared__ float sAcc[DEC_WARPS][G][D];

  const int bh = blockIdx.x;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int Hq = Hkv * G;
  const T* Qp = Q + ((size_t)b * Hq + (size_t)hk * G) * D;  // the group's G heads
  const T* Kp = K + (size_t)bh * S * D;
  const T* Vp = V + (size_t)bh * S * D;
  const int len = max(0, min(lengths[b], S));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < G * D; i += DEC_THREADS) sQ[i / D][i % D] = to_float(Qp[i]);
  __syncthreads();

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.f;
  }

  for (int t0 = warp * DEC_TILE; t0 < len; t0 += DEC_WARPS * DEC_TILE) {
    const int key = t0 + lane;
    const bool valid = key < len;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (valid) {
      const T* kr = Kp + (size_t)key * D;
#pragma unroll
      for (int c = 0; c < D; c += 8) {
        float kv[8];
        load_vec<8>(kr + c, kv);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 qa = *reinterpret_cast<const float4*>(&sQ[g][c]);
          const float4 qb = *reinterpret_cast<const float4*>(&sQ[g][c + 4]);
          s[g] = fmaf(qa.x, kv[0], s[g]);
          s[g] = fmaf(qa.y, kv[1], s[g]);
          s[g] = fmaf(qa.z, kv[2], s[g]);
          s[g] = fmaf(qa.w, kv[3], s[g]);
          s[g] = fmaf(qb.x, kv[4], s[g]);
          s[g] = fmaf(qb.y, kv[5], s[g]);
          s[g] = fmaf(qb.z, kv[6], s[g]);
          s[g] = fmaf(qb.w, kv[7], s[g]);
        }
      }
    }
    float p[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float x = valid ? s[g] * scale : NEG_INF;
      const float mx = fmaxf(m[g], warp_max(x));  // finite: lane 0's key is valid
      const float alpha = expf(m[g] - mx);
      const float pg = expf(x - mx);
      l[g] = l[g] * alpha + warp_sum(pg);
      m[g] = mx;
      p[g] = round_to<T>(pg);
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[g][j] *= alpha;
    }
    const int nv = min(DEC_TILE, len - t0);
    for (int kk = 0; kk < nv; ++kk) {
      float vv[DPL];
      load_vec<DPL>(Vp + (size_t)(t0 + kk) * D + lane * DPL, vv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pk = __shfl_sync(0xffffffffu, p[g], kk);
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[g][j] = fmaf(pk, vv[j], acc[g][j]);
      }
    }
  }

  // Merge the warps' partial softmax states.
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      sM[warp][g] = m[g];
      sL[warp][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < DPL; ++j) sAcc[warp][g][lane * DPL + j] = acc[g][j];
  __syncthreads();

  for (int i = threadIdx.x; i < G * D; i += DEC_THREADS) {
    const int g = i / D, d = i % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) mx = fmaxf(mx, sM[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float f = expf(sM[w][g] - mx);
      lsum = fmaf(sL[w][g], f, lsum);
      a = fmaf(sAcc[w][g][d], f, a);
    }
    const int row = b * Hq + hk * G + g;
    O[(size_t)row * D + d] = from_float<T>(a / (lsum == 0.f ? 1.f : lsum));
    if (LSE != nullptr && d == 0)
      LSE[row] = lsum == 0.f ? NEG_INF : mx + logf(fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch_g(int G, const void* q, const void* k, const void* v, const int* lengths,
                     void* o, float* lse, int B, int Hkv, int S, float scale,
                     cudaStream_t stream) {
  const dim3 grid(B * Hkv);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(o);
  switch (G) {
    case 1: flash_decode_kernel<T, D, 1><<<grid, DEC_THREADS, 0, stream>>>(qq, kk, vv, lengths, oo, lse, Hkv, S, scale); break;
    case 2: flash_decode_kernel<T, D, 2><<<grid, DEC_THREADS, 0, stream>>>(qq, kk, vv, lengths, oo, lse, Hkv, S, scale); break;
    case 4: flash_decode_kernel<T, D, 4><<<grid, DEC_THREADS, 0, stream>>>(qq, kk, vv, lengths, oo, lse, Hkv, S, scale); break;
    case 8: flash_decode_kernel<T, D, 8><<<grid, DEC_THREADS, 0, stream>>>(qq, kk, vv, lengths, oo, lse, Hkv, S, scale); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, int G, const void* q, const void* k, const void* v,
                     const int* lengths, void* o, float* lse, int B, int Hkv, int S,
                     float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_g<T, 32>(G, q, k, v, lengths, o, lse, B, Hkv, S, scale, stream);
    case 64: return launch_g<T, 64>(G, q, k, v, lengths, o, lse, B, Hkv, S, scale, stream);
    case 128: return launch_g<T, 128>(G, q, k, v, lengths, o, lse, B, Hkv, S, scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o: (B, Hq, D); k, v: (B, Hkv, S, D); lengths: (B,) int32; lse: (B, Hq)
// fp32 or NULL. All contiguous on one device. dtype: 0 = fp32, 1 = bf16.
// D in {32, 64, 128}, Hq / Hkv in {1, 2, 4, 8}. Returns cudaGetLastError().
extern "C" int tdt_flash_decode(const void* q, const void* k, const void* v, const void* lengths,
                                void* o, void* lse, int B, int Hq, int Hkv, int S, int D,
                                float scale, int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv;
  const int* len = static_cast<const int*>(lengths);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_d<bf16>(D, G, q, k, v, len, o, l, B, Hkv, S, scale, s);
  if (dtype == 0) return launch_d<float>(D, G, q, k, v, len, o, l, B, Hkv, S, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

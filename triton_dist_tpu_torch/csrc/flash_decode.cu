// One-token GQA flash decode for Hopper, over a padded cache or a paged
// block pool.
//
// Replaces two TPU kernels of triton_dist_tpu/kernels/flash_decode.py:
// `_decode_kernel` (:71, launched by `flash_decode`, pallas_call at :169)
// and `_paged_decode_kernel` (:205, launched by `paged_flash_decode`,
// pallas_call at :460). Both compute the same function: q (B, Hq, D)
// attends over the first lengths[b] keys of its sequence, online softmax in
// the natural-exp domain, P cast to V's dtype before the PV product, o
// (B, Hq, D) and lse (B, Hq) fp32 in nats, with o = 0 and lse = -1e30 where
// a row has no key. They differ only in where key t of sequence b lives:
//
//   padded cache k, v (B, Hkv, S, D):            k[b, h, t]
//   block pool  k, v (num_blocks, Hkv, bs, D):   k[tables[b, t / bs], h, t % bs]
//
// What bounds it on the H100: the cache. Every valid K and V row is read
// once and used by the G = Hq / Hkv query heads of its group, about G
// FLOP per byte (4 at Qwen3-8B, 8 at Qwen3-30B-A3B), far below the ~295
// FLOP/byte ridge: HBM bandwidth bounds it, at sum(lengths) * Hkv * D * 4
// bytes (bf16, K and V). The block table adds max_blocks * 4 bytes a block.
//
// Design. One sweep, `decode_sweep`, templated on how it finds a row: a
// row pointer for the padded cache, a table lookup for the pool (the block
// loads its row of the table into shared memory first). So the paged kernel
// visits the keys in the same partition and order as the padded one and
// does the same arithmetic: on the gathered view of a pool the two give the
// same bits. Rows at or past lengths[b] are never read, so a table's NULL
// tail is never touched. One block per (b, kv head); the G query rows of
// the group sit in shared memory, so a K/V row read from memory serves all
// G heads and no head's cache is read twice. The TPU kernel's sequential
// KV grid axis is a loop inside the block: 8 warps take 32-key tiles in
// turn up to lengths[b] (tiles past the end are never read). In a tile a
// lane owns one key for QK^T (vector loads of its K row; with a pool every
// lane looks its own K and V rows up, so a tile may straddle pool blocks)
// and D/32 columns for PV, taking row kk's address from lane kk with a
// shuffle; each warp keeps its own running max/sum and the 8
// partial results are merged through shared memory at the end. At the main
// path's batch of 4 with 8 kv heads this launches 32 blocks on 132 SMs (16
// with Qwen3-30B-A3B's 4), so it sits well under the bandwidth bound:
// splitting the KV sweep across blocks (split-KV with a combine pass) is
// the fix, left for a later change.
//
// Row 3b: `_paged_decode_quant_kernel` (flash_decode.py:275, the same
// launcher) walks a quantized pool: int8 or fp8 e4m3 payload blocks beside
// a parallel pool of f32 row scales (models/quant.py), both found through
// the same table entry. `paged_decode_quant_kernel` is the third row
// policy of the one sweep: it looks the block up as the paged kernel does,
// loads the 1-byte row and that row's scale, and dequantizes q * scale
// into fp32 registers before QK^T and before PV. The scales are powers of
// two, so the dequantized value is exact in fp32 and in bf16: the walk
// equals row 3 on the pool dequantized to q's dtype, bit for bit, since it
// visits the keys in the same partition and order and rounds P to q's
// dtype as row 3 rounds it to V's. (The TPU kernel keeps P in f32 against
// f32 V; for an fp32 model the two are the same function.) Bound: the
// bytes, now sum(lengths) * Hkv * (D + 4) * 2 (1-byte payload and a 4-byte
// scale a row, K and V): 132 bytes a row a head at D = 128 against row 3's
// 256, so its bound is about 0.516 of row 3's.

#include "common.cuh"
#include "quant.cuh"

using namespace tdt;

namespace {

constexpr int DEC_WARPS = 8;
constexpr int DEC_THREADS = DEC_WARPS * 32;
constexpr int DEC_TILE = 32;  // keys per warp step, one per lane

// A K or V row as the sweep reads it: its address and, in a quantized
// pool, its scale (unused otherwise).
template <typename P>
struct RowRef {
  const P* p;
  float s;
};

// N values of row r from column c, widened (and dequantized) to fp32.
template <int N, typename P>
__device__ __forceinline__ void load_row(const RowRef<P>& r, int c, float (&out)[N]) {
  if constexpr (is_wire<P>::value)
    load_dequant<N>(r.p + c, r.s, out);
  else
    load_vec<N>(r.p + c, out);
}

// Lane src's row.
template <typename P>
__device__ __forceinline__ RowRef<P> shfl_row(const RowRef<P>& r, int src) {
  RowRef<P> out;
  out.p = reinterpret_cast<const P*>(
      __shfl_sync(0xffffffffu, reinterpret_cast<unsigned long long>(r.p), src));
  out.s = 1.f;
  if constexpr (is_wire<P>::value) out.s = __shfl_sync(0xffffffffu, r.s, src);
  return out;
}

// Key t of a padded cache: base points at row 0 of this (b, kv head).
template <typename T, int D>
struct PaddedRows {
  const T* base;
  __device__ __forceinline__ RowRef<T> operator()(int t) const { return {base + (size_t)t * D, 1.f}; }
};

// Key t of a block pool: the table row of this sequence (in shared memory)
// names the physical block; head_off selects the kv head inside it.
template <typename T, int D>
struct PoolRows {
  const T* pool;
  const int* table;
  int bs;
  size_t block_stride;  // Hkv * bs * D
  size_t head_off;      // h * bs * D
  __device__ __forceinline__ RowRef<T> operator()(int t) const {
    return {pool + (size_t)table[t / bs] * block_stride + head_off + (size_t)(t % bs) * D, 1.f};
  }
};

// Key t of a quantized block pool: the payload row as in PoolRows, and its
// scale from the scale pool (num_blocks, Hkv, bs, 1) through the same table
// entry.
template <typename P, int D>
struct QuantPoolRows {
  const P* pool;
  const float* scales;
  const int* table;
  int bs;
  int Hkv;
  int h;
  __device__ __forceinline__ RowRef<P> operator()(int t) const {
    const size_t row = ((size_t)table[t / bs] * Hkv + h) * bs + t % bs;  // the row's index in the scale pool
    return {pool + row * D, scales[row]};
  }
};

// The decode of one (b, kv head): the G query heads at Qp over keys
// [0, len), writing their G rows of o (and lse) at row index row0. T is
// q's and o's dtype; P rounds to it before PV.
template <typename T, int D, int G, typename Rows>
__device__ __forceinline__ void decode_sweep(const T* __restrict__ Qp, Rows krow, Rows vrow,
                                             int len, T* __restrict__ O, float* __restrict__ LSE,
                                             int row0, float scale) {
  constexpr int DPL = D / 32;  // PV columns per lane
  __shared__ __align__(16) float sQ[G][D];
  __shared__ float sM[DEC_WARPS][G];
  __shared__ float sL[DEC_WARPS][G];
  __shared__ float sAcc[DEC_WARPS][G][D];

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
    // Each lane finds its key's V row once; the PV loop takes row kk from
    // lane kk, so no table lookup sits in front of its loads.
    const auto vr_lane = valid ? vrow(key) : decltype(vrow(0)){nullptr, 1.f};
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (valid) {
      const auto kr = krow(key);
#pragma unroll
      for (int c = 0; c < D; c += 8) {
        float kv[8];
        load_row<8>(kr, c, kv);
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
      l[g] = fmaf(l[g], alpha, warp_sum(pg));
      m[g] = mx;
      p[g] = round_to<T>(pg);
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[g][j] *= alpha;
    }
    const int nv = min(DEC_TILE, len - t0);
    for (int kk = 0; kk < nv; ++kk) {
      float vv[DPL];
      load_row<DPL>(shfl_row(vr_lane, kk), lane * DPL, vv);
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
    const int row = row0 + g;
    O[(size_t)row * D + d] = from_float<T>(a / (lsum == 0.f ? 1.f : lsum));
    if (LSE != nullptr && d == 0)
      LSE[row] = lsum == 0.f ? NEG_INF : mx + logf(fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(DEC_THREADS)
    flash_decode_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                        const T* __restrict__ V, const int* __restrict__ lengths,
                        T* __restrict__ O, float* __restrict__ LSE, int Hkv, int S,
                        float scale) {
  const int bh = blockIdx.x;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int row0 = b * Hkv * G + hk * G;  // the group's G heads
  const int len = max(0, min(lengths[b], S));
  decode_sweep<T, D, G>(Q + (size_t)row0 * D, PaddedRows<T, D>{K + (size_t)bh * S * D},
                        PaddedRows<T, D>{V + (size_t)bh * S * D}, len, O, LSE, row0, scale);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(DEC_THREADS)
    paged_decode_kernel(const T* __restrict__ Q, const T* __restrict__ KP,
                        const T* __restrict__ VP, const int* __restrict__ tables,
                        const int* __restrict__ lengths, T* __restrict__ O,
                        float* __restrict__ LSE, int Hkv, int bs, int max_blocks, float scale) {
  extern __shared__ int s_table[];  // this sequence's row of the block table
  const int bh = blockIdx.x;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int row0 = b * Hkv * G + hk * G;
  for (int i = threadIdx.x; i < max_blocks; i += DEC_THREADS)
    s_table[i] = tables[(size_t)b * max_blocks + i];
  // decode_sweep's first barrier orders these stores before any lookup.
  const int len = max(0, min(lengths[b], max_blocks * bs));
  const size_t block_stride = (size_t)Hkv * bs * D, head_off = (size_t)hk * bs * D;
  decode_sweep<T, D, G>(Q + (size_t)row0 * D,
                        PoolRows<T, D>{KP, s_table, bs, block_stride, head_off},
                        PoolRows<T, D>{VP, s_table, bs, block_stride, head_off}, len, O, LSE,
                        row0, scale);
}

template <typename T, typename P, int D, int G>
__global__ void __launch_bounds__(DEC_THREADS)
    paged_decode_quant_kernel(const T* __restrict__ Q, const P* __restrict__ KP,
                              const P* __restrict__ VP, const float* __restrict__ KS,
                              const float* __restrict__ VS, const int* __restrict__ tables,
                              const int* __restrict__ lengths, T* __restrict__ O,
                              float* __restrict__ LSE, int Hkv, int bs, int max_blocks,
                              float scale) {
  extern __shared__ int s_table[];  // this sequence's row of the block table
  const int bh = blockIdx.x;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int row0 = b * Hkv * G + hk * G;
  for (int i = threadIdx.x; i < max_blocks; i += DEC_THREADS)
    s_table[i] = tables[(size_t)b * max_blocks + i];
  const int len = max(0, min(lengths[b], max_blocks * bs));
  decode_sweep<T, D, G>(Q + (size_t)row0 * D, QuantPoolRows<P, D>{KP, KS, s_table, bs, Hkv, hk},
                        QuantPoolRows<P, D>{VP, VS, s_table, bs, Hkv, hk}, len, O, LSE, row0,
                        scale);
}

// Everything a launch needs; `tables` is null for the padded cache, `ks`
// and `vs` (the scale pools) are null but for a quantized pool.
struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *tables, *lengths;
  void* o;
  float* lse;
  int B, Hkv, S, bs, max_blocks;
  float scale;
  int wire;
};

template <typename T, typename P, int D, int G>
cudaError_t launch_quant(const Args& a, cudaStream_t s) {
  const int smem = a.max_blocks * (int)sizeof(int);
  if (smem > 8 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(paged_decode_quant_kernel<T, P, D, G>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  paged_decode_quant_kernel<T, P, D, G><<<a.B * a.Hkv, DEC_THREADS, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const P*>(a.k), static_cast<const P*>(a.v), a.ks,
      a.vs, a.tables, a.lengths, static_cast<T*>(a.o), a.lse, a.Hkv, a.bs, a.max_blocks,
      a.scale);
  return cudaGetLastError();
}

template <typename T, int D, int G>
cudaError_t launch_one(const Args& a, cudaStream_t s) {
  const dim3 grid(a.B * a.Hkv);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);
  if (a.ks != nullptr) {
    if (a.wire == WIRE_INT8) return launch_quant<T, int8_t, D, G>(a, s);
    if (a.wire == WIRE_FP8) return launch_quant<T, fp8e4m3, D, G>(a, s);
    return cudaErrorInvalidValue;
  }
  if (a.tables == nullptr) {
    flash_decode_kernel<T, D, G><<<grid, DEC_THREADS, 0, s>>>(q, k, v, a.lengths, o, a.lse, a.Hkv,
                                                               a.S, a.scale);
    return cudaGetLastError();
  }
  // The table row beside the sweep's static tiles (under 37 KB): past
  // 48 KB in all the block needs the opt-in.
  const int smem = a.max_blocks * (int)sizeof(int);
  if (smem > 8 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T, D, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  paged_decode_kernel<T, D, G><<<grid, DEC_THREADS, smem, s>>>(
      q, k, v, a.tables, a.lengths, o, a.lse, a.Hkv, a.bs, a.max_blocks, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(int G, const Args& a, cudaStream_t s) {
  switch (G) {
    case 1: return launch_one<T, D, 1>(a, s);
    case 2: return launch_one<T, D, 2>(a, s);
    case 4: return launch_one<T, D, 4>(a, s);
    case 8: return launch_one<T, D, 8>(a, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_d(int D, int G, const Args& a, cudaStream_t s) {
  switch (D) {
    case 32: return launch_g<T, 32>(G, a, s);
    case 64: return launch_g<T, 64>(G, a, s);
    case 128: return launch_g<T, 128>(G, a, s);
  }
  return cudaErrorInvalidValue;
}

int dispatch(const Args& a, int Hq, int D, int dtype, void* stream) {
  if (a.Hkv <= 0 || Hq % a.Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / a.Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return static_cast<int>(launch_d<bf16>(D, G, a, s));
  if (dtype == 0) return static_cast<int>(launch_d<float>(D, G, a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, o: (B, Hq, D); k, v: (B, Hkv, S, D); lengths: (B,) int32; lse: (B, Hq)
// fp32 or NULL. All contiguous on one device. dtype: 0 = fp32, 1 = bf16.
// D in {32, 64, 128}, Hq / Hkv in {1, 2, 4, 8}. Returns cudaGetLastError().
extern "C" int tdt_flash_decode(const void* q, const void* k, const void* v, const void* lengths,
                                void* o, void* lse, int B, int Hq, int Hkv, int S, int D,
                                float scale, int dtype, void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, static_cast<const int*>(lengths), o,
               static_cast<float*>(lse), B, Hkv, S, 0, 0, scale, 0};
  return dispatch(a, Hq, D, dtype, stream);
}

// q, o: (B, Hq, D); k_pool, v_pool: (num_blocks, Hkv, bs, D); tables:
// (B, max_blocks) int32 block ids below num_blocks for every block a
// sequence's first lengths[b] keys touch; lengths: (B,) int32; lse: (B, Hq)
// fp32 or NULL. Keys past max_blocks * bs are never read. All contiguous on
// one device. dtype, D and Hq / Hkv as tdt_flash_decode; max_blocks <=
// 16384. Returns cudaGetLastError().
extern "C" int tdt_paged_flash_decode(const void* q, const void* k_pool, const void* v_pool,
                                      const void* tables, const void* lengths, void* o, void* lse,
                                      int B, int Hq, int Hkv, int bs, int max_blocks, int D,
                                      float scale, int dtype, void* stream) {
  if (tables == nullptr || bs <= 0 || max_blocks <= 0 || max_blocks > 16384)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pool, v_pool, nullptr, nullptr, static_cast<const int*>(tables),
               static_cast<const int*>(lengths), o, static_cast<float*>(lse), B, Hkv, 0, bs,
               max_blocks, scale, 0};
  return dispatch(a, Hq, D, dtype, stream);
}

// Row 3b: as tdt_paged_flash_decode over a quantized pool. k_pool, v_pool:
// (num_blocks, Hkv, bs, D) int8 (wire 0) or fp8 e4m3 (wire 1); k_scale,
// v_scale: (num_blocks, Hkv, bs, 1) f32. q, o in fp32 (dtype 0) or bf16
// (dtype 1). Returns cudaGetLastError().
extern "C" int tdt_paged_flash_decode_quant(const void* q, const void* k_pool, const void* v_pool,
                                            const void* k_scale, const void* v_scale,
                                            const void* tables, const void* lengths, void* o,
                                            void* lse, int B, int Hq, int Hkv, int bs,
                                            int max_blocks, int D, float scale, int dtype, int wire,
                                            void* stream) {
  if (tables == nullptr || k_scale == nullptr || v_scale == nullptr || bs <= 0 ||
      max_blocks <= 0 || max_blocks > 16384)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), static_cast<const int*>(tables),
               static_cast<const int*>(lengths), o, static_cast<float*>(lse), B, Hkv, 0, bs,
               max_blocks, scale, wire};
  return dispatch(a, Hq, D, dtype, stream);
}

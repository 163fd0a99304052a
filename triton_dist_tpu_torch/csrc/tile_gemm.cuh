// One 64 x 64 output tile of C = A @ B (and, with NB = 2, of A @ B1 beside
// it), accumulated in fp32: the GEMM core of the collective matmuls.
//
// A: `rows` (<= 64) rows of K values from `A` (row stride K); B: (K, N)
// row-major, columns [n0, n0 + 64). Ragged rows, K and N are masked (zero
// filled). The caller's epilogue gets each thread's results as pairs of
// adjacent columns: f(r, c, v) with r, c relative to the tile and v[b][0..1]
// the fp32 sums of operand b at columns c and c + 1.
//
// A may also be quantized (QuantA: int8 or fp8 e4m3 rows with one f32
// scale a row, models/quant.py): each A value is dequantized exactly,
// q * scale in fp32, as it is staged into shared memory, and then rounded to
// T (exact too: at most 8 significant bits times a power of two), so the
// tile computes the same bits as on the dequantized A in T. The quantized
// stage is a plain 8-byte load and a 16-byte shared store (no cp.async).
//
// bf16: 4 warps in a 2 x 2 arrangement of 32 x 32 warp tiles, warp-level
// mma.sync m16n8k16 with fp32 accumulators, the K sweep staged through a
// 3-stage cp.async ring of 64-deep steps (csrc/group_gemm.cu's tile; needs
// K % 8 == 0 and N % 8 == 0 for its 16-byte copies). A warp skips its 16-row
// m tiles that lie wholly past `rows`. fp32: the tensor cores have no fp32
// mode, so 256 threads, each 4 rows x 2 column pairs per operand, with the K
// sweep staged through shared memory 16 deep.
#pragma once

#include "common.cuh"
#include "quant.cuh"

namespace tdt {

constexpr int TILE_M = 64;
constexpr int TILE_N = 64;

// Where a tile's A rows come from: `rows` rows of K values at p (row stride
// K), or quantized rows q (row stride K) with their scales (one a row).
// Both may lie in another rank's heap: they are read through L2.
template <typename T>
struct PlainA {
  const T* p;
};
template <typename P>
struct QuantA {
  const P* q;
  const float* scale;
};

// Element (r, k) of A as fp32.
template <typename T>
__device__ __forceinline__ float a_value(const PlainA<T>& a, int r, int K, int k) {
  return __ldcg(a.p + (size_t)r * K + k);
}
template <typename P>
__device__ __forceinline__ float a_value(const QuantA<P>& a, int r, int K, int k) {
  const unsigned char b = __ldcg(reinterpret_cast<const unsigned char*>(a.q) + (size_t)r * K + k);
  return wire_byte_to_float<P>(b) * __ldcg(a.scale + r);
}

template <typename T, int NB>
struct TileGemm;

// ------------------------------------------------------------- bf16, mma

namespace tile_detail {

constexpr int BK = 64;
constexpr int LDS = BK + 8;       // row stride of the A tile (elements)
constexpr int LDW = TILE_N + 8;   // row stride of the B tiles (elements)
constexpr int NSTAGE = 3;
constexpr int A_TILE = TILE_M * LDS;
constexpr int W_TILE = BK * LDW;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared through L2 (cg: the data may have been
// written by another rank); src_bytes = 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace tile_detail

template <int NB>
struct TileGemm<bf16, NB> {
  static constexpr int THREADS = 128;
  static constexpr int STAGE = tile_detail::A_TILE + NB * tile_detail::W_TILE;  // elements
  static constexpr int SMEM_BYTES = tile_detail::NSTAGE * STAGE * 2;

  float acc[NB][2][4][4];

  // Eight A values (row r, columns k..k+7) into shared memory at dst;
  // zeros where !ok.
  __device__ __forceinline__ static void stage_a(bf16* dst, const PlainA<bf16>& a, int r, int K, int k, bool ok) {
    tile_detail::cp_async16(dst, ok ? a.p + (size_t)r * K + k : a.p, ok ? 16 : 0);
  }
  template <typename P>
  __device__ __forceinline__ static void stage_a(bf16* dst, const QuantA<P>& a, int r, int K, int k, bool ok) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (ok) {
      const uint2 u = __ldcg(reinterpret_cast<const uint2*>(a.q + (size_t)r * K + k));
      float f[8];
      const float sc = __ldcg(a.scale + r);
      dequant4<P>(u.x, sc, f);
      dequant4<P>(u.y, sc, f + 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
        w[j] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }

  template <typename A>
  __device__ __forceinline__ void load_stage(bf16* s, const A& a, int rows, int K, const bf16* const (&B)[NB],
                                             int N, int n0, int k0) {
    using namespace tile_detail;
    constexpr int CPR = BK / 8;  // 16-byte chunks per row (BK == TILE_N)
    for (int c = threadIdx.x; c < TILE_M * CPR; c += THREADS) {
      const int r = c / CPR, cc = (c % CPR) * 8;
      stage_a(s + r * LDS + cc, a, r, K, k0 + cc, r < rows && k0 + cc < K);
    }
    for (int c = threadIdx.x; c < BK * CPR; c += THREADS) {
      const int r = c / CPR, cc = (c % CPR) * 8;
      const bool ok = k0 + r < K && n0 + cc < N;
      const size_t off = ok ? (size_t)(k0 + r) * N + n0 + cc : 0;
#pragma unroll
      for (int b = 0; b < NB; ++b) cp_async16(s + A_TILE + b * W_TILE + r * LDW + cc, B[b] + off, ok ? 16 : 0);
    }
  }

  // smem: SMEM_BYTES of dynamic shared memory, 16-byte aligned.
  __device__ void run(const bf16* A, int rows, int K, const bf16* const (&B)[NB], int N, int n0, bf16* smem) {
    run_a(PlainA<bf16>{A}, rows, K, B, N, n0, smem);
  }

  template <typename AS>
  __device__ void run_a(const AS& A, int rows, int K, const bf16* const (&B)[NB], int N, int n0, bf16* smem) {
    using namespace tile_detail;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    const int g = lane >> 2, t = lane & 3;
    const bool live0 = wm < rows, live1 = wm + 16 < rows;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[b][i][j][q] = 0.f;

    const int nk = (K + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) {
      if (s < nk) load_stage(smem + s * STAGE, A, rows, K, B, N, n0, s * BK);
      cp_async_commit();
    }
    const int ld_k = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int ld_n = (lane >> 4) * 8;
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();
      const int next = kt + NSTAGE - 1;
      if (next < nk) load_stage(smem + (next % NSTAGE) * STAGE, A, rows, K, B, N, n0, next * BK);
      cp_async_commit();
      const bf16* sa = smem + (kt % NSTAGE) * STAGE;
      if (!live0) continue;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const bf16* p0 = sa + (wm + i * 16 + g) * LDS + kk + t * 2;
          const bf16* p1 = p0 + 8 * LDS;
          a[i][0] = *reinterpret_cast<const uint32_t*>(p0);
          a[i][1] = *reinterpret_cast<const uint32_t*>(p1);
          a[i][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
          a[i][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
        }
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const bf16* sw = sa + A_TILE + b * W_TILE;
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            uint32_t bw[4];
            ldmatrix_x4_trans(bw, sw + (kk + ld_k) * LDW + wn + jp * 16 + ld_n);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              mma16816(acc[b][0][jp * 2 + h], a[0], bw[2 * h], bw[2 * h + 1]);
              if (live1) mma16816(acc[b][1][jp * 2 + h], a[1], bw[2 * h], bw[2 * h + 1]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
  }

  // c0, c1 at (row g, cols 2t, 2t + 1) of each 16 x 8 piece; c2, c3 at row g + 8.
  template <class F>
  __device__ __forceinline__ void epilogue(int rows, int N, int n0, F&& f) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + j * 8 + t * 2;
        if (n0 + c >= N) continue;  // N % 8 == 0, so c + 1 is in range too
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm + i * 16 + g + h * 8;
          if (r >= rows) continue;
          float v[NB][2];
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            v[b][0] = acc[b][i][j][2 * h];
            v[b][1] = acc[b][i][j][2 * h + 1];
          }
          f(r, c, v);
        }
      }
  }
};

// ------------------------------------------------------------------ SIMT

template <int NB>
struct TileGemm<float, NB> {
  static constexpr int THREADS = 256;
  static constexpr int BK = 16;
  static constexpr int SMEM_BYTES = (BK * (TILE_M + 4) + NB * BK * TILE_N) * 4;

  float acc[NB][4][4];  // rows 4ty + i; columns 2tx, 2tx + 1, 32 + 2tx, 33 + 2tx

  __device__ void run(const float* A, int rows, int K, const float* const (&B)[NB], int N, int n0, float* smem) {
    run_a(PlainA<float>{A}, rows, K, B, N, n0, smem);
  }

  template <typename AS>
  __device__ void run_a(const AS& A, int rows, int K, const float* const (&B)[NB], int N, int n0, float* smem) {
    float* sa = smem;                      // [BK][TILE_M + 4], A transposed
    float* sb = smem + BK * (TILE_M + 4);  // [NB][BK][TILE_N]
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[b][i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += BK) {
      __syncthreads();  // every thread is done with the previous step
      for (int i = threadIdx.x; i < TILE_M * BK; i += THREADS) {
        const int r = i / BK, k = i % BK;
        sa[k * (TILE_M + 4) + r] = (r < rows && k0 + k < K) ? a_value(A, r, K, k0 + k) : 0.f;
      }
      for (int i = threadIdx.x; i < BK * TILE_N; i += THREADS) {
        const int k = i / TILE_N, c = i % TILE_N;
        const bool ok = k0 + k < K && n0 + c < N;
#pragma unroll
        for (int b = 0; b < NB; ++b) sb[(b * BK + k) * TILE_N + c] = ok ? B[b][(size_t)(k0 + k) * N + n0 + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sa[k * (TILE_M + 4) + 4 * ty + i];
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float* w = sb + (b * BK + k) * TILE_N;
          const float w0 = w[2 * tx], w1 = w[2 * tx + 1], w2 = w[32 + 2 * tx], w3 = w[33 + 2 * tx];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[b][i][0] = fmaf(a[i], w0, acc[b][i][0]);
            acc[b][i][1] = fmaf(a[i], w1, acc[b][i][1]);
            acc[b][i][2] = fmaf(a[i], w2, acc[b][i][2]);
            acc[b][i][3] = fmaf(a[i], w3, acc[b][i][3]);
          }
        }
      }
    }
  }

  template <class F>
  __device__ __forceinline__ void epilogue(int rows, int N, int n0, F&& f) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      if (r >= rows) continue;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int c = p * 32 + 2 * tx;
        if (n0 + c >= N) continue;  // N is even, so c + 1 is in range too
        float v[NB][2];
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          v[b][0] = acc[b][i][2 * p];
          v[b][1] = acc[b][i][2 * p + 1];
        }
        f(r, c, v);
      }
    }
  }
};

}  // namespace tdt

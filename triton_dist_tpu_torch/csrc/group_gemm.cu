// Grouped gate/up GEMM with a fused SwiGLU epilogue, for Hopper.
//
// Replaces the TPU kernel `_group_swiglu_kernel` (triton_dist_tpu/kernels/group_gemm.py:38,
// launched by `group_gemm_swiglu`, pallas_call at :75). For every expert e:
//
//   out[e] = (silu(x[e] @ wg[e]) * (x[e] @ wu[e])).astype(x.dtype)
//
// with x (E, C, d), wg and wu (E, d, f), out (E, C, f), all row-major. Both
// products accumulate in fp32 over d; silu(g) = g * sigmoid(g) and the
// product with u are taken on the fp32 accumulators, and the result is
// rounded once.
//
// What bounds it on the H100: the weights. Every launch reads all E
// experts' gate and up slabs (at Qwen3-30B-A3B's E = 128, d = 2048, f = 768
// in bf16, 805 MB: 0.240 ms at 3.35 TB/s), whatever C is; at the served
// capacities (C = 8 in decode, up to 192 in prefill) the products need
// fewer than 160 GFLOP, under 0.16 ms at 989 TFLOP/s. So the kernel is a
// streaming read of the weights, and the tensor-core work rides along.
//
// Design. The TPU kernel walks d as a sequential grid axis with its two
// accumulators in VMEM scratch; here the grid is (f tiles, C tiles, E), all
// in parallel, and the d sweep is a loop inside the block.
//
// * bf16: a block owns a 64 x 64 tile of out for one expert, with 4 warps
//   in a 2 x 2 arrangement of 32 x 32 warp tiles. Per 64-deep step of d it
//   stages the x tile and the wg and wu tiles in shared memory through a
//   3-stage cp.async ring (16-byte copies; a copy past the edge of C, d or f
//   fills zeros), so two steps of weights are in flight while one is used.
//   The products run on the tensor cores as warp-level mma.sync m16n8k16
//   with fp32 accumulators: the A fragment of x is loaded once and feeds
//   both the gate and the up product; the weights are (d, f) row-major, so
//   their B fragments come from ldmatrix.x4.trans. Rows of the staged tiles
//   are padded by 8 elements, which keeps ldmatrix and the fragment reads
//   free of bank conflicts. A warp skips its 16-row m tiles that lie wholly
//   past C (at decode C = 8, so three of a block's four m tiles), but every
//   weight tile is read in full. What it does not do yet: wgmma, TMA, or
//   skipping experts that no token was routed to.
// * fp32: the tensor cores have no fp32 mode, so a SIMT kernel: a block of
//   256 threads owns a 32 x 64 tile, each thread 2 rows x 4 columns of both
//   accumulators, with the d sweep staged through shared memory.
//
// Any C is taken (the ragged edge is masked); bf16 needs d and f to be
// multiples of 8 (16-byte rows).

#include "common.cuh"

using namespace tdt;

namespace {

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

// --------------------------------------------------------- bf16, mma.sync

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int LDS = BK + 8;   // row stride of the x tile (elements)
constexpr int LDW = BN + 8;   // row stride of the weight tiles (elements)
constexpr int NSTAGE = 3;
constexpr int THREADS = 128;
constexpr int X_TILE = BM * LDS;  // elements
constexpr int W_TILE = BK * LDW;
constexpr int STAGE = X_TILE + 2 * W_TILE;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes = 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
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

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// Stage the k-th 64-deep step: x rows [m0, m0 + BM) x cols [k0, k0 + BK),
// and wg, wu rows [k0, k0 + BK) x cols [n0, n0 + BN). Out-of-range chunks
// are zero-filled (and their source address is clamped to the tile base).
__device__ __forceinline__ void load_stage(bf16* s, const bf16* X, const bf16* Wg,
                                           const bf16* Wu, int m0, int n0, int k0, int C,
                                           int d, int f) {
  constexpr int CPR = BK / 8;  // 16-byte chunks per row (BK == BN)
  bf16* sx = s;
  bf16* sg = s + X_TILE;
  bf16* su = sg + W_TILE;
  for (int c = threadIdx.x; c < BM * CPR; c += THREADS) {
    const int r = c / CPR, cc = (c % CPR) * 8;
    const bool ok = m0 + r < C && k0 + cc < d;
    const bf16* src = ok ? X + (size_t)(m0 + r) * d + k0 + cc : X;
    cp_async16(sx + r * LDS + cc, src, ok ? 16 : 0);
  }
  for (int c = threadIdx.x; c < BK * CPR; c += THREADS) {
    const int r = c / CPR, cc = (c % CPR) * 8;
    const bool ok = k0 + r < d && n0 + cc < f;
    const size_t off = ok ? (size_t)(k0 + r) * f + n0 + cc : 0;
    cp_async16(sg + r * LDW + cc, Wg + off, ok ? 16 : 0);
    cp_async16(su + r * LDW + cc, Wu + off, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(THREADS)
    group_swiglu_bf16_kernel(const bf16* __restrict__ X, const bf16* __restrict__ Wg,
                             const bf16* __restrict__ Wu, bf16* __restrict__ Out, int C, int d,
                             int f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  X += (size_t)e * C * d;
  Wg += (size_t)e * d * f;
  Wu += (size_t)e * d * f;
  Out += (size_t)e * C * f;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;  // warp tile origin in the block tile
  const int g = lane >> 2, t = lane & 3;
  // m tiles of this warp that hold at least one row < C (warp-uniform).
  const bool live0 = m0 + wm < C, live1 = m0 + wm + 16 < C;

  float acc_g[2][4][4], acc_u[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc_g[i][j][q] = acc_u[i][j][q] = 0.f;

  const int nk = (d + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) load_stage(smem + s * STAGE, X, Wg, Wu, m0, n0, s * BK, C, d, f);
    cp_async_commit();
  }

  // ldmatrix.x4.trans of a (k, n) row-major tile: lane l addresses row
  // k = (l & 7) + 8 * ((l >> 3) & 1) of column block n = 8 * (l >> 4), so
  // registers 0, 1 are the B fragment (k 0-7, 8-15) of n tile 0 and
  // registers 2, 3 that of n tile 1.
  const int ld_k = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int ld_n = (lane >> 4) * 8;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // step kt has landed; every warp is done with step kt - 1
    const int next = kt + NSTAGE - 1;
    if (next < nk) load_stage(smem + (next % NSTAGE) * STAGE, X, Wg, Wu, m0, n0, next * BK, C, d, f);
    cp_async_commit();

    const bf16* sx = smem + (kt % NSTAGE) * STAGE;
    const bf16* sg = sx + X_TILE;
    const bf16* su = sg + W_TILE;
    if (!live0) continue;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bf16* p0 = sx + (wm + i * 16 + g) * LDS + kk + t * 2;
        const bf16* p1 = p0 + 8 * LDS;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p0);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p1);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {  // pairs of 8-column n tiles
        uint32_t bg[4], bu[4];
        const int woff = (kk + ld_k) * LDW + wn + jp * 16 + ld_n;
        ldmatrix_x4_trans(bg, sg + woff);
        ldmatrix_x4_trans(bu, su + woff);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = jp * 2 + h;
          mma16816(acc_g[0][j], a[0], bg[2 * h], bg[2 * h + 1]);
          mma16816(acc_u[0][j], a[0], bu[2 * h], bu[2 * h + 1]);
          if (live1) {
            mma16816(acc_g[1][j], a[1], bg[2 * h], bg[2 * h + 1]);
            mma16816(acc_u[1][j], a[1], bu[2 * h], bu[2 * h + 1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue: c0, c1 at (row g, cols 2t, 2t + 1), c2, c3 at row g + 8.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + j * 8 + t * 2;
      if (col >= f) continue;  // f % 8 == 0, so col + 1 < f too
#pragma unroll
      for (int hrow = 0; hrow < 2; ++hrow) {
        const int row = m0 + wm + i * 16 + g + hrow * 8;
        if (row >= C) continue;
        const float lo = silu_mul(acc_g[i][j][2 * hrow], acc_u[i][j][2 * hrow]);
        const float hi = silu_mul(acc_g[i][j][2 * hrow + 1], acc_u[i][j][2 * hrow + 1]);
        *reinterpret_cast<uint32_t*>(Out + (size_t)row * f + col) = pack_bf16x2(lo, hi);
      }
    }
  }
}

// ------------------------------------------------------------------- SIMT

constexpr int S_BM = 32;
constexpr int S_BN = 64;
constexpr int S_BK = 32;
constexpr int S_THREADS = 256;

__global__ void __launch_bounds__(S_THREADS)
    group_swiglu_f32_kernel(const float* __restrict__ X, const float* __restrict__ Wg,
                            const float* __restrict__ Wu, float* __restrict__ Out, int C, int d,
                            int f) {
  __shared__ float sx[S_BM][S_BK + 1];
  __shared__ float sg[S_BK][S_BN];
  __shared__ float su[S_BK][S_BN];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * S_BM, n0 = blockIdx.x * S_BN;
  X += (size_t)e * C * d;
  Wg += (size_t)e * d * f;
  Wu += (size_t)e * d * f;
  Out += (size_t)e * C * f;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;  // rows 2tr, 2tr+1; cols tc + 16j

  float ag[2][4], au[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ag[i][j] = au[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += S_BK) {
    __syncthreads();  // every thread is done with the previous step
    for (int i = threadIdx.x; i < S_BM * S_BK; i += S_THREADS) {
      const int r = i / S_BK, c = i % S_BK;
      sx[r][c] = (m0 + r < C && k0 + c < d) ? X[(size_t)(m0 + r) * d + k0 + c] : 0.f;
    }
    for (int i = threadIdx.x; i < S_BK * S_BN; i += S_THREADS) {
      const int r = i / S_BN, c = i % S_BN;
      const bool ok = k0 + r < d && n0 + c < f;
      const size_t off = (size_t)(k0 + r) * f + n0 + c;
      sg[r][c] = ok ? Wg[off] : 0.f;
      su[r][c] = ok ? Wu[off] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < S_BK; ++k) {
      const float x0 = sx[2 * tr][k], x1 = sx[2 * tr + 1][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float wg = sg[k][tc + 16 * j], wu = su[k][tc + 16 * j];
        ag[0][j] = fmaf(x0, wg, ag[0][j]);
        ag[1][j] = fmaf(x1, wg, ag[1][j]);
        au[0][j] = fmaf(x0, wu, au[0][j]);
        au[1][j] = fmaf(x1, wu, au[1][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + 2 * tr + i;
    if (row >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tc + 16 * j;
      if (col < f) Out[(size_t)row * f + col] = silu_mul(ag[i][j], au[i][j]);
    }
  }
}

}  // namespace

// x: (E, C, d); wg, wu: (E, d, f); out: (E, C, f). All contiguous on one
// device. dtype: 0 = fp32, 1 = bf16 (then d % 8 == 0 and f % 8 == 0).
// Returns cudaGetLastError() after the launch.
extern "C" int tdt_group_swiglu(const void* x, const void* wg, const void* wu, void* out, int E,
                                int C, int d, int f, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0 || C <= 0 || d <= 0 || f <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    if (d % 8 != 0 || f % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = NSTAGE * STAGE * (int)sizeof(bf16);
    cudaError_t err = cudaFuncSetAttribute(group_swiglu_bf16_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((f + BN - 1) / BN, (C + BM - 1) / BM, E);
    group_swiglu_bf16_kernel<<<grid, THREADS, smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wg), static_cast<const bf16*>(wu),
        static_cast<bf16*>(out), C, d, f);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == 0) {
    const dim3 grid((f + S_BN - 1) / S_BN, (C + S_BM - 1) / S_BM, E);
    group_swiglu_f32_kernel<<<grid, S_THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(wg), static_cast<const float*>(wu),
        static_cast<float*>(out), C, d, f);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

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
// * bf16: a block owns a 64 x 64 tile of out for one expert (the tile core
//   of tile_gemm.cuh, shared with the collective matmuls), with 4 warps
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
#include "tile_gemm.cuh"

using namespace tdt;

namespace {

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

// --------------------------------------------------------- bf16, mma.sync

// One 64 x 64 tile of out for expert blockIdx.z: the gate and up products
// of tile_gemm.cuh's bf16 core, then the SwiGLU on the fp32 sums.
__global__ void __launch_bounds__(TileGemm<bf16, 2>::THREADS)
    group_swiglu_bf16_kernel(const bf16* __restrict__ X, const bf16* __restrict__ Wg,
                             const bf16* __restrict__ Wu, bf16* __restrict__ Out, int C, int d,
                             int f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * TILE_M, n0 = blockIdx.x * TILE_N, rows = min(TILE_M, C - m0);
  const bf16* B[2] = {Wg + (size_t)e * d * f, Wu + (size_t)e * d * f};
  TileGemm<bf16, 2> tile;
  tile.run(X + ((size_t)e * C + m0) * d, rows, d, B, f, n0, reinterpret_cast<bf16*>(smem_raw));
  bf16* o = Out + ((size_t)e * C + m0) * f + n0;
  tile.epilogue(rows, f, n0, [&](int r, int c, const float (&v)[2][2]) {
    *reinterpret_cast<__nv_bfloat162*>(o + (size_t)r * f + c) =
        __floats2bfloat162_rn(silu_mul(v[0][0], v[1][0]), silu_mul(v[0][1], v[1][1]));
  });
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
    const int smem = TileGemm<bf16, 2>::SMEM_BYTES;
    cudaError_t err = cudaFuncSetAttribute(group_swiglu_bf16_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((f + TILE_N - 1) / TILE_N, (C + TILE_M - 1) / TILE_M, E);
    group_swiglu_bf16_kernel<<<grid, TileGemm<bf16, 2>::THREADS, smem, s>>>(
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

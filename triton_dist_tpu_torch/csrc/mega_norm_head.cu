// Final RMSNorm and lm_head in one kernel, for Hopper.
//
// Replaces the TPU kernel `_norm_head_kernel` (triton_dist_tpu/megakernel/kernels.py:581,
// launched by `fused_norm_head`, pallas_call at :613):
//
//   logits (B, V) fp32 = RMSNorm(x) @ lm_head,   x (B, d), lm_head (d, V)
//
// with RMSNorm rounded to x's dtype as the plain version does it.
//
// What bounds it on the H100: the lm_head read. At Qwen3-8B (d = 4096,
// V = 151936, bf16) that is 1.245 GB, 0.372 ms at 3.35 TB/s, against at
// most 10 GFLOP at B = 8.
//
// Design. The TPU kernel walks the vocabulary as a sequential grid axis and
// normalises x once into VMEM; here about two blocks per SM walk the
// 64-column vocab tiles in turn (mega_gemv.cuh), each normalising x once
// into shared memory for all the tiles it takes. Every lm_head element is
// read once, by one thread, with eight 16-byte loads in flight per thread.
// Each tile's sums are complete inside its block, so there is no second
// pass.

#include "mega_gemv.cuh"

using namespace tdt;

namespace {

template <typename T, int NB>
__global__ void __launch_bounds__(MEGA_THREADS)
    norm_head_kernel(const T* __restrict__ X, const T* __restrict__ NW, const T* __restrict__ W,
                     float* __restrict__ Out, int d, int V, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // d x NBP
  __shared__ float s_rinv[MAXB];
  __shared__ float red[MEGA_WARPS][NB][TILE_N];

  row_rinv<T>(X, NB, d, eps, s_rinv);
  stage_norm<T, NB>(X, NW, d, 0, d, s_rinv, xs);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int krow = warp * 4 + (lane >> 3);
  const int ntiles = (V + TILE_N - 1) / TILE_N;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int n0 = tile * TILE_N;
    const int col = n0 + (lane & 7) * VEC;
    float acc[NB][VEC];
    zero_acc(acc);
    tile_dot<T, NB>(W, V, col, col < V, krow, d, 32, xs, acc);
    warp_tile_sums<NB>(acc, red);
    __syncthreads();
    store_tile_sums<NB>(red, n0, V, Out, V);
    __syncthreads();  // red is reused by the next tile
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* nw, const void* w, void* out, int B, int d, int V,
                   int grid, float eps, cudaStream_t s) {
  return with_rows(B, [&](auto rows) {
    constexpr int NB = decltype(rows)::value;
    const int smem = d * padded_rows<NB>() * (int)sizeof(T);
    if (smem > MEGA_MAX_DYN_SMEM) return cudaErrorInvalidValue;
    cudaError_t err = allow_smem(norm_head_kernel<T, NB>, smem);
    if (err != cudaSuccess) return err;
    norm_head_kernel<T, NB><<<grid, MEGA_THREADS, smem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(nw), static_cast<const T*>(w),
        static_cast<float*>(out), d, V, eps);
    return cudaGetLastError();
  });
}

}  // namespace

// x: (B, d); norm_w: (d,); lm_head: (d, V); out: (B, V) fp32. All
// contiguous on one device, x and the weights of one dtype: 0 = fp32,
// 1 = bf16. 1 <= B <= 8; d and V multiples of 8; grid blocks walk the
// vocab tiles. Returns cudaGetLastError() after the launch.
extern "C" int tdt_norm_head(const void* x, const void* norm_w, const void* lm_head, void* out,
                             int B, int d, int V, int grid, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > MAXB || d <= 0 || V <= 0 || d % 8 || V % 8 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) return static_cast<int>(launch<bf16>(x, norm_w, lm_head, out, B, d, V, grid, eps, s));
  if (dtype == 0) return static_cast<int>(launch<float>(x, norm_w, lm_head, out, B, d, V, grid, eps, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

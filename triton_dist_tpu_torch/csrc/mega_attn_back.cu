// Attention back-leg of a decode step: KV splice, flash-decode sweep and
// o-projection partial, for Hopper.
//
// Replaces the TPU kernel `_attn_back_kernel` (triton_dist_tpu/megakernel/kernels.py:310,
// launched by `fused_attn_back`, pallas_call at :458). For q (B, Hq, D),
// this step's k_new, v_new (B, Hkv, D), the caches k, v (B, Hkv, S, D)
// before the append, lengths (B,) and wo (Hq D, n):
//
//   keys of row b: the cache rows below min(len + 1, S), where row len
//                  (if len < S) is k_new / v_new instead of the cache's
//   o   = online-softmax decode over those keys (P cast to V's dtype
//         before PV), rounded to q's dtype; o = 0 for a row with no key
//   out = sum over kv heads h, in order, of o[b, group h] @ wo[rows of h]
//         fp32 (B, n)
//
// The caches are only read: the cache append is a separate task of the
// step graph.
//
// What bounds it on the H100: the valid cache rows and wo. At Qwen3-8B
// (Hq 32, Hkv 8, D 128, n 4096, bf16) with lengths 1/777/1500/2047 that is
// 17.7 MB of cache and 33.6 MB of wo, 0.015 ms at 3.35 TB/s.
//
// Design, in three launches of this source:
// 1. One block per (b, kv head), as flash_decode.cu: the G query rows of
//    the group in shared memory, 8 warps taking 32-key tiles in turn, a
//    lane owning one key for QK^T and D/32 columns for PV, each warp with
//    its own running max and sum, merged through shared memory. The splice
//    is a choice of row pointer: the key at row len is read from k_new /
//    v_new. The block writes its G rows of o, rounded, to a (B, Hq, D)
//    workspace. At batch 4 with 8 kv heads this is 32 blocks on 132 SMs;
//    splitting the KV sweep across blocks is later work.
// 2. The o-projection as a split product (mega_gemv.cuh): one block per
//    (64 columns of n, kv head h) multiplies the B rows of o's group h
//    with that group's G D rows of wo, so wo is read once, by 512 blocks
//    at Qwen3-8B, and writes an fp32 partial per (h, b).
// 3. out[b] = the Hkv partials added in head order (no atomics, so the
//    result does not change from run to run), as the TPU kernel
//    accumulates them.

#include "mega_gemv.cuh"

using namespace tdt;

namespace {

constexpr int AB_WARPS = 8;
constexpr int AB_THREADS = AB_WARPS * 32;
constexpr int AB_TILE = 32;  // keys per warp step, one per lane

template <typename T, int D, int G>
__global__ void __launch_bounds__(AB_THREADS)
    attn_back_kernel(const T* __restrict__ Q, const T* __restrict__ KN, const T* __restrict__ VN,
                     const T* __restrict__ K, const T* __restrict__ V,
                     const int* __restrict__ lengths, T* __restrict__ O, int Hkv, int S,
                     float scale) {
  constexpr int DPL = D / 32;  // PV columns per lane
  __shared__ __align__(16) float sQ[G][D];
  __shared__ float sM[AB_WARPS][G];
  __shared__ float sL[AB_WARPS][G];
  __shared__ float sAcc[AB_WARPS][G][D];

  const int bh = blockIdx.x;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int Hq = Hkv * G;
  const T* Qp = Q + ((size_t)b * Hq + (size_t)hk * G) * D;
  const T* Kp = K + (size_t)bh * S * D;
  const T* Vp = V + (size_t)bh * S * D;
  const T* KNp = KN + (size_t)bh * D;
  const T* VNp = VN + (size_t)bh * D;
  const int len0 = max(0, lengths[b]);
  const int len = min(len0 + 1, S);       // keys attended
  const int splice = len0 < S ? len0 : -1;  // the row taken from k_new / v_new
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < G * D; i += AB_THREADS) sQ[i / D][i % D] = to_float(Qp[i]);
  __syncthreads();

  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.f;
  }

  for (int t0 = warp * AB_TILE; t0 < len; t0 += AB_WARPS * AB_TILE) {
    const int key = t0 + lane;
    const bool valid = key < len;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (valid) {
      const T* kr = key == splice ? KNp : Kp + (size_t)key * D;
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
    const int nv = min(AB_TILE, len - t0);
    for (int kk = 0; kk < nv; ++kk) {
      const int row = t0 + kk;
      float vv[DPL];
      load_vec<DPL>((row == splice ? VNp : Vp + (size_t)row * D) + lane * DPL, vv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pk = __shfl_sync(0xffffffffu, p[g], kk);
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[g][j] = fmaf(pk, vv[j], acc[g][j]);
      }
    }
  }

  // Merge the warps' partial softmax states into o, rounded to T.
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
  T* Op = O + ((size_t)b * Hq + (size_t)hk * G) * D;
  for (int i = threadIdx.x; i < G * D; i += AB_THREADS) {
    const int g = i / D, d = i % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < AB_WARPS; ++w) mx = fmaxf(mx, sM[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < AB_WARPS; ++w) {
      const float f = expf(sM[w][g] - mx);
      lsum = fmaf(sL[w][g], f, lsum);
      a = fmaf(sAcc[w][g][d], f, a);
    }
    Op[i] = from_float<T>(a / (lsum == 0.f ? 1.f : lsum));
  }
}

// Part[h, b, n0 + c] = o[b, rows of group h] @ wo[rows of group h, n0 + c]
// for a 64-column tile n0 (blockIdx.x) and kv head h (blockIdx.y).
template <typename T, int NB>
__global__ void __launch_bounds__(MEGA_THREADS)
    oproj_partial_kernel(const T* __restrict__ O, const T* __restrict__ WO,
                         float* __restrict__ Part, int rows, int n) {
  constexpr int NBP = padded_rows<NB>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // rows x NBP
  __shared__ float red[MEGA_WARPS][NB][TILE_N];
  const int n0 = blockIdx.x * TILE_N, h = blockIdx.y;
  const int hq_d = gridDim.y * rows;  // Hq * D
  for (int i = threadIdx.x; i < rows * NBP; i += MEGA_THREADS) {
    const int r = i / NBP, b = i % NBP;
    xs[i] = b < NB ? O[(size_t)b * hq_d + (size_t)h * rows + r] : from_float<T>(0.f);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = n0 + (lane & 7) * VEC;
  float acc[NB][VEC];
  zero_acc(acc);
  tile_dot<T, NB>(WO + (size_t)h * rows * n, n, col, col < n, warp * 4 + (lane >> 3), rows, 32, xs,
                  acc);
  warp_tile_sums<NB>(acc, red);
  __syncthreads();
  store_tile_sums<NB>(red, n0, n, Part + (size_t)h * NB * n, n);
}

// out[b, c] = sum over kv heads h, in order, of part[h, b, c].
__global__ void __launch_bounds__(AB_THREADS)
    attn_back_reduce_kernel(const float* __restrict__ Part, float* __restrict__ Out, int B,
                            int Hkv, int n) {
  const int i = blockIdx.x * AB_THREADS + threadIdx.x;
  if (i >= B * n) return;
  float s = 0.f;
  for (int h = 0; h < Hkv; ++h) s += Part[(size_t)h * B * n + i];
  Out[i] = s;
}

struct Args {
  const void *q, *kn, *vn, *k, *v;
  const int* lengths;
  const void* wo;
  float *out, *part;
  void* o;
  int B, Hkv, S, n;
  float scale;
};

template <typename T, int D, int G>
cudaError_t launch_one(const Args& a, cudaStream_t s) {
  attn_back_kernel<T, D, G><<<a.B * a.Hkv, AB_THREADS, 0, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kn), static_cast<const T*>(a.vn),
      static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.lengths, static_cast<T*>(a.o),
      a.Hkv, a.S, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = with_rows(a.B, [&](auto nrows) {
    constexpr int NB = decltype(nrows)::value;
    const int rows = G * D;
    const int smem = rows * padded_rows<NB>() * (int)sizeof(T);
    cudaError_t e = allow_smem(oproj_partial_kernel<T, NB>, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((a.n + TILE_N - 1) / TILE_N, a.Hkv);
    oproj_partial_kernel<T, NB><<<grid, MEGA_THREADS, smem, s>>>(
        static_cast<const T*>(a.o), static_cast<const T*>(a.wo), a.part, rows, a.n);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  attn_back_reduce_kernel<<<(a.B * a.n + AB_THREADS - 1) / AB_THREADS, AB_THREADS, 0, s>>>(
      a.part, a.out, a.B, a.Hkv, a.n);
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

}  // namespace

// q, o: (B, Hq, D); k_new, v_new: (B, Hkv, D); k, v: (B, Hkv, S, D);
// lengths: (B,) int32; wo: (Hq D, n); out: (B, n) fp32; o and part
// (Hkv, B, n) fp32 are workspaces. All contiguous on one device, q, the
// rows, the caches, o and wo of one dtype: 0 = fp32, 1 = bf16. 1 <= B <= 8,
// D in {32, 64, 128}, Hq / Hkv in {1, 2, 4, 8}, n % 8 == 0. Returns
// cudaGetLastError() after the third launch.
extern "C" int tdt_attn_back(const void* q, const void* k_new, const void* v_new, const void* k,
                             const void* v, const void* lengths, const void* wo, void* out,
                             void* o, void* part, int B, int Hq, int Hkv, int S, int D, int n,
                             float scale, int dtype, void* stream) {
  if (B < 1 || B > MAXB || Hkv <= 0 || Hq % Hkv != 0 || S < 1 || n <= 0 || n % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_new, v_new, k, v, static_cast<const int*>(lengths), wo,
               static_cast<float*>(out), static_cast<float*>(part), o, B, Hkv, S, n, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = Hq / Hkv;
  if (dtype == 1) return static_cast<int>(launch_d<bf16>(D, G, a, s));
  if (dtype == 0) return static_cast<int>(launch_d<float>(D, G, a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

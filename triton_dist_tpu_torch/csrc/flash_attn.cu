// Flash attention forward for Hopper (prefill and chunked prefill).
//
// Replaces the TPU kernel `_flash_kernel` (triton_dist_tpu/kernels/flash_attn.py:43,
// launched by `flash_attention`, pallas_call at :311). It computes the same
// function: causal or non-causal GQA attention over q (B, Hq, Sq, D) and
// k, v (B, Hkv, Sk, D), online softmax in the exp2 domain with
// scale * log2(e) folded into the scores, P cast to V's dtype before the PV
// product, rows with no valid key written as zeros, and an optional fp32
// log-sum-exp in nats. The causal mask is `q_off + qi >= ki`, where the
// wrapper passes q_off = q_offset - kv_offset, or Sk - Sq (end-aligned)
// without offsets.
//
// It also replaces `_flash_varlen_kernel` (flash_attn.py:333, launched by
// `flash_attention_varlen`, pallas_call at :462): packed sequences (H, T, D)
// run as B = 1 with per-position segment ids (seg_q, seg_k); a key is
// visible when it is causal with the offset and in the query's segment, and
// a row with no visible key (padding) gets o = 0 and lse = NEG_INF. The
// segment mode shares the tile loop: only the mask reads the ids.
//
// What bounds it on the H100: at the main path's prefill (Hq = 32, Hkv = 8,
// D = 128, bf16, causal, Sq = Sk = 1024) the work is about 8.6 GFLOP against
// 21 MB read and written, some 410 FLOP per byte, above the card's
// ~295 FLOP/byte bf16 ridge: the tensor cores bound it.
//
// Design. The TPU kernel walks the KV blocks as a sequential grid axis with
// its running max/sum in VMEM scratch; here the grid is (q tiles, B * Hq),
// all in parallel, and the KV sweep is a loop inside the block. A q head
// reads its KV head (h / (Hq / Hkv)) directly; K/V are never expanded per
// q head. Tiles wholly above the causal diagonal are never visited, and
// the ragged edge of Sq and Sk is masked in the kernel (any length works).
//
// * bf16: 4 warps own 16 q rows each of a 64-row tile. Q stays in registers
//   as mma A fragments; S = QK^T and O += PV both run on the tensor cores
//   with warp-level mma.sync m16n8k16 (fp32 accumulate), and P never leaves
//   registers (the S accumulator layout is the PV A-fragment layout). K/V
//   tiles of 64 rows are staged in shared memory with rows padded by 8
//   elements, which makes the fragment reads bank-conflict free. What it
//   does not do yet: wgmma, TMA or a cp.async pipeline (loads and math do
//   not overlap), so it sits well below the tensor-core bound.
// * fp32: the tensor cores have no fp32 mode, so a SIMT kernel: each warp
//   owns 8 q rows of a 32-row tile, a lane owns one key of the 32-key tile
//   for QK^T and D/32 output columns for PV.

#include "attn_tile.cuh"

using namespace tdt;

namespace {

// --------------------------------------------------------- bf16, mma.sync

constexpr int MMA_BQ = 64;
constexpr int MMA_BK = 64;
constexpr int MMA_THREADS = ATTN_THREADS;

// A row's log-sum-exp in nats from its base-2 running max and sum. In the
// packed mode a row with no visible key (padding) gets NEG_INF, so the
// backward's guard zeroes its probabilities exactly.
__device__ __forceinline__ float row_lse(float m, float l, bool packed) {
  if (packed && l == 0.f) return NEG_INF;
  return (m + log2f(fmaxf(l, 1e-30f))) / LOG2E;
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_fwd_bf16_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                          const bf16* __restrict__ V, bf16* __restrict__ O,
                          float* __restrict__ LSE, const int* __restrict__ seg_q,
                          const int* __restrict__ seg_k, int Hq, int Hkv, int Sq, int Sk, int causal,
                          int q_off, float scale_log2) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + MMA_BQ * LD;
  bf16* sV = sK + MMA_BK * LD;

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * MMA_BQ;
  const bf16* Qp = Q + (size_t)bh * Sq * D;
  const bf16* Kp = K + (size_t)(b * Hkv + hk) * Sk * D;
  const bf16* Vp = V + (size_t)(b * Hkv + hk) * Sk * D;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma group and thread-in-group
  const int r0 = warp * 16 + g;           // this thread's tile rows: r0 and r0 + 8
  const int qrow0 = q0 + r0, qrow1 = q0 + r0 + 8;
  const int sg0 = seg_q != nullptr && qrow0 < Sq ? seg_q[qrow0] : -1;
  const int sg1 = seg_q != nullptr && qrow1 < Sq ? seg_q[qrow1] : -1;

  load_tile_bf16<D, MMA_BQ>(sQ, Qp, q0, Sq);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* p0 = sQ + r0 * LD + kk * 16 + t * 2;
    const bf16* p1 = p0 + 8 * LD;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(p0);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(p1);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  const int n_tiles = kv_tiles(q0, MMA_BQ, Sq, Sk, causal, q_off, MMA_BK);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * MMA_BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<D, MMA_BK>(sK, Kp, k0, Sk);
    load_tile_bf16<D, MMA_BK>(sV, Vp, k0, Sk);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, as 8 n-tiles of 8 keys.
    float s[MMA_BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < MMA_BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const bf16* kp = sK + (nt * 8 + g) * LD + kk * 16 + t * 2;
        mma16816(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    // Scale into the exp2 domain; mask only tiles that cross the diagonal
    // or the ragged end of the keys.
    const bool masked =
        seg_k != nullptr || (k0 + MMA_BK > Sk) || (causal && k0 + MMA_BK - 1 > q_off + q0);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < MMA_BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (masked) {
          const int key = k0 + nt * 8 + t * 2 + (e & 1);
          const bool ok = e < 2 ? visible(qrow0, key, Sq, Sk, causal, q_off, sg0, seg_k)
                                : visible(qrow1, key, Sq, Sk, causal, q_off, sg1, seg_k);
          x = ok ? x : NEG_INF;
        }
        s[nt][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    // A row lives in the 4 threads of one mma group.
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    // A row with no valid key yet keeps p = 0 (not exp2(0) = 1).
    const bool dead0 = mx0 <= NEG_INF * 0.5f, dead1 = mx1 <= NEG_INF * 0.5f;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < MMA_BK / 8; ++nt) {
      s[nt][0] = dead0 ? 0.f : exp2f(s[nt][0] - mx0);
      s[nt][1] = dead0 ? 0.f : exp2f(s[nt][1] - mx0);
      s[nt][2] = dead1 ? 0.f : exp2f(s[nt][2] - mx1);
      s[nt][3] = dead1 ? 0.f : exp2f(s[nt][3] - mx1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha0;
      acc[dt][1] *= alpha0;
      acc[dt][2] *= alpha1;
      acc[dt][3] *= alpha1;
    }

    // O += P V: P (16 x 64, bf16) from the S registers, V from shared memory.
#pragma unroll
    for (int j = 0; j < MMA_BK / 16; ++j) {
      uint32_t pa[4];
      c_to_a_frag(pa, s[2 * j], s[2 * j + 1]);
      mma_rows<D, LD>(acc, pa, sV, j * 16, g, t);
    }
  }

  const float ls0 = l0 == 0.f ? 1.f : l0, ls1 = l1 == 0.f ? 1.f : l1;
  bf16* Op = O + (size_t)bh * Sq * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + t * 2;
    if (qrow0 < Sq)
      *reinterpret_cast<uint32_t*>(Op + (size_t)qrow0 * D + col) =
          pack_bf16x2(acc[dt][0] / ls0, acc[dt][1] / ls0);
    if (qrow1 < Sq)
      *reinterpret_cast<uint32_t*>(Op + (size_t)qrow1 * D + col) =
          pack_bf16x2(acc[dt][2] / ls1, acc[dt][3] / ls1);
  }
  if (LSE != nullptr && t == 0) {
    if (qrow0 < Sq) LSE[(size_t)bh * Sq + qrow0] = row_lse(m0, l0, seg_k != nullptr);
    if (qrow1 < Sq) LSE[(size_t)bh * Sq + qrow1] = row_lse(m1, l1, seg_k != nullptr);
  }
}

// ------------------------------------------------------------------- SIMT

constexpr int SIMT_ROWS = 8;  // q rows per warp
constexpr int SIMT_THREADS = 128;
constexpr int SIMT_BQ = SIMT_ROWS * SIMT_THREADS / 32;
constexpr int SIMT_BK = 32;  // one key per lane

template <typename T, int D>
__global__ void __launch_bounds__(SIMT_THREADS)
    flash_fwd_simt_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                          const T* __restrict__ V, T* __restrict__ O, float* __restrict__ LSE,
                          const int* __restrict__ seg_q, const int* __restrict__ seg_k, int Hq,
                          int Hkv, int Sq, int Sk, int causal, int q_off, float scale_log2) {
  constexpr int KLD = D + 1;  // padded: lane-per-key reads are conflict free
  constexpr int DPL = D / 32;
  extern __shared__ __align__(16) float fsmem[];
  float* sQ = fsmem;                  // SIMT_BQ x D
  float* sK = sQ + SIMT_BQ * D;       // SIMT_BK x KLD
  float* sV = sK + SIMT_BK * KLD;     // SIMT_BK x D

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * SIMT_BQ;
  const T* Qp = Q + (size_t)bh * Sq * D;
  const T* Kp = K + (size_t)(b * Hkv + hk) * Sk * D;
  const T* Vp = V + (size_t)(b * Hkv + hk) * Sk * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < SIMT_BQ * D; i += SIMT_THREADS) {
    const int r = i / D;
    sQ[i] = q0 + r < Sq ? to_float(Qp[(size_t)q0 * D + i]) : 0.f;
  }

  float acc[SIMT_ROWS][DPL];
  float m[SIMT_ROWS], l[SIMT_ROWS];
#pragma unroll
  for (int i = 0; i < SIMT_ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = kv_tiles(q0, SIMT_BQ, Sq, Sk, causal, q_off, SIMT_BK);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * SIMT_BK;
    __syncthreads();
    for (int i = threadIdx.x; i < SIMT_BK * D; i += SIMT_THREADS) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < Sk;
      sK[r * KLD + c] = ok ? to_float(Kp[(size_t)k0 * D + i]) : 0.f;
      sV[i] = ok ? to_float(Vp[(size_t)k0 * D + i]) : 0.f;
    }
    __syncthreads();

    const int key = k0 + lane;
    const float* krow = sK + lane * KLD;
#pragma unroll
    for (int i = 0; i < SIMT_ROWS; ++i) {
      const int r = warp * SIMT_ROWS + i;
      const int qr = q0 + r;
      const float* qrow = sQ + r * D;
      float x = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) x = fmaf(qrow[c], krow[c], x);
      x *= scale_log2;
      const int sg = seg_q != nullptr && qr < Sq ? seg_q[qr] : -1;
      x = visible(qr, key, Sq, Sk, causal, q_off, sg, seg_k) ? x : NEG_INF;
      const float mx = fmaxf(m[i], warp_max(x));
      const float alpha = exp2f(m[i] - mx);
      float p = mx <= NEG_INF * 0.5f ? 0.f : exp2f(x - mx);
      l[i] = l[i] * alpha + warp_sum(p);
      m[i] = mx;
      p = round_to<T>(p);
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[i][j] *= alpha;
#pragma unroll 4
      for (int kk = 0; kk < SIMT_BK; ++kk) {
        const float pk = __shfl_sync(0xffffffffu, p, kk);
        const float* vrow = sV + kk * D + lane;
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[i][j] = fmaf(pk, vrow[j * 32], acc[i][j]);
      }
    }
  }

  T* Op = O + (size_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < SIMT_ROWS; ++i) {
    const int qr = q0 + warp * SIMT_ROWS + i;
    if (qr >= Sq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < DPL; ++j) Op[(size_t)qr * D + lane + j * 32] = from_float<T>(acc[i][j] / ls);
    if (LSE != nullptr && lane == 0) LSE[(size_t)bh * Sq + qr] = row_lse(m[i], l[i], seg_k != nullptr);
  }
}

// ------------------------------------------------------------------ launch

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                        const int* seg_q, const int* seg_k, int B, int Hq, int Hkv, int Sq, int Sk,
                        int causal, int q_off, float scale_log2, cudaStream_t stream) {
  const int smem = (MMA_BQ + 2 * MMA_BK) * (D + 8) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + MMA_BQ - 1) / MMA_BQ, B * Hq);
  flash_fwd_bf16_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, seg_q, seg_k, Hq, Hkv, Sq, Sk, causal, q_off, scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                       const int* seg_q, const int* seg_k, int B, int Hq, int Hkv, int Sq, int Sk,
                       int causal, int q_off, float scale_log2, cudaStream_t stream) {
  const int smem = (SIMT_BQ * D + SIMT_BK * (D + 1) + SIMT_BK * D) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_simt_kernel<float, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + SIMT_BQ - 1) / SIMT_BQ, B * Hq);
  flash_fwd_simt_kernel<float, D><<<grid, SIMT_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, seg_q, seg_k, Hq, Hkv, Sq, Sk, causal, q_off, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); lse: (B, Hq, Sq) fp32 or NULL;
// seg_q (Sq,), seg_k (Sk,) int32 segment ids for the packed mode, or both
// NULL. All contiguous on one device. dtype: 0 = fp32, 1 = bf16. D in
// {32, 64, 128}. Returns cudaGetLastError() after the launch.
extern "C" int tdt_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                  void* lse, const void* seg_q, const void* seg_k, int B, int Hq,
                                  int Hkv, int Sq, int Sk, int D, int causal, int q_off,
                                  float scale_log2, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const int* sq = static_cast<const int*>(seg_q);
  const int* sk = static_cast<const int*>(seg_k);
#define TDT_FWD(launch, DD) launch<DD>(q, k, v, o, l, sq, sk, B, Hq, Hkv, Sq, Sk, causal, q_off, scale_log2, s)
  if (dtype == 1) {
    switch (D) {
      case 32: return TDT_FWD(launch_bf16, 32);
      case 64: return TDT_FWD(launch_bf16, 64);
      case 128: return TDT_FWD(launch_bf16, 128);
    }
  } else if (dtype == 0) {
    switch (D) {
      case 32: return TDT_FWD(launch_f32, 32);
      case 64: return TDT_FWD(launch_f32, 64);
      case 128: return TDT_FWD(launch_f32, 128);
    }
  }
#undef TDT_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

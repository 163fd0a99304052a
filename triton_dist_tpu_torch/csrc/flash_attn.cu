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
//
// The KV sweep itself lives in flash_sweep.cuh, shared with row 27
// (ag_attention.cu), which runs it once per rank's KV shard.

#include "flash_sweep.cuh"

using namespace tdt;

namespace {

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
  const bf16* Kp = K + (size_t)(b * Hkv + hk) * Sk * D;
  const bf16* Vp = V + (size_t)(b * Hkv + hk) * Sk * D;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma group and thread-in-group
  const int r0 = warp * 16 + g;           // this thread's tile rows: r0 and r0 + 8
  const int qrow0 = q0 + r0, qrow1 = q0 + r0 + 8;
  const int sg0 = seg_q != nullptr && qrow0 < Sq ? seg_q[qrow0] : -1;
  const int sg1 = seg_q != nullptr && qrow1 < Sq ? seg_q[qrow1] : -1;

  uint32_t qf[D / 16][4];
  load_q_frags<D>(qf, sQ, Q + (size_t)bh * Sq * D, q0, Sq, r0, t);
  MmaState<D> st;
  st.init();
  sweep_bf16<D, false>(st, qf, sK, sV, Kp, Vp, q0, Sq, Sk, causal, q_off, scale_log2, qrow0, qrow1, sg0, sg1,
                       seg_k, g, t);
  store_bf16<D>(st, O + (size_t)bh * Sq * D, LSE != nullptr ? LSE + (size_t)bh * Sq : nullptr, qrow0, qrow1, Sq,
                seg_k != nullptr, t);
}

template <typename T, int D>
__global__ void __launch_bounds__(SIMT_THREADS)
    flash_fwd_simt_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                          const T* __restrict__ V, T* __restrict__ O, float* __restrict__ LSE,
                          const int* __restrict__ seg_q, const int* __restrict__ seg_k, int Hq,
                          int Hkv, int Sq, int Sk, int causal, int q_off, float scale_log2) {
  extern __shared__ __align__(16) float fsmem[];
  float* sQ = fsmem;                  // SIMT_BQ x D
  float* sK = sQ + SIMT_BQ * D;       // SIMT_BK x (D + 1)
  float* sV = sK + SIMT_BK * (D + 1); // SIMT_BK x D

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * SIMT_BQ;
  const T* Qp = Q + (size_t)bh * Sq * D;

  for (int i = threadIdx.x; i < SIMT_BQ * D; i += SIMT_THREADS) {
    const int r = i / D;
    sQ[i] = q0 + r < Sq ? to_float(Qp[(size_t)q0 * D + i]) : 0.f;
  }
  SimtState<D> st;
  st.init();
  sweep_simt<T, D, false>(st, sQ, sK, sV, K + (size_t)(b * Hkv + hk) * Sk * D, V + (size_t)(b * Hkv + hk) * Sk * D,
                          q0, Sq, Sk, causal, q_off, scale_log2, seg_q, seg_k);
  store_simt<T, D>(st, O + (size_t)bh * Sq * D, LSE != nullptr ? LSE + (size_t)bh * Sq : nullptr, q0, Sq,
                   seg_k != nullptr);
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

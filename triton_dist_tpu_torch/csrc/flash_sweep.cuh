// The KV sweep of the flash attention forward, shared by row 1
// (csrc/flash_attn.cu: one sweep over the keys) and row 27
// (csrc/ag_attention.cu: one sweep per rank's KV shard, the running max,
// sum and accumulator carried from shard to shard in registers).
//
// A sweep visits the key tiles of K, V (Sk rows of D, one kv head) that the
// query tile [q0, q0 + BQ) may see under the mask `visible` (attn_tile.cuh)
// with the causal offset q_off, and folds them into the online softmax in
// the exp2 domain (scale * log2(e) folded into the scores; P cast to V's
// dtype before PV). A tile wholly above the diagonal is never visited, so a
// shard that the rows cannot see costs nothing. `CG` reads K and V through
// L2 only (__ldcg): row 27's shards were written by other ranks.
#pragma once

#include "attn_tile.cuh"

namespace tdt {

// --------------------------------------------------------- bf16, mma.sync

constexpr int MMA_BQ = 64;
constexpr int MMA_BK = 64;
constexpr int MMA_THREADS = ATTN_THREADS;

// A row's log-sum-exp in nats from its base-2 running max and sum. With
// `guard` a row with no visible key gets NEG_INF, so the backward's guard
// zeroes its probabilities exactly.
__device__ __forceinline__ float row_lse(float m, float l, bool guard) {
  if (guard && l == 0.f) return NEG_INF;
  return (m + log2f(fmaxf(l, 1e-30f))) / LOG2E;
}

// The running state of one thread of the bf16 sweep: rows r0 and r0 + 8 of
// its warp's 16.
template <int D>
struct MmaState {
  float acc[D / 8][4];
  float m0, m1, l0, l1;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
    m0 = m1 = NEG_INF;
    l0 = l1 = 0.f;
  }
};

// Q rows [q0, q0 + MMA_BQ) into mma A fragments, through shared memory sQ.
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[D / 16][4], bf16* sQ, const bf16* Qp, int q0, int Sq,
                                             int r0, int t) {
  constexpr int LD = D + 8;
  load_tile_bf16<D, MMA_BQ>(sQ, Qp, q0, Sq);
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* p0 = sQ + r0 * LD + kk * 16 + t * 2;
    const bf16* p1 = p0 + 8 * LD;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(p0);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(p1);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
  }
}

// 4 warps own 16 q rows each of the 64-row tile; S = QK^T and O += PV on
// the tensor cores (mma.sync m16n8k16, fp32 accumulate), P kept in
// registers (the S accumulator layout is the PV A-fragment layout); K/V
// tiles of 64 rows staged in shared memory (sK, sV) with rows padded by 8.
template <int D, bool CG>
__device__ __forceinline__ void sweep_bf16(MmaState<D>& st, const uint32_t (&qf)[D / 16][4], bf16* sK, bf16* sV,
                                           const bf16* Kp, const bf16* Vp, int q0, int Sq, int Sk, int causal,
                                           int q_off, float scale_log2, int qrow0, int qrow1, int sg0, int sg1,
                                           const int* seg_k, int g, int t) {
  constexpr int LD = D + 8;
  const int n_tiles = kv_tiles(q0, MMA_BQ, Sq, Sk, causal, q_off, MMA_BK);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * MMA_BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<D, MMA_BK, CG>(sK, Kp, k0, Sk);
    load_tile_bf16<D, MMA_BK, CG>(sV, Vp, k0, Sk);
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
    float mx0 = st.m0, mx1 = st.m1;
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
    const float alpha0 = exp2f(st.m0 - mx0), alpha1 = exp2f(st.m1 - mx1);
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
    st.l0 = st.l0 * alpha0 + rs0;
    st.l1 = st.l1 * alpha1 + rs1;
    st.m0 = mx0;
    st.m1 = mx1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      st.acc[dt][0] *= alpha0;
      st.acc[dt][1] *= alpha0;
      st.acc[dt][2] *= alpha1;
      st.acc[dt][3] *= alpha1;
    }

    // O += P V: P (16 x 64, bf16) from the S registers, V from shared memory.
#pragma unroll
    for (int j = 0; j < MMA_BK / 16; ++j) {
      uint32_t pa[4];
      c_to_a_frag(pa, s[2 * j], s[2 * j + 1]);
      mma_rows<D, LD>(st.acc, pa, sV, j * 16, g, t);
    }
  }
}

// o = acc / l (zeros for a row with no key) and the LSE in nats.
template <int D>
__device__ __forceinline__ void store_bf16(const MmaState<D>& st, bf16* Op, float* LSEp, int qrow0, int qrow1,
                                           int Sq, bool guard, int t) {
  const float ls0 = st.l0 == 0.f ? 1.f : st.l0, ls1 = st.l1 == 0.f ? 1.f : st.l1;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + t * 2;
    if (qrow0 < Sq)
      *reinterpret_cast<uint32_t*>(Op + (size_t)qrow0 * D + col) =
          pack_bf16x2(st.acc[dt][0] / ls0, st.acc[dt][1] / ls0);
    if (qrow1 < Sq)
      *reinterpret_cast<uint32_t*>(Op + (size_t)qrow1 * D + col) =
          pack_bf16x2(st.acc[dt][2] / ls1, st.acc[dt][3] / ls1);
  }
  if (LSEp != nullptr && t == 0) {
    if (qrow0 < Sq) LSEp[qrow0] = row_lse(st.m0, st.l0, guard);
    if (qrow1 < Sq) LSEp[qrow1] = row_lse(st.m1, st.l1, guard);
  }
}

// ------------------------------------------------------------------- SIMT

// fp32 has no tensor-core mode: each warp owns SIMT_ROWS q rows of a
// SIMT_BQ-row tile, a lane owns one key of the 32-key tile for QK^T and
// D / 32 output columns for PV.
constexpr int SIMT_ROWS = 8;  // q rows per warp
constexpr int SIMT_THREADS = 128;
constexpr int SIMT_BQ = SIMT_ROWS * SIMT_THREADS / 32;
constexpr int SIMT_BK = 32;  // one key per lane

template <bool CG, typename T>
__device__ __forceinline__ float load_elem(const T* p) {
  if constexpr (CG) {
    return to_float(__ldcg(p));
  } else {
    return to_float(*p);
  }
}

template <int D>
struct SimtState {
  float acc[SIMT_ROWS][D / 32];
  float m[SIMT_ROWS], l[SIMT_ROWS];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < SIMT_ROWS; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
#pragma unroll
      for (int j = 0; j < D / 32; ++j) acc[i][j] = 0.f;
    }
  }
};

// sQ: the tile's SIMT_BQ x D query rows (fp32, already loaded); sK
// SIMT_BK x (D + 1) (padded: lane-per-key reads are conflict free); sV
// SIMT_BK x D.
template <typename T, int D, bool CG>
__device__ __forceinline__ void sweep_simt(SimtState<D>& st, const float* sQ, float* sK, float* sV, const T* Kp,
                                           const T* Vp, int q0, int Sq, int Sk, int causal, int q_off,
                                           float scale_log2, const int* seg_q, const int* seg_k) {
  constexpr int KLD = D + 1;
  constexpr int DPL = D / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = kv_tiles(q0, SIMT_BQ, Sq, Sk, causal, q_off, SIMT_BK);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * SIMT_BK;
    __syncthreads();
    for (int i = threadIdx.x; i < SIMT_BK * D; i += SIMT_THREADS) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < Sk;
      sK[r * KLD + c] = ok ? load_elem<CG>(Kp + (size_t)k0 * D + i) : 0.f;
      sV[i] = ok ? load_elem<CG>(Vp + (size_t)k0 * D + i) : 0.f;
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
      const float mx = fmaxf(st.m[i], warp_max(x));
      const float alpha = exp2f(st.m[i] - mx);
      float p = mx <= NEG_INF * 0.5f ? 0.f : exp2f(x - mx);
      st.l[i] = st.l[i] * alpha + warp_sum(p);
      st.m[i] = mx;
      p = round_to<T>(p);
#pragma unroll
      for (int j = 0; j < DPL; ++j) st.acc[i][j] *= alpha;
#pragma unroll 4
      for (int kk = 0; kk < SIMT_BK; ++kk) {
        const float pk = __shfl_sync(0xffffffffu, p, kk);
        const float* vrow = sV + kk * D + lane;
#pragma unroll
        for (int j = 0; j < DPL; ++j) st.acc[i][j] = fmaf(pk, vrow[j * 32], st.acc[i][j]);
      }
    }
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_simt(const SimtState<D>& st, T* Op, float* LSEp, int q0, int Sq, bool guard) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < SIMT_ROWS; ++i) {
    const int qr = q0 + warp * SIMT_ROWS + i;
    if (qr >= Sq) continue;
    const float ls = st.l[i] == 0.f ? 1.f : st.l[i];
#pragma unroll
    for (int j = 0; j < D / 32; ++j) Op[(size_t)qr * D + lane + j * 32] = from_float<T>(st.acc[i][j] / ls);
    if (LSEp != nullptr && lane == 0) LSEp[qr] = row_lse(st.m[i], st.l[i], guard);
  }
}

}  // namespace tdt

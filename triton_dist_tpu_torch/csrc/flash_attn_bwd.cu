// Flash attention backward for Hopper: dq and dk/dv from the saved LSE.
//
// Replaces the TPU kernel pairs of `flash_attention_bwd`
// (triton_dist_tpu/kernels/flash_attn.py:624; `_flash_bwd_dq_kernel` :559,
// pallas_call :696, and the dk/dv kernel, pallas_call :791) and of
// `flash_attention_varlen_bwd` (:851; `dq_kernel` :905, pallas_call :939,
// `dkv_kernel` :976, pallas_call :1015). Both pairs compute the same
// function, under one of two masks: causal with an offset (`q_off + qi >=
// ki`, or none), or the packed mode (causal and the same segment, from
// per-position segment ids). The probabilities are recomputed exactly from
// the saved LSE in the exp2 domain, p = exp2(s * scale * log2(e) - lse2),
// and zeroed where the key is masked or the row's lse2 is NEG_INF-like (a
// row with no key, a padding row, a ring step skipped whole), so a zero
// cotangent never meets an inf. With delta = rowsum(do * o) - dlse (the
// wrapper's plain tensor code, as in JAX), ds = p * (dp - delta) * scale,
// dq = ds k, dk = ds^T q, dv = p^T do; p and ds are rounded to the input
// dtype before their products, as the TPU kernels round them for the MXU.
//
// What bounds it on the H100: at the training step's shapes (Hq 32, Hkv 8,
// D 128, S 4096, causal, bf16) the two passes do 7 products of the
// forward's size (dq: qk^T, do v^T, ds k; dk/dv: the first two again,
// p^T do, ds^T q) against ~2.5 for the least a backward needs, some 340
// GFLOP over ~100 MB: the tensor cores bound it.
//
// Design. The TPU walks a sequential grid axis with VMEM accumulators; here
// the reductions are loops inside a block, and nothing is reduced across
// blocks, so there are no atomics and a gradient is the same bits from run
// to run:
// * dq: one block per (q tile of 64 rows, b * Hq); 4 warps own 16 rows
//   each and walk the key tiles up to the causal edge, as the forward does.
// * dk/dv: one block per (key tile of 64 rows, b * Hkv); 4 warps own 16
//   keys each and walk the GQA group's q heads and, for each, the q tiles
//   from the first that can see the tile's first key: the walk of JAX's
//   `q_row`/`q_scalar` index maps (:723-726), written as a loop. The
//   products run transposed (s^T = k q^T, dp^T = v do^T), so p^T and ds^T
//   come out in the accumulator layout that feeds dv and dk as A fragments.
// * bf16: warp-level mma.sync m16n8k16 with fp32 accumulators, tiles in
//   shared memory with rows padded by 8 elements; the dk/dv accumulators
//   (2 x D / 8 x 4 floats a thread) stay in registers, so at D = 128 the
//   inner q tile is 32 rows to keep the p^T and dp^T tiles small. What it
//   does not do yet: wgmma, TMA or a cp.async pipeline.
// * fp32: SIMT, as the forward: a lane owns one key (dq) or one query
//   (dk/dv) of a 32-wide tile and D / 32 output columns.

#include "attn_tile.cuh"

using namespace tdt;

namespace {

constexpr int BQ = 64;  // dq: q rows per block; dk/dv: keys per block
constexpr int BK = 64;  // dq: keys per tile

__device__ __forceinline__ bool live(float lse2) { return lse2 > NEG_INF * 0.5f; }

// ------------------------------------------------------------ bf16, dq

template <int D>
__global__ void __launch_bounds__(ATTN_THREADS)
    flash_bwd_dq_bf16_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                             const bf16* __restrict__ V, const bf16* __restrict__ dO,
                             const float* __restrict__ lse2, const float* __restrict__ delta,
                             const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                             bf16* __restrict__ dQ, int Hq, int Hkv, int Sq, int Sk, int causal,
                             int q_off, float scale, float scale_log2) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = sQ + BQ * LD;
  bf16* sK = sDO + BQ * LD;
  bf16* sV = sK + BK * LD;

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * BQ;
  const bf16* Kp = K + (size_t)(b * Hkv + hk) * Sk * D;
  const bf16* Vp = V + (size_t)(b * Hkv + hk) * Sk * D;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  float l2[2], dl[2];
  int sg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = row[i] < Sq;
    l2[i] = in ? lse2[(size_t)bh * Sq + row[i]] : NEG_INF;
    dl[i] = in ? delta[(size_t)bh * Sq + row[i]] : 0.f;
    sg[i] = seg_q != nullptr && in ? seg_q[row[i]] : -1;
  }

  load_tile_bf16<D, BQ>(sQ, Q + (size_t)bh * Sq * D, q0, Sq);
  load_tile_bf16<D, BQ>(sDO, dO + (size_t)bh * Sq * D, q0, Sq);

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  const int n_tiles = kv_tiles(q0, BQ, Sq, Sk, causal, q_off, BK);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    __syncthreads();
    load_tile_bf16<D, BK>(sK, Kp, k0, Sk);
    load_tile_bf16<D, BK>(sV, Vp, k0, Sk);
    __syncthreads();

    // s = q k^T and dp = do v^T, 16 rows x 64 keys per warp.
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a_frag<LD>(qa, sQ, r0, kk * 16, g, t);
      load_a_frag<LD>(da, sDO, r0, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const bf16* kp = sK + (nt * 8 + g) * LD + kk * 16 + t * 2;
        const bf16* vp = sV + (nt * 8 + g) * LD + kk * 16 + t * 2;
        mma16816(s[nt], qa, *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
        mma16816(dp[nt], da, *reinterpret_cast<const uint32_t*>(vp),
                 *reinterpret_cast<const uint32_t*>(vp + 8));
      }
    }

    // ds = p (dp - delta) scale, into s.
    const bool masked = seg_k != nullptr || (k0 + BK > Sk) || (causal && k0 + BK - 1 > q_off + q0);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int key = k0 + nt * 8 + t * 2 + (e & 1);
        const bool ok = live(l2[i]) && (!masked || visible(row[i], key, Sq, Sk, causal, q_off, sg[i], seg_k));
        const float p = ok ? exp2f(s[nt][e] * scale_log2 - l2[i]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dl[i]) * scale;
      }
    }

    // dq += ds k.
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t a[4];
      c_to_a_frag(a, s[2 * j], s[2 * j + 1]);
      mma_rows<D, LD>(acc, a, sK, j * 16, g, t);
    }
  }

  bf16* out = dQ + (size_t)bh * Sq * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + t * 2;
    if (row[0] < Sq)
      *reinterpret_cast<uint32_t*>(out + (size_t)row[0] * D + col) = pack_bf16x2(acc[dt][0], acc[dt][1]);
    if (row[1] < Sq)
      *reinterpret_cast<uint32_t*>(out + (size_t)row[1] * D + col) = pack_bf16x2(acc[dt][2], acc[dt][3]);
  }
}

// --------------------------------------------------------- bf16, dk/dv

// The first q row that can see key k0 (all rows without the causal mask).
__device__ __forceinline__ int first_q(int k0, int causal, int q_off) {
  return causal ? max(0, k0 - q_off) : 0;
}

template <int D, int BQ2>
__global__ void __launch_bounds__(ATTN_THREADS)
    flash_bwd_dkdv_bf16_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
                               const bf16* __restrict__ V, const bf16* __restrict__ dO,
                               const float* __restrict__ lse2, const float* __restrict__ delta,
                               const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                               bf16* __restrict__ dK, bf16* __restrict__ dV, int Hq, int Hkv, int Sq,
                               int Sk, int causal, int q_off, float scale, float scale_log2) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BQ * LD;
  bf16* sQ = sV + BQ * LD;
  bf16* sDO = sQ + BQ2 * LD;
  float* sL = reinterpret_cast<float*>(sDO + BQ2 * LD);
  float* sD = sL + BQ2;
  int* sS = reinterpret_cast<int*>(sD + BQ2);

  const int bkv = blockIdx.y;
  const int b = bkv / Hkv, hk = bkv % Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.x * BQ;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const int key[2] = {k0 + r0 + g, k0 + r0 + g + 8};
  int sgk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) sgk[i] = seg_k != nullptr && key[i] < Sk ? seg_k[key[i]] : -2;

  load_tile_bf16<D, BQ>(sK, K + (size_t)bkv * Sk * D, k0, Sk);
  load_tile_bf16<D, BQ>(sV, V + (size_t)bkv * Sk * D, k0, Sk);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;

  const int qt_first = first_q(k0, causal, q_off) / BQ2;
  const int n_qt = (Sq + BQ2 - 1) / BQ2;
  for (int hi = 0; hi < group; ++hi) {
    const int bh = b * Hq + hk * group + hi;
    for (int qt = qt_first; qt < n_qt; ++qt) {
      const int q0 = qt * BQ2;
      __syncthreads();
      load_tile_bf16<D, BQ2>(sQ, Q + (size_t)bh * Sq * D, q0, Sq);
      load_tile_bf16<D, BQ2>(sDO, dO + (size_t)bh * Sq * D, q0, Sq);
      for (int i = threadIdx.x; i < BQ2; i += ATTN_THREADS) {
        const bool in = q0 + i < Sq;
        sL[i] = in ? lse2[(size_t)bh * Sq + q0 + i] : NEG_INF;
        sD[i] = in ? delta[(size_t)bh * Sq + q0 + i] : 0.f;
        sS[i] = seg_q != nullptr && in ? seg_q[q0 + i] : -1;
      }
      __syncthreads();

      // s^T = k q^T and dp^T = v do^T, 16 keys x BQ2 queries per warp.
      float st[BQ2 / 8][4], dpt[BQ2 / 8][4];
#pragma unroll
      for (int nt = 0; nt < BQ2 / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        load_a_frag<LD>(ka, sK, r0, kk * 16, g, t);
        load_a_frag<LD>(va, sV, r0, kk * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < BQ2 / 8; ++nt) {
          const bf16* qp = sQ + (nt * 8 + g) * LD + kk * 16 + t * 2;
          const bf16* dp = sDO + (nt * 8 + g) * LD + kk * 16 + t * 2;
          mma16816(st[nt], ka, *reinterpret_cast<const uint32_t*>(qp),
                   *reinterpret_cast<const uint32_t*>(qp + 8));
          mma16816(dpt[nt], va, *reinterpret_cast<const uint32_t*>(dp),
                   *reinterpret_cast<const uint32_t*>(dp + 8));
        }
      }

      // p^T into st, ds^T into dpt.
      const bool masked =
          seg_k != nullptr || (k0 + BQ > Sk) || (q0 + BQ2 > Sq) || (causal && k0 + BQ - 1 > q_off + q0);
#pragma unroll
      for (int nt = 0; nt < BQ2 / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = nt * 8 + t * 2 + (e & 1);
          const int i = e >> 1;
          const float l = sL[qi];
          const bool ok =
              live(l) && (!masked || visible_id(q0 + qi, key[i], Sq, Sk, causal, q_off, seg_k != nullptr,
                                                sS[qi], sgk[i]));
          const float p = ok ? exp2f(st[nt][e] * scale_log2 - l) : 0.f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - sD[qi]) * scale;
        }
      }

      // dv += p^T do, dk += ds^T q.
#pragma unroll
      for (int j = 0; j < BQ2 / 16; ++j) {
        uint32_t pa[4], da[4];
        c_to_a_frag(pa, st[2 * j], st[2 * j + 1]);
        c_to_a_frag(da, dpt[2 * j], dpt[2 * j + 1]);
        mma_rows<D, LD>(dv, pa, sDO, j * 16, g, t);
        mma_rows<D, LD>(dk, da, sQ, j * 16, g, t);
      }
    }
  }

  bf16* dkp = dK + (size_t)bkv * Sk * D;
  bf16* dvp = dV + (size_t)bkv * Sk * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + t * 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (key[i] >= Sk) continue;
      *reinterpret_cast<uint32_t*>(dkp + (size_t)key[i] * D + col) = pack_bf16x2(dk[dt][2 * i], dk[dt][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dvp + (size_t)key[i] * D + col) = pack_bf16x2(dv[dt][2 * i], dv[dt][2 * i + 1]);
    }
  }
}

// ------------------------------------------------------------------ SIMT

constexpr int SIMT_ROWS = 8;                             // rows (dq) or keys (dk/dv) per warp
constexpr int SIMT_TILE = SIMT_ROWS * ATTN_THREADS / 32;  // 32 a block
constexpr int SIMT_W = 32;                               // keys (dq) or queries (dk/dv) per tile

template <int D>
__global__ void __launch_bounds__(ATTN_THREADS)
    flash_bwd_dq_simt_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                             const float* __restrict__ V, const float* __restrict__ dO,
                             const float* __restrict__ lse2, const float* __restrict__ delta,
                             const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                             float* __restrict__ dQ, int Hq, int Hkv, int Sq, int Sk, int causal,
                             int q_off, float scale, float scale_log2) {
  constexpr int PLD = D + 1;  // padded: lane-per-key reads are conflict free
  constexpr int DPL = D / 32;
  extern __shared__ __align__(16) float fsmem[];
  float* sQ = fsmem;                 // SIMT_TILE x D
  float* sDO = sQ + SIMT_TILE * D;   // SIMT_TILE x D
  float* sK = sDO + SIMT_TILE * D;   // SIMT_W x PLD
  float* sV = sK + SIMT_W * PLD;     // SIMT_W x PLD

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * SIMT_TILE;
  const float* Kp = K + (size_t)(b * Hkv + hk) * Sk * D;
  const float* Vp = V + (size_t)(b * Hkv + hk) * Sk * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < SIMT_TILE * D; i += ATTN_THREADS) {
    const bool in = q0 + i / D < Sq;
    sQ[i] = in ? Q[(size_t)bh * Sq * D + (size_t)q0 * D + i] : 0.f;
    sDO[i] = in ? dO[(size_t)bh * Sq * D + (size_t)q0 * D + i] : 0.f;
  }
  float acc[SIMT_ROWS][DPL];
#pragma unroll
  for (int i = 0; i < SIMT_ROWS; ++i)
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;

  const int n_tiles = kv_tiles(q0, SIMT_TILE, Sq, Sk, causal, q_off, SIMT_W);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * SIMT_W;
    __syncthreads();
    for (int i = threadIdx.x; i < SIMT_W * D; i += ATTN_THREADS) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < Sk;
      sK[r * PLD + c] = ok ? Kp[(size_t)k0 * D + i] : 0.f;
      sV[r * PLD + c] = ok ? Vp[(size_t)k0 * D + i] : 0.f;
    }
    __syncthreads();
    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < SIMT_ROWS; ++i) {
      const int r = warp * SIMT_ROWS + i, qr = q0 + r;
      const float l = qr < Sq ? lse2[(size_t)bh * Sq + qr] : NEG_INF;
      const float dl = qr < Sq ? delta[(size_t)bh * Sq + qr] : 0.f;
      const int sg = seg_q != nullptr && qr < Sq ? seg_q[qr] : -1;
      float x = 0.f, y = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        x = fmaf(sQ[r * D + c], sK[lane * PLD + c], x);
        y = fmaf(sDO[r * D + c], sV[lane * PLD + c], y);
      }
      const bool ok = live(l) && visible(qr, key, Sq, Sk, causal, q_off, sg, seg_k);
      const float p = ok ? exp2f(x * scale_log2 - l) : 0.f;
      const float ds = p * (y - dl) * scale;
#pragma unroll 4
      for (int kk = 0; kk < SIMT_W; ++kk) {
        const float dsk = __shfl_sync(0xffffffffu, ds, kk);
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[i][j] = fmaf(dsk, sK[kk * PLD + lane + j * 32], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < SIMT_ROWS; ++i) {
    const int qr = q0 + warp * SIMT_ROWS + i;
    if (qr >= Sq) continue;
#pragma unroll
    for (int j = 0; j < DPL; ++j) dQ[(size_t)bh * Sq * D + (size_t)qr * D + lane + j * 32] = acc[i][j];
  }
}

template <int D>
__global__ void __launch_bounds__(ATTN_THREADS)
    flash_bwd_dkdv_simt_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                               const float* __restrict__ V, const float* __restrict__ dO,
                               const float* __restrict__ lse2, const float* __restrict__ delta,
                               const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                               float* __restrict__ dK, float* __restrict__ dV, int Hq, int Hkv, int Sq,
                               int Sk, int causal, int q_off, float scale, float scale_log2) {
  constexpr int PLD = D + 1;  // padded: lane-per-query reads are conflict free
  constexpr int DPL = D / 32;
  extern __shared__ __align__(16) float fsmem[];
  float* sK = fsmem;                 // SIMT_TILE x D
  float* sV = sK + SIMT_TILE * D;    // SIMT_TILE x D
  float* sQ = sV + SIMT_TILE * D;    // SIMT_W x PLD
  float* sDO = sQ + SIMT_W * PLD;    // SIMT_W x PLD

  const int bkv = blockIdx.y;
  const int b = bkv / Hkv, hk = bkv % Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.x * SIMT_TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < SIMT_TILE * D; i += ATTN_THREADS) {
    const bool in = k0 + i / D < Sk;
    sK[i] = in ? K[(size_t)bkv * Sk * D + (size_t)k0 * D + i] : 0.f;
    sV[i] = in ? V[(size_t)bkv * Sk * D + (size_t)k0 * D + i] : 0.f;
  }
  float dk[SIMT_ROWS][DPL], dv[SIMT_ROWS][DPL];
#pragma unroll
  for (int i = 0; i < SIMT_ROWS; ++i)
#pragma unroll
    for (int j = 0; j < DPL; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int qt_first = first_q(k0, causal, q_off) / SIMT_W;
  const int n_qt = (Sq + SIMT_W - 1) / SIMT_W;
  for (int hi = 0; hi < group; ++hi) {
    const int bh = b * Hq + hk * group + hi;
    for (int qt = qt_first; qt < n_qt; ++qt) {
      const int q0 = qt * SIMT_W;
      __syncthreads();
      for (int i = threadIdx.x; i < SIMT_W * D; i += ATTN_THREADS) {
        const int r = i / D, c = i % D;
        const bool ok = q0 + r < Sq;
        sQ[r * PLD + c] = ok ? Q[(size_t)bh * Sq * D + (size_t)q0 * D + i] : 0.f;
        sDO[r * PLD + c] = ok ? dO[(size_t)bh * Sq * D + (size_t)q0 * D + i] : 0.f;
      }
      __syncthreads();
      const int qr = q0 + lane;
      const float l = qr < Sq ? lse2[(size_t)bh * Sq + qr] : NEG_INF;
      const float dl = qr < Sq ? delta[(size_t)bh * Sq + qr] : 0.f;
      const int sg = seg_q != nullptr && qr < Sq ? seg_q[qr] : -1;
#pragma unroll
      for (int i = 0; i < SIMT_ROWS; ++i) {
        const int r = warp * SIMT_ROWS + i, key = k0 + r;
        float x = 0.f, y = 0.f;
#pragma unroll 8
        for (int c = 0; c < D; ++c) {
          x = fmaf(sK[r * D + c], sQ[lane * PLD + c], x);
          y = fmaf(sV[r * D + c], sDO[lane * PLD + c], y);
        }
        const bool ok = live(l) && visible(qr, key, Sq, Sk, causal, q_off, sg, seg_k);
        const float p = ok ? exp2f(x * scale_log2 - l) : 0.f;
        const float ds = p * (y - dl) * scale;
#pragma unroll 4
        for (int qq = 0; qq < SIMT_W; ++qq) {
          const float pq = __shfl_sync(0xffffffffu, p, qq);
          const float dsq = __shfl_sync(0xffffffffu, ds, qq);
#pragma unroll
          for (int j = 0; j < DPL; ++j) {
            dv[i][j] = fmaf(pq, sDO[qq * PLD + lane + j * 32], dv[i][j]);
            dk[i][j] = fmaf(dsq, sQ[qq * PLD + lane + j * 32], dk[i][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < SIMT_ROWS; ++i) {
    const int key = k0 + warp * SIMT_ROWS + i;
    if (key >= Sk) continue;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      dK[(size_t)bkv * Sk * D + (size_t)key * D + lane + j * 32] = dk[i][j];
      dV[(size_t)bkv * Sk * D + (size_t)key * D + lane + j * 32] = dv[i][j];
    }
  }
}

// ------------------------------------------------------------------ launch

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse2, *delta;
  const int *seg_q, *seg_k;
  void *dq, *dk, *dv;
  int B, Hq, Hkv, Sq, Sk, causal, q_off;
  float scale, scale_log2;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D>
cudaError_t launch_bf16(const BwdArgs& a) {
  constexpr int LD = D + 8;
  constexpr int BQ2 = D == 128 ? 32 : 64;
  const bf16 *q = static_cast<const bf16*>(a.q), *k = static_cast<const bf16*>(a.k);
  const bf16 *v = static_cast<const bf16*>(a.v), *dout = static_cast<const bf16*>(a.dout);
  const int smem_dq = (2 * BQ + 2 * BK) * LD * (int)sizeof(bf16);
  cudaError_t err = set_smem(flash_bwd_dq_bf16_kernel<D>, smem_dq);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_bf16_kernel<D><<<dim3((a.Sq + BQ - 1) / BQ, a.B * a.Hq), ATTN_THREADS, smem_dq, a.stream>>>(
      q, k, v, dout, a.lse2, a.delta, a.seg_q, a.seg_k, static_cast<bf16*>(a.dq), a.Hq, a.Hkv, a.Sq, a.Sk,
      a.causal, a.q_off, a.scale, a.scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem_kv = (2 * BQ + 2 * BQ2) * LD * (int)sizeof(bf16) + BQ2 * 3 * 4;
  err = set_smem(flash_bwd_dkdv_bf16_kernel<D, BQ2>, smem_kv);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_bf16_kernel<D, BQ2><<<dim3((a.Sk + BQ - 1) / BQ, a.B * a.Hkv), ATTN_THREADS, smem_kv, a.stream>>>(
      q, k, v, dout, a.lse2, a.delta, a.seg_q, a.seg_k, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.Hq, a.Hkv, a.Sq, a.Sk, a.causal, a.q_off, a.scale, a.scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const BwdArgs& a) {
  const float *q = static_cast<const float*>(a.q), *k = static_cast<const float*>(a.k);
  const float *v = static_cast<const float*>(a.v), *dout = static_cast<const float*>(a.dout);
  const int smem = (2 * SIMT_TILE * D + 2 * SIMT_W * (D + 1)) * (int)sizeof(float);
  cudaError_t err = set_smem(flash_bwd_dq_simt_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_simt_kernel<D><<<dim3((a.Sq + SIMT_TILE - 1) / SIMT_TILE, a.B * a.Hq), ATTN_THREADS, smem,
                                a.stream>>>(q, k, v, dout, a.lse2, a.delta, a.seg_q, a.seg_k,
                                            static_cast<float*>(a.dq), a.Hq, a.Hkv, a.Sq, a.Sk, a.causal,
                                            a.q_off, a.scale, a.scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = set_smem(flash_bwd_dkdv_simt_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_simt_kernel<D><<<dim3((a.Sk + SIMT_TILE - 1) / SIMT_TILE, a.B * a.Hkv), ATTN_THREADS, smem,
                                  a.stream>>>(q, k, v, dout, a.lse2, a.delta, a.seg_q, a.seg_k,
                                              static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Hq,
                                              a.Hkv, a.Sq, a.Sk, a.causal, a.q_off, a.scale, a.scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q, do: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); lse2 (the saved LSE times
// log2(e)) and delta: (B, Hq, Sq) fp32; seg_q (Sq,), seg_k (Sk,) int32
// segment ids for the packed mode, or both NULL; dq, dk, dv like q, k, v.
// All contiguous on one device. dtype: 0 = fp32, 1 = bf16. D in {32, 64,
// 128}. Launches the dq kernel, then the dk/dv kernel; returns
// cudaGetLastError() after the launches.
extern "C" int tdt_flash_attn_bwd(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse2, const void* delta, const void* seg_q,
                                  const void* seg_k, void* dq, void* dk, void* dv, int B, int Hq, int Hkv,
                                  int Sq, int Sk, int D, int causal, int q_off, float scale,
                                  float scale_log2, int dtype, void* stream) {
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse2), static_cast<const float*>(delta),
                  static_cast<const int*>(seg_q), static_cast<const int*>(seg_k), dq, dk, dv, B, Hq, Hkv,
                  Sq, Sk, causal, q_off, scale, scale_log2, static_cast<cudaStream_t>(stream)};
  if (dtype == 1) {
    switch (D) {
      case 32: return launch_bf16<32>(a);
      case 64: return launch_bf16<64>(a);
      case 128: return launch_bf16<128>(a);
    }
  } else if (dtype == 0) {
    switch (D) {
      case 32: return launch_f32<32>(a);
      case 64: return launch_f32<64>(a);
      case 128: return launch_f32<128>(a);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

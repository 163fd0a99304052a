// Pieces shared by the flash attention forward (csrc/flash_sweep.cuh, for
// csrc/flash_attn.cu and csrc/ag_attention.cu) and backward
// (csrc/flash_attn_bwd.cu): the bf16 mma.sync m16n8k16 product,
// bf16 packing, a tile load into padded shared memory, the causal tile count
// and the attention mask of both kernels.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (g = lane / 4, t = lane % 4):
// A (16 x 16): a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols), a2 (row g,
// cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9); B (16 x 8): b0 (k rows 2t,
// 2t+1, col g), b1 (k rows 2t+8, 2t+9, col g); C (16 x 8): c0, c1 (row g,
// cols 2t, 2t+1), c2, c3 (row g+8, same cols). The accumulator of two
// adjacent 8-column C tiles is the A fragment of a 16-deep product, so a
// product's result feeds the next one without leaving registers.
#pragma once

#include "common.cuh"

namespace tdt {

constexpr int ATTN_THREADS = 128;

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16x2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// The A fragment of 16 rows x 16 columns at (row0, col0) of a shared tile
// with row stride LD.
template <int LD>
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const bf16* s, int row0, int col0, int g,
                                            int t) {
  const bf16* p0 = s + (row0 + g) * LD + col0 + t * 2;
  const bf16* p1 = p0 + 8 * LD;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
}

// The A fragment of rows [16 j, 16 j + 16) of a product whose C tiles of 8
// columns are c[2 j] and c[2 j + 1], rounded to bf16.
__device__ __forceinline__ void c_to_a_frag(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}

// acc (16 x D) += A (16 x 16) @ S[k0 .. k0 + 16, 0 .. D) for a shared tile S
// (rows are the product's depth) with row stride LD.
template <int D, int LD>
__device__ __forceinline__ void mma_rows(float (&acc)[D / 8][4], const uint32_t (&a)[4], const bf16* s,
                                         int k0, int g, int t) {
  const bf16* p0 = s + (k0 + t * 2) * LD + g;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const bf16* p = p0 + dt * 8;
    mma16816(acc[dt], a, pack_bf16x2(p[0], p[LD]), pack_bf16x2(p[8 * LD], p[9 * LD]));
  }
}

// ROWS x D bf16 rows [row0, row0 + ROWS) of a (nrows, D) matrix into shared
// memory with row stride D + 8; rows at or past nrows become zeros. `CG`
// reads through L2 only (rows another rank wrote).
template <int D, int ROWS, bool CG = false>
__device__ __forceinline__ void load_tile_bf16(bf16* s, const bf16* g, int row0, int nrows) {
  constexpr int LD = D + 8;
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * CPR; c += ATTN_THREADS) {
    const int r = c / CPR, cc = c % CPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows) {
      const uint4* src = reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * D + cc * 8);
      val = CG ? __ldcg(src) : *src;
    }
    *reinterpret_cast<uint4*>(s + r * LD + cc * 8) = val;
  }
}

// One past the last KV tile any row of the q tile [q0, q0 + bq) may see.
__device__ __forceinline__ int kv_tiles(int q0, int bq, int sq, int sk, int causal, int q_off, int bk) {
  int kv_end = sk;
  if (causal) {
    const int last_q = min(q0 + bq, sq) - 1;
    kv_end = min(sk, q_off + last_q + 1);
  }
  return kv_end > 0 ? (kv_end + bk - 1) / bk : 0;
}

// Whether query row q sees key k: inside both lengths, causal with the
// offset (q_off + q >= k), and, in the packed (varlen) mode, in the same
// segment (seg_q and seg_k hold each position's segment id; the two
// padding sentinels -1 and -2 never match). seg_k is read only when the
// pair passes the other tests: the dense mode (seg_k NULL) reads nothing.
__device__ __forceinline__ bool visible(int q, int k, int sq, int sk, int causal, int q_off, int seg_q,
                                        const int* seg_k) {
  if (q >= sq || k >= sk) return false;
  if (causal && q_off + q < k) return false;
  return seg_k == nullptr || seg_q == seg_k[k];
}

// The same with the key's segment id already in a register (seg_k_id,
// compared only in the packed mode).
__device__ __forceinline__ bool visible_id(int q, int k, int sq, int sk, int causal, int q_off, bool packed,
                                           int seg_q, int seg_k_id) {
  if (q >= sq || k >= sk) return false;
  if (causal && q_off + q < k) return false;
  return !packed || seg_q == seg_k_id;
}

}  // namespace tdt

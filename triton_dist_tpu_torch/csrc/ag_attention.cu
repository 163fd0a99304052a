// Fused all-gather flash attention for Hopper (sequence parallelism, row 27).
//
// Replaces the TPU kernel `_ag_attn_kernel` (triton_dist_tpu/kernels/
// ag_attention.py:48, launched by `ag_flash_attention_shard`, pallas_call at
// :315 via `dist_pallas_call`). It computes the same function: exact
// attention of this rank's query shard q (B, Hq, S, D) over the whole
// sequence of world * S keys, whose K and V shards (B, Hkv, S, D) lie one on
// each rank, with shard j at global positions [j S, (j + 1) S). Shards are
// taken in the order src = (rank - s) mod world, the local one first, and
// merged by the online softmax (one global softmax, not a merge of
// normalised partials). The causal mask is blockwise on global positions:
// query row rank * S + t sees key src * S + c when c + src * S <= t + rank * S,
// so a shard below the diagonal is unmasked, the diagonal one is causal and
// one above it contributes nothing (p = 0), and every rank runs the same
// schedule. The LSE is written in nats, NEG_INF where a row saw no key.
//
// The TPU kernel starts every put at grid step 0 and waits each source's
// bytes on a per-source semaphore before that source's step; here:
//
// * launch 1 (`ag_kv_push_kernel`) puts this rank's K and V shards into
//   slot [me] of every peer's landing zones (symmetric-heap workspace of
//   (world, B * Hkv, S, D) each), in pieces of at most 32 KB, one block a
//   piece, and signals each piece's flag (pads [K or V][me][piece]) with the
//   call's epoch. It waits for nothing, so it always finishes;
// * launch 2 (`ag_attn_*_kernel`) is the flash sweep of flash_sweep.cuh
//   over (query tiles, B * Hq), i.e. the GQA-folded rows of each of the
//   B * Hkv kv heads cut per q head. For each source in the kernel's order
//   it first waits, with the bounded `signal_wait_until` (phase
//   `ag_kv_recv`, peer src), the pieces of that source's shard that hold its
//   kv head, then streams the shard's key tiles from the local landing zone
//   (the local shard straight from k and v), with the running max, sum and
//   accumulator in registers. A tile above the diagonal is never visited.
//
// No entry barrier: the landing zones and the pads alternate by the parity
// of the call's epoch (shmem/symm.py), and a rank ends call e only after
// every peer's pushes of call e arrived, so no peer is two calls behind.
// With residuals the gathered K and V are copied out of the heap into
// (B, Hkv, world * S, D) in rank order (two strided copies a source, after
// the sweep on the same stream), since the call after next reuses the zone.
//
// What bounds it on the H100: at Qwen3-8B's attention (Hq 32, Hkv 8, D
// 128, bf16, causal) and S = 384 a rank, the busiest rank (the last) does
// about 8.5 GFLOP (0.0086 ms at the bf16 peak) and pushes 3 x 1.6 MB over
// NVLink (0.0105 ms at 450 GB/s a direction): the link bounds it, the
// tensor cores close behind. The consume is row 1's mma.sync sweep, so it
// inherits row 1's distance from the tensor-core bound; overlapping the
// gather with the sweep inside one launch is later work.

#include "a2a.cuh"
#include "flash_sweep.cuh"

using namespace tdt;

namespace {

// Pad phases of the two zones.
constexpr int PAD_K = 0, PAD_V = 1;

// grid (pieces, 2, world - 1): block (b, kv, j) puts piece b (`piece_bytes`,
// the last one short) of this rank's K (kv = 0) or V shard into slot [me]
// of dest = (me + 1 + j) mod world's zone, then signals dest's pad
// (kv, me, b).
__global__ void __launch_bounds__(256)
    ag_kv_push_kernel(Shmem s, const unsigned char* __restrict__ k, const unsigned char* __restrict__ v,
                      size_t shard_bytes, size_t piece_bytes, uint64_t kland_off, uint64_t vland_off,
                      uint64_t flags_off) {
  if (poisoned(s)) return;
  const int b = blockIdx.x, kv = blockIdx.y, dest = (s.rank + 1 + blockIdx.z) % s.world;
  const size_t lo = (size_t)b * piece_bytes;
  const size_t n = shard_bytes - lo < piece_bytes ? shard_bytes - lo : piece_bytes;
  unsigned char* dst = peer_ptr<unsigned char>(s, kv ? vland_off : kland_off, dest) + s.rank * shard_bytes + lo;
  block_copy(dst, (kv ? v : k) + lo, n, false);
  block_signal(s, a2a_pad(s, flags_off, dest, kv ? PAD_V : PAD_K, s.rank, b));
}

// Thread 0 waits for every piece of source src's K and V shards that holds
// bytes [lo, hi) (one kv head); the block learns the outcome. False means
// a wait expired (or the status was set): leave the kernel.
__device__ __forceinline__ bool wait_shard(const Shmem& s, uint64_t flags_off, int src, size_t lo, size_t hi,
                                           size_t piece_bytes) {
  __shared__ int ok;
  if (threadIdx.x == 0) {
    int r = 1;
    for (int pad = PAD_K; pad <= PAD_V && r; ++pad)
      for (size_t b = lo / piece_bytes; b * piece_bytes < hi && r; ++b)
        r = signal_wait_until(s, a2a_pad(s, flags_off, s.rank, pad, src, (int)b), PHASE_AG_KV_RECV, src) ? 1 : 0;
    ok = r;
  }
  __syncthreads();
  const bool res = ok != 0;
  __syncthreads();
  return res;
}

// Where the kernel finds source src's shard of kv head kvh: the local
// tensors for src == me, else the landing zone.
struct Shards {
  const void* k;  // this rank's (B * Hkv, S, D) shards
  const void* v;
  uint64_t kland_off, vland_off, flags_off;
  size_t shard_bytes, piece_bytes;
};

template <typename T>
__device__ __forceinline__ const T* shard_ptr(const Shmem& s, const Shards& z, bool is_v, int src, int kvh, int S,
                                              int D) {
  const size_t off = (size_t)kvh * S * D;
  if (src == s.rank) return static_cast<const T*>(is_v ? z.v : z.k) + off;
  const unsigned char* zone = peer_ptr<unsigned char>(s, is_v ? z.vland_off : z.kland_off, s.rank);
  return reinterpret_cast<const T*>(zone + src * z.shard_bytes) + off;
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    ag_attn_bf16_kernel(Shmem s, Shards z, const bf16* __restrict__ Q, bf16* __restrict__ O,
                        float* __restrict__ LSE, int Hq, int Hkv, int S, int causal, float scale_log2) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + MMA_BQ * LD;
  bf16* sV = sK + MMA_BK * LD;

  const int bh = blockIdx.y;
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int q0 = blockIdx.x * MMA_BQ;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;
  const int qrow0 = q0 + r0, qrow1 = qrow0 + 8;
  const size_t head_bytes = (size_t)S * D * sizeof(bf16);

  uint32_t qf[D / 16][4];
  load_q_frags<D>(qf, sQ, Q + (size_t)bh * S * D, q0, S, r0, t);
  MmaState<D> st;
  st.init();
  for (int step = 0; step < s.world; ++step) {
    const int src = (s.rank - step + s.world) % s.world;
    if (src != s.rank &&
        !wait_shard(s, z.flags_off, src, kvh * head_bytes, (kvh + 1) * head_bytes, z.piece_bytes))
      return;
    sweep_bf16<D, true>(st, qf, sK, sV, shard_ptr<bf16>(s, z, false, src, kvh, S, D),
                        shard_ptr<bf16>(s, z, true, src, kvh, S, D), q0, S, S, causal, (s.rank - src) * S,
                        scale_log2, qrow0, qrow1, -1, -1, nullptr, g, t);
  }
  store_bf16<D>(st, O + (size_t)bh * S * D, LSE != nullptr ? LSE + (size_t)bh * S : nullptr, qrow0, qrow1, S, true,
                t);
}

template <int D>
__global__ void __launch_bounds__(SIMT_THREADS)
    ag_attn_f32_kernel(Shmem s, Shards z, const float* __restrict__ Q, float* __restrict__ O,
                       float* __restrict__ LSE, int Hq, int Hkv, int S, int causal, float scale_log2) {
  extern __shared__ __align__(16) float fsmem[];
  float* sQ = fsmem;
  float* sK = sQ + SIMT_BQ * D;
  float* sV = sK + SIMT_BK * (D + 1);

  const int bh = blockIdx.y;
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const int q0 = blockIdx.x * SIMT_BQ;
  const float* Qp = Q + (size_t)bh * S * D;
  const size_t head_bytes = (size_t)S * D * sizeof(float);

  for (int i = threadIdx.x; i < SIMT_BQ * D; i += SIMT_THREADS) sQ[i] = q0 + i / D < S ? Qp[(size_t)q0 * D + i] : 0.f;
  SimtState<D> st;
  st.init();
  for (int step = 0; step < s.world; ++step) {
    const int src = (s.rank - step + s.world) % s.world;
    if (src != s.rank &&
        !wait_shard(s, z.flags_off, src, kvh * head_bytes, (kvh + 1) * head_bytes, z.piece_bytes))
      return;
    sweep_simt<float, D, true>(st, sQ, sK, sV, shard_ptr<float>(s, z, false, src, kvh, S, D),
                               shard_ptr<float>(s, z, true, src, kvh, S, D), q0, S, S, causal, (s.rank - src) * S,
                               scale_log2, nullptr, nullptr);
  }
  store_simt<float, D>(st, O + (size_t)bh * S * D, LSE != nullptr ? LSE + (size_t)bh * S : nullptr, q0, S, true);
}

template <int D>
cudaError_t launch_consume(const Shmem& s, const Shards& z, const void* q, void* o, float* lse, int B, int Hq,
                           int Hkv, int S, int causal, float scale_log2, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    const int smem = (MMA_BQ + 2 * MMA_BK) * (D + 8) * (int)sizeof(bf16);
    cudaError_t err = cudaFuncSetAttribute(ag_attn_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ag_attn_bf16_kernel<D><<<dim3((S + MMA_BQ - 1) / MMA_BQ, B * Hq), MMA_THREADS, smem, st>>>(
        s, z, static_cast<const bf16*>(q), static_cast<bf16*>(o), lse, Hq, Hkv, S, causal, scale_log2);
  } else {
    const int smem = (SIMT_BQ * D + SIMT_BK * (D + 1) + SIMT_BK * D) * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(ag_attn_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ag_attn_f32_kernel<D><<<dim3((S + SIMT_BQ - 1) / SIMT_BQ, B * Hq), SIMT_THREADS, smem, st>>>(
        s, z, static_cast<const float*>(q), static_cast<float*>(o), lse, Hq, Hkv, S, causal, scale_log2);
  }
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, Hq, S, D); k, v: (B, Hkv, S, D), this rank's shards; lse: (B,
// Hq, S) fp32 or NULL; k_full, v_full: (B, Hkv, world * S, D) or NULL (the
// residuals, both or neither). All contiguous on this rank's card. dtype: 0
// = fp32, 1 = bf16; D in {32, 64, 128}. land_off: 2 * world * shard_bytes
// of workspace (K zone, then V zone), at address `land` in this process;
// shard_bytes = B * Hkv * S * D *
// itemsize; at most A2A_MAX_SLOTS pieces of piece_bytes a shard. Two
// launches (push, then the sweep), then the residual copies.
extern "C" int tdt_ag_attention(A2A_SHMEM_ARGS, const void* q, const void* k, const void* v, void* o, void* lse,
                                void* k_full, void* v_full, int B, int Hq, int Hkv, int S, int D, int causal,
                                float scale_log2, int dtype, uint64_t land_off, const void* land,
                                size_t piece_bytes, uint64_t flags_off, void* stream) {
  const size_t isz = dtype == 1 ? 2 : 4;
  const size_t shard_bytes = (size_t)B * Hkv * S * D * isz;
  if (a2a_bad_layer(rank, world) || (dtype != 0 && dtype != 1) || (D != 32 && D != 64 && D != 128) || B < 1 ||
      Hkv < 1 || Hq % Hkv != 0 || S < 1 || piece_bytes == 0 || piece_bytes % 16 != 0 ||
      a2a_cdiv(shard_bytes, piece_bytes) > A2A_MAX_SLOTS || (k_full == nullptr) != (v_full == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shmem s = a2a_shmem(peers, status, rank, world, epoch, timeout_ns);
  const Shards z{k, v, land_off, land_off + world * shard_bytes, flags_off, shard_bytes, piece_bytes};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (world > 1) {
    ag_kv_push_kernel<<<dim3(a2a_cdiv(shard_bytes, piece_bytes), 2, world - 1), 256, 0, st>>>(
        s, static_cast<const unsigned char*>(k), static_cast<const unsigned char*>(v), shard_bytes, piece_bytes,
        z.kland_off, z.vland_off, flags_off);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  float* l = static_cast<float*>(lse);
  cudaError_t err = cudaErrorInvalidValue;
  switch (D) {
    case 32: err = launch_consume<32>(s, z, q, o, l, B, Hq, Hkv, S, causal, scale_log2, dtype, st); break;
    case 64: err = launch_consume<64>(s, z, q, o, l, B, Hq, Hkv, S, causal, scale_log2, dtype, st); break;
    case 128: err = launch_consume<128>(s, z, q, o, l, B, Hq, Hkv, S, causal, scale_log2, dtype, st); break;
  }
  if (err != cudaSuccess || k_full == nullptr) return static_cast<int>(err);
  // Residuals: source j's (B * Hkv) heads of S rows land at rows [j S, (j + 1) S)
  // of every head of k_full, v_full.
  const size_t head = (size_t)S * D * isz;
  for (int j = 0; j < world; ++j) {
    for (int kv = 0; kv < 2; ++kv) {
      const unsigned char* src = j == rank ? static_cast<const unsigned char*>(kv ? v : k)
                                           : static_cast<const unsigned char*>(land) +
                                                 (kv * (size_t)world + j) * shard_bytes;
      unsigned char* dst = static_cast<unsigned char*>(kv ? v_full : k_full) + j * head;
      err = cudaMemcpy2DAsync(dst, world * head, src, head, head, (size_t)B * Hkv, cudaMemcpyDeviceToDevice, st);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaSuccess);
}

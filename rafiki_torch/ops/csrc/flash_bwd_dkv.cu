// K3: flash-attention backward, dk and dv, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_dkv_kernel` of
// rafiki_tpu/ops/attention.py (launched by `_flash_backward`). For one
// tile of keys it walks the query rows that see them and computes, from
// the forward's per-row log-sum-exp `lse` and `delta = rowsum(do ⊙ o)`,
// in the transposed layout the reference uses (keys as rows):
//
//   pᵀ  = exp(k·qᵀ·scale − lse)   on kept pairs, 0 elsewhere (a select)
//   dv  = Σ pᵀ·do                  (p cast to do's dtype, f32 sums)
//   dpᵀ = v·doᵀ
//   dsᵀ = pᵀ ⊙ (dpᵀ − delta) · scale
//   dk  = Σ dsᵀ·q                  (ds cast to q's dtype, f32 sums)
//
// A pair is kept when the query row is below Tq, the key is in range,
// causally visible (end-aligned: query row r sits at key position
// r + Tkv − Tq) and kept by the kv_mask bias (0 or NEG_INF). Query rows
// past Tq load as zeros and are masked, not only left unwritten: their
// p would otherwise pile into dk and dv. On a dropped pair exp(...) may be
// +inf, so it is selected away, never multiplied by zero.
//
// Layout: q, do (B, H, Tq, D); k, v, dk, dv (B, H, Tkv, D), contiguous;
// lse, delta (B, H, Tq) f32; bias (B, Tkv) f32 or null.
//
// Design. One thread block per (batch·head, tile of keys). A loop inside
// the block walks the query rows from the first chunk that sees the tile
// (the inverse of K2's causal test: chunk c is needed iff
// kv0 <= last row of c + Tkv − Tq) to the end, with the dk and dv
// accumulators in f32 registers for the whole loop: the Hopper
// counterpart of the TPU's sequential "arbitrary" grid axis with VMEM
// scratch. Each block writes its own rows of dk and dv once, with no
// atomics, so they come out the same from run to run. Three variants; the
// caller picks one by the shape (`flash_backward_variant` in
// ops/attention.py) and passes it in:
//  - bf16, wgmma (the main path; D % 8 == 0 and 16-byte aligned q, k, v,
//    do, dk, dv, as TMA needs): one block per 128 keys, 384 threads in
//    three warpgroups. A producer warp loads K and V once by TMA, then
//    streams chunks of 64 query rows of Q and dO through a ring of STAGES
//    buffers, each with a `full` and an `empty` mbarrier; its lanes bring
//    the chunk's lse (times log2 e) and delta beside it with plain loads
//    (a TMA map over them would need Tq % 4 == 0). Two consumer
//    warpgroups own 64 keys each, with dk and dv (64 x D f32 each) in
//    registers: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ by `wgmma` m64n64k16 from the
//    swizzled tiles (both K-major), pᵀ by `ex2` with scale·log2 e folded
//    in, dV += pᵀ·dO and dK += dsᵀ·Q by `wgmma` with pᵀ and dsᵀ packed to
//    bf16 in registers (the A operand) and dO and Q read MN-major: the Q
//    tile serves Sᵀ and dK through two descriptors. A chunk's pᵀ is taken
//    while dPᵀ runs, its dsᵀ while dV runs, and its dK runs on into the
//    next chunk's Sᵀ and dPᵀ. `setmaxnreg` moves registers from the
//    producer (24) to the consumers (240): dk, dv, Sᵀ, dPᵀ and the A
//    fragments take 208. dk and dv leave through the group's own K and V
//    rows in shared memory and TMA stores, which clip at Tkv and D.
//    Blocks run in groups of batch·heads whose Q and dO fit in L2
//    together, key tiles nearer the start (more chunks) first.
//  - bf16, mma.sync (D % 8 != 0 or a misaligned base): 4 warps of 16
//    keys, BKV = 64 keys a block. Two f32 accumulators of 16 keys x D per
//    warp take 128 registers a thread at D = 128, so the q loop steps by
//    BQC = 32 rows, which keeps the transposed score and dp tiles at 16
//    registers each. The four products are `mma.sync` m16n8k16 with f32
//    accumulators. K and V stay in shared memory for the whole loop and
//    feed `ldmatrix` A fragments; each chunk of Q, dO, lse and delta
//    passes through shared memory in two stages, chunk c + 1 arriving by
//    `cp.async` while chunk c computes. pᵀ and dsᵀ are re-packed in
//    registers as the bf16 A fragments of pᵀ·do and dsᵀ·q (dO and Q read
//    transposed). Interior chunks skip the masking.
//  - f32: plain FMA in f32, 8 warps of 8 keys, 64-row q tiles.
//
// The result does not depend on the tiling: every pair that is hidden,
// out of range or padded is selected to zero and each p and ds element is
// rounded on its own, so only the order of the f32 sums differs between
// the variants.
//
// Bound. At the flagship train shape (8, 16, 2048, 2048, 128) causal the
// four products over the unmasked pairs are 275.0 GFLOP against 0.41 GB
// of inputs and outputs, about 680 FLOP a byte: above the H100's ridge
// (~295), so the tensor cores bound it, at 0.2781 ms at 989 TFLOP/s.

#include <math.h>

#include <algorithm>

#include "flash_common.cuh"
#include "flash_hopper.cuh"

namespace {

using namespace flash;

constexpr int MMA_THREADS = 128;  // 4 warps x 16 keys
constexpr int BQC = 32;           // query rows per step of the q loop

template <int DP>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const float* __restrict__ bias,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int H, int Tq,
                              int Tkv, int D, int causal, float scale,
                              int vec) {
  constexpr int LD = DP + PAD;
  constexpr int KD = DP / 16;     // k-steps over the head dim
  constexpr int NS = BQC / 8;     // n-tiles of a transposed score chunk
  constexpr int NO = DP / 8;      // n-tiles of dk and dv
  constexpr int CHUNK = BQC * LD; // elements of one Q or dO chunk
  extern __shared__ __align__(16) unsigned char smem[];
  // K, V, then two stages of (Q, dO) and two of (lse, delta): chunk c + 1
  // loads while chunk c computes.
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BKV * LD;
  __nv_bfloat16* QDs = Vs + BKV * LD;
  float* LDs = reinterpret_cast<float*>(QDs + 4 * CHUNK);

  const int bh = blockIdx.x;
  // Causal blocks nearer the start see more query rows: start them first.
  const int kv0 = blockIdx.y * BKV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = warp * 16;  // the warp's keys within the tile
  const int shift = Tkv - Tq;

  const __nv_bfloat16* qb = q + (size_t)bh * Tq * D;
  const __nv_bfloat16* dob = dout + (size_t)bh * Tq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * Tkv * D;
  const __nv_bfloat16* vb = v + (size_t)bh * Tkv * D;
  const float* lb = lse + (size_t)bh * Tq;
  const float* db = delta + (size_t)bh * Tq;
  const float* bb = bias ? bias + (size_t)(bh / H) * Tkv : nullptr;

  // This thread's two keys, and whether each is in range and kept.
  int keys[2];
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    keys[r] = kv0 + k0 + g + 8 * r;
    key_ok[r] = keys[r] < Tkv && (bb == nullptr || bb[keys[r]] > 0.5f * NEG_INF);
  }

  const int n_chunks = (Tq + BQC - 1) / BQC;
  int first = 0;
  if (causal) {
    // Chunk c sees key kv0 iff kv0 <= (c + 1)·BQC − 1 + shift.
    const int x = kv0 - shift;
    first = x <= 0 ? 0 : x / BQC;
  }

  auto load_chunk = [&](int c, int stage) {
    __nv_bfloat16* Qc = QDs + stage * 2 * CHUNK;
    load_tile_bf16<BQC, DP>(Qc, qb, c * BQC, Tq, D, vec);
    load_tile_bf16<BQC, DP>(Qc + CHUNK, dob, c * BQC, Tq, D, vec);
    float* Lc = LDs + stage * 2 * BQC;
    for (int i = threadIdx.x; i < BQC; i += blockDim.x) {
      const int row = c * BQC + i;
      Lc[i] = row < Tq ? lb[row] : 0.f;
      Lc[BQC + i] = row < Tq ? db[row] : 0.f;
    }
  };

  load_tile_bf16<BKV, DP>(Ks, kb, kv0, Tkv, D, vec);
  load_tile_bf16<BKV, DP>(Vs, vb, kv0, Tkv, D, vec);
  if (first < n_chunks) load_chunk(first, 0);
  cp_async_commit();

  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    acc_k[n][0] = acc_k[n][1] = acc_k[n][2] = acc_k[n][3] = 0.f;
    acc_v[n][0] = acc_v[n][1] = acc_v[n][2] = acc_v[n][3] = 0.f;
  }
  // ldmatrix lane roles: row l % 8 of matrix l / 8.
  const int lr = lane & 7, lm = lane >> 3;

  for (int c = first; c < n_chunks; ++c) {
    const int stage = (c - first) & 1;
    const int qc0 = c * BQC;
    const __nv_bfloat16* Qs = QDs + stage * 2 * CHUNK;
    const __nv_bfloat16* dOs = Qs + CHUNK;
    const float* Ls = LDs + stage * 2 * BQC;
    const float* Ds = Ls + BQC;
    if (c + 1 < n_chunks) load_chunk(c + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // chunk c (and K, V) landed; c + 1 may be in flight
    __syncthreads();

    // sᵀ = k·qᵀ, 16 keys x 32 query rows per warp.
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; kk += 2) {
      uint32_t a0[4], a1[4];
      load_a<LD>(a0, Ks, k0, kk * 16, lane);
      load_a<LD>(a1, Ks, k0, kk * 16 + 16, lane);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t b[4];
        ldmatrix_x4<false>(b, Qs + (n * 8 + lr) * LD + kk * 16 + lm * 8);
        mma_bf16(s[n], a0, b[0], b[1]);
        mma_bf16(s[n], a1, b[2], b[3]);
      }
    }

    // pᵀ, in place of sᵀ.
    const bool masked = !interior(qc0, kv0, Tq, Tkv, causal, bb, BQC);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int qi = n * 8 + 2 * t + (i & 1);
        const int row = qc0 + qi;
        float p = __expf(s[n][i] * scale - Ls[qi]);
        if (masked && !(row < Tq && key_ok[r] &&
                        !(causal && row + shift < keys[r])))
          p = 0.f;
        s[n][i] = p;
      }
    }

    // dv += pᵀ·do: the pᵀ accumulators of n-tiles 2j and 2j+1 are the A
    // fragment of the 16-row chunk j; dO is read transposed.
#pragma unroll
    for (int j = 0; j < BQC / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_f32(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_f32(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_f32(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_f32(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t b[4];
        ldmatrix_x4<true>(
            b, dOs + (j * 16 + (lm & 1) * 8 + lr) * LD + (n + (lm >> 1)) * 8);
        mma_bf16(acc_v[n], a, b[0], b[1]);
        mma_bf16(acc_v[n + 1], a, b[2], b[3]);
      }
    }

    // dpᵀ = v·doᵀ.
    float dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; kk += 2) {
      uint32_t a0[4], a1[4];
      load_a<LD>(a0, Vs, k0, kk * 16, lane);
      load_a<LD>(a1, Vs, k0, kk * 16 + 16, lane);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t b[4];
        ldmatrix_x4<false>(b, dOs + (n * 8 + lr) * LD + kk * 16 + lm * 8);
        mma_bf16(dp[n], a0, b[0], b[1]);
        mma_bf16(dp[n], a1, b[2], b[3]);
      }
    }

    // dsᵀ = pᵀ ⊙ (dpᵀ − delta) · scale, then dk += dsᵀ·q.
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[n][i] = s[n][i] * (dp[n][i] - Ds[n * 8 + 2 * t + (i & 1)]) * scale;
#pragma unroll
    for (int j = 0; j < BQC / 16; ++j) {
      uint32_t a[4];
      a[0] = pack_f32(s[2 * j][0], s[2 * j][1]);
      a[1] = pack_f32(s[2 * j][2], s[2 * j][3]);
      a[2] = pack_f32(s[2 * j + 1][0], s[2 * j + 1][1]);
      a[3] = pack_f32(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t b[4];
        ldmatrix_x4<true>(
            b, Qs + (j * 16 + (lm & 1) * 8 + lr) * LD + (n + (lm >> 1)) * 8);
        mma_bf16(acc_k[n], a, b[0], b[1]);
        mma_bf16(acc_k[n + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= Tkv) continue;
    __nv_bfloat16* ok = dk + ((size_t)bh * Tkv + keys[r]) * D;
    __nv_bfloat16* ov = dv + ((size_t)bh * Tkv + keys[r]) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < D) {
        ok[col] = __float2bfloat16(acc_k[n][2 * r]);
        ov[col] = __float2bfloat16(acc_v[n][2 * r]);
      }
      if (col + 1 < D) {
        ok[col + 1] = __float2bfloat16(acc_k[n][2 * r + 1]);
        ov[col + 1] = __float2bfloat16(acc_v[n][2 * r + 1]);
      }
    }
  }
}

// --------------------------------------------------------- bf16, wgmma

constexpr int WG = 128;            // threads of a warpgroup
constexpr int WG_BKV = 128;        // keys of a block: 64 per consumer group
constexpr int CH = 64;             // query rows of a chunk
constexpr int STAGES = 4;          // chunks of Q, dO, lse and delta in flight
constexpr int KBOX = WG_BKV * 128; // bytes of a 128-row x 64-column bf16 box
constexpr int CBOX = CH * 128;     // bytes of a 64-row box
constexpr int PRODUCER_REGS = 24;  // setmaxnreg: 128 x 24 + 256 x 240
constexpr int CONSUMER_REGS = 240; //   registers fit the SM's 65,536
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of the wgmma variant: the 1024-byte alignment slack, K and
// V, STAGES x (Q, dO), STAGES x (lse·log2 e, delta), then the mbarriers.
constexpr int wgmma_smem(int DP) {
  return 1024 + 2 * (DP / 64) * KBOX + STAGES * 2 * (DP / 64) * CBOX +
         STAGES * 2 * CH * 4 + 8 * (1 + 2 * STAGES);
}

// The first chunk of query rows that sees key `key` (chunk c sees it iff
// key <= 64c + 63 + Tkv − Tq).
__device__ __forceinline__ int first_chunk(int key, int Tq, int Tkv,
                                           int causal) {
  const int x = key - (Tkv - Tq);
  return !causal || x <= 0 ? 0 : x / CH;
}

template <int DP>
__global__ void __launch_bounds__(3 * WG, 1)
    flash_bwd_dkv_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q,
                               __grid_constant__ const CUtensorMap tm_k,
                               __grid_constant__ const CUtensorMap tm_v,
                               __grid_constant__ const CUtensorMap tm_do,
                               __grid_constant__ const CUtensorMap tm_dk,
                               __grid_constant__ const CUtensorMap tm_dv,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               const float* __restrict__ bias, int H, int Tq,
                               int Tkv, int causal, float scale, int group) {
  constexpr int NB = DP / 64;     // 64-column boxes of a tile row
  constexpr int KT = NB * KBOX;   // bytes of the K or V tile
  constexpr int CT = NB * CBOX;   // bytes of a Q or dO chunk
  constexpr int NO = DP / 2;      // dk (and dv) accumulators a thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sk = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (sk - raw);
  const uint32_t sv = sk + KT;
  const uint32_t ring = sv + KT;  // stage s: Q at ring + 2·s·CT, dO after
  float* lring = reinterpret_cast<float*>(smem + 2 * KT + STAGES * 2 * CT);
  // Barriers: K and V landed, then `full` and `empty` of each stage.
  const uint32_t kv_full = ring + STAGES * 2 * CT + STAGES * 2 * CH * 4;
  const uint32_t full0 = kv_full + 8, empty0 = full0 + 8 * STAGES;

  // Key tiles nearer the start, which more causal chunks see, start first.
  int bh, kt;
  block_order((Tkv + WG_BKV - 1) / WG_BKV, group, bh, kt);
  const int kv0 = kt * WG_BKV;
  const int n_chunks = (Tq + CH - 1) / CH;
  const int c0 = first_chunk(kv0, Tq, Tkv, causal);  // the producer's first
  const int n = n_chunks - c0;                       // chunks it loads

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 32);  // every lane of the producer warp
      mbar_init(empty0 + 8 * s, 2);  // one arrival per consumer group
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < WG) {
    // Producer warp: lane 0 issues the TMA loads; every lane brings two
    // rows of lse (times log2 e) and delta, zero past Tq, and arrives.
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const float* lb = lse + (size_t)bh * Tq;
      const float* db = delta + (size_t)bh * Tq;
      if (lane == 0) {
        tma_prefetch(&tm_q);
        tma_prefetch(&tm_do);
        mbar_expect_tx(kv_full, 2 * KT);
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(sk + b * KBOX, &tm_k, kv_full, b * 64, kv0, bh);
          tma_load_3d(sv + b * KBOX, &tm_v, kv_full, b * 64, kv0, bh);
        }
      }
      for (int j = 0; j < n; ++j) {
        const int s = j % STAGES, row0 = (c0 + j) * CH;
        if (j >= STAGES) mbar_wait(empty0 + 8 * s, (j / STAGES - 1) & 1);
        float* ls = lring + s * 2 * CH;
        for (int r = lane; r < CH; r += 32) {
          const bool in = row0 + r < Tq;
          ls[r] = in ? lb[row0 + r] * LOG2E : 0.f;
          ls[CH + r] = in ? db[row0 + r] : 0.f;
        }
        if (lane == 0) {
          const uint32_t sq = ring + 2 * s * CT;
          mbar_expect_tx(full0 + 8 * s, 2 * CT);
          for (int b = 0; b < NB; ++b) {
            tma_load_3d(sq + b * CBOX, &tm_q, full0 + 8 * s, b * 64, row0, bh);
            tma_load_3d(sq + CT + b * CBOX, &tm_do, full0 + 8 * s, b * 64,
                        row0, bh);
          }
        } else {
          mbar_arrive(full0 + 8 * s);
        }
      }
    }
  } else {
    // Consumer warpgroup w: keys [kw0, kw0 + 64), from its first chunk.
    regs_inc<CONSUMER_REGS>();
    const int w = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0) - 1;
    const int tw = threadIdx.x % WG;
    const int warp = tw / 32, lane = tw % 32;
    const int g = lane >> 2, t = lane & 3;
    const int kw0 = kv0 + w * 64;
    const int shift = Tkv - Tq;
    const float* bb = bias ? bias + (size_t)(bh / H) * Tkv : nullptr;
    const uint32_t skw = sk + w * (KBOX / 2), svw = sv + w * (KBOX / 2);
    const float sl2 = scale * LOG2E;
    // This thread's two keys (rows g and g + 8 of its warp's 16), and
    // whether each is in range and kept by the bias.
    int keys[2];
    bool key_ok[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      keys[r] = kw0 + warp * 16 + g + 8 * r;
      key_ok[r] =
          keys[r] < Tkv && (bb == nullptr || bb[keys[r]] > 0.5f * NEG_INF);
    }
    const int cw = kw0 < Tkv ? first_chunk(kw0, Tq, Tkv, causal) : n_chunks;

    // Accumulator layout of wgmma m64nNk16, per warp: the m16n8 layout of
    // mma.sync repeated over N. Element 4·i + e sits at row g + 8·(e / 2),
    // column 8·i + 2·t + e % 2 of the warp's 16 rows (keys here).
    float dk[NO], dv[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.f;

    // x = a·bᵀ over DP / 16 steps: a the group's 64 rows of K or V (boxes
    // of 128 rows), b a chunk (boxes of 64 rows), both K-major.
    auto issue_t = [&](float(&x)[32], uint32_t a, uint32_t b) {
      wgmma_ss_init(x, wgmma_desc(a, 16, 1024), wgmma_desc(b, 16, 1024));
#pragma unroll
      for (int kk = 1; kk < DP / 16; ++kk)
        wgmma_ss(x,
                 wgmma_desc(a + (kk / 4) * KBOX + (kk % 4) * 32, 16, 1024),
                 wgmma_desc(b + (kk / 4) * CBOX + (kk % 4) * 32, 16, 1024));
    };
    // acc += a·b over the chunk's 64 rows: b (Q or dO) read MN-major.
    auto issue_acc = [&](float(&acc)[NO], const uint32_t(&a)[4][4],
                         uint32_t b) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wgmma_rs_tb(acc, a[c], wgmma_desc(b + c * 16 * 128, CBOX, 1024));
    };

    // One chunk: Sᵀ and dPᵀ go together; pᵀ is taken while dPᵀ runs, dsᵀ
    // while dV += pᵀ·dO runs, and dK += dsᵀ·Q runs on into the next
    // chunk's Sᵀ and dPᵀ. The A fragments are packed only once the product
    // that last read them has landed (ptxas serialises the products
    // otherwise).
    const int m = n_chunks - cw;  // chunks this group computes
    const int jb = cw - c0;       // ring index of its first
    float sc[32], dp[32];
    uint32_t a[4][4];
    auto chunk = [&](int j) { return ring + 2 * (j % STAGES) * CT; };
    auto issue_sdp = [&](int j) {
      issue_t(sc, skw, chunk(j));
      wgmma_commit();
      issue_t(dp, svw, chunk(j) + CT);
      wgmma_commit();
    };
    auto issue_dk = [&](int j) {
      issue_acc(dk, a, chunk(j));
      wgmma_commit();
    };
    // With Sᵀ of chunk j landed and dPᵀ in flight: pᵀ = exp(sᵀ·scale − lse)
    // on kept pairs, selected to 0 elsewhere (past Tq, where lse reads 0
    // and p would be 1; past Tkv; causally hidden or dropped by the bias),
    // dV += pᵀ·dO, and dsᵀ = pᵀ ⊙ (dpᵀ − delta)·scale packed into the A
    // fragments once dV's product has landed.
    auto take_ds = [&](int j) {
#pragma unroll
      for (int k = 0; k < 32; ++k) reg_fence(sc[k]);
      const int qc0 = (c0 + j) * CH;
      const float* ls = lring + (j % STAGES) * 2 * CH;
      const bool masked = !interior(qc0, kw0, Tq, Tkv, causal, bb, CH);
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int col = 8 * (k >> 2) + 2 * t + (k & 1);
        float p = ex2(sc[k] * sl2 - ls[col]);
        if (masked) {
          const int r = (k >> 1) & 1, row = qc0 + col;
          if (!(row < Tq && key_ok[r] && !(causal && row + shift < keys[r])))
            p = 0.f;
        }
        sc[k] = p;
      }
      pack_a(sc, a);  // pᵀ in do's dtype
      wgmma_fence();
      issue_acc(dv, a, chunk(j) + CT);
      wgmma_commit();
      wgmma_wait<1>();  // dPᵀ has landed
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        reg_fence(dp[k]);
        const int col = 8 * (k >> 2) + 2 * t + (k & 1);
        dp[k] = sc[k] * (dp[k] - ls[CH + col]) * scale;
      }
      wgmma_wait<0>();  // dV += pᵀ·dO has landed: its A fragments are free
#pragma unroll
      for (int i = 0; i < NO; ++i) reg_fence(dv[i]);
      pack_a(dp, a);  // dsᵀ in q's dtype
    };
    auto release = [&](int j) {
      if (tw == 0) mbar_arrive(empty0 + 8 * (j % STAGES));
    };

    if (m > 0) mbar_wait(kv_full, 0);
    // The chunks before this group's first: let each go once it landed.
    for (int j = 0; j < jb; ++j) {
      mbar_wait(full0 + 8 * (j % STAGES), (j / STAGES) & 1);
      release(j);
    }
    for (int j = jb; j < n; ++j) {
      mbar_wait(full0 + 8 * (j % STAGES), (j / STAGES) & 1);
      wgmma_fence();
      issue_sdp(j);
      wgmma_wait<1>();  // dK of the chunk before and Sᵀ have landed
      if (j > jb) release(j - 1);
      take_ds(j);
      wgmma_fence();
      issue_dk(j);
    }
    wgmma_wait<0>();
    if (m > 0) release(n - 1);
#pragma unroll
    for (int i = 0; i < NO; ++i) reg_fence(dk[i]);

    // Epilogue: dk and dv in bf16 through this group's K and V rows
    // (swizzled as TMA reads them) and TMA stores, which clip at Tkv and D.
    if (kw0 < Tkv) {
      mbar_wait(kv_full, 0);
      named_sync(1 + w, WG);  // every warp of the group is done with K, V
      stage_rows(smem + w * (KBOX / 2), dk, KBOX, warp, g, t);
      stage_rows(smem + KT + w * (KBOX / 2), dv, KBOX, warp, g, t);
      fence_async_shared();
      named_sync(1 + w, WG);
      if (tw == 0) {
        for (int b = 0; b < NB; ++b) {
          tma_store_3d(&tm_dk, skw + b * KBOX, b * 64, kw0, bh);
          tma_store_3d(&tm_dv, svw + b * KBOX, b * 64, kw0, bh);
        }
        tma_store_wait();
      }
    }
  }
}

// ----------------------------------------------------------------- f32

constexpr int SIMT_WARPS = 8;
constexpr int SIMT_THREADS = SIMT_WARPS * 32;

template <int DP>
__global__ void __launch_bounds__(SIMT_THREADS)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const float* __restrict__ bias,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int H, int Tq, int Tkv, int D, int causal,
                             float scale) {
  constexpr int LDQ = DP + 1;            // odd: lanes read rows conflict-free
  constexpr int KEYS = BKV / SIMT_WARPS; // keys per warp
  constexpr int DV = DP / 32;            // head dims per lane
  constexpr int QV = BQ / 32;            // query rows per lane
  extern __shared__ float fsm[];
  float* Ks = fsm;                  // BKV x DP
  float* Vs = Ks + BKV * DP;        // BKV x DP
  float* Qs = Vs + BKV * DP;        // BQ x LDQ
  float* dOs = Qs + BQ * LDQ;       // BQ x LDQ
  float* Ps = dOs + BQ * LDQ;       // BKV x BQ
  float* dSs = Ps + BKV * BQ;       // BKV x BQ
  float* Ls = dSs + BKV * BQ;       // BQ
  float* Ds = Ls + BQ;              // BQ

  const int bh = blockIdx.x;
  const int kv0 = blockIdx.y * BKV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int shift = Tkv - Tq;
  const float* qb = q + (size_t)bh * Tq * D;
  const float* dob = dout + (size_t)bh * Tq * D;
  const float* kb = k + (size_t)bh * Tkv * D;
  const float* vb = v + (size_t)bh * Tkv * D;
  const float* bb = bias ? bias + (size_t)(bh / H) * Tkv : nullptr;

  for (int i = threadIdx.x; i < BKV * DP; i += blockDim.x) {
    const int r = i / DP, c = i % DP;
    const bool in = kv0 + r < Tkv && c < D;
    Ks[i] = in ? kb[(size_t)(kv0 + r) * D + c] : 0.f;
    Vs[i] = in ? vb[(size_t)(kv0 + r) * D + c] : 0.f;
  }

  float acc_k[KEYS][DV], acc_v[KEYS][DV];
#pragma unroll
  for (int r = 0; r < KEYS; ++r)
#pragma unroll
    for (int d = 0; d < DV; ++d) acc_k[r][d] = acc_v[r][d] = 0.f;

  const int n_tiles = (Tq + BQ - 1) / BQ;
  int first = 0;
  if (causal) {
    const int x = kv0 - shift;
    first = x <= 0 ? 0 : x / BQ;
  }
  for (int i = first; i < n_tiles; ++i) {
    const int q0 = i * BQ;
    __syncthreads();
    for (int e = threadIdx.x; e < BQ * DP; e += blockDim.x) {
      const int r = e / DP, c = e % DP;
      const bool in = q0 + r < Tq && c < D;
      Qs[r * LDQ + c] = in ? qb[(size_t)(q0 + r) * D + c] : 0.f;
      dOs[r * LDQ + c] = in ? dob[(size_t)(q0 + r) * D + c] : 0.f;
    }
    for (int e = threadIdx.x; e < BQ; e += blockDim.x) {
      const bool in = q0 + e < Tq;
      Ls[e] = in ? lse[(size_t)bh * Tq + q0 + e] : 0.f;
      Ds[e] = in ? delta[(size_t)bh * Tq + q0 + e] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < KEYS; ++kk) {
      const int kl = warp * KEYS + kk;
      const int key = kv0 + kl;
#pragma unroll
      for (int h = 0; h < QV; ++h) {
        const int c = lane + 32 * h;
        const int row = q0 + c;
        float sd = 0.f, pd = 0.f;
        for (int d = 0; d < D; ++d) {
          sd += Ks[kl * DP + d] * Qs[c * LDQ + d];
          pd += Vs[kl * DP + d] * dOs[c * LDQ + d];
        }
        const float p = row < Tq && keep_pair(row, key, Tq, Tkv, causal, bb)
                            ? expf(sd * scale - Ls[c])
                            : 0.f;
        Ps[kl * BQ + c] = p;
        dSs[kl * BQ + c] = p * (pd - Ds[c]) * scale;
      }
      __syncwarp();
#pragma unroll
      for (int dd = 0; dd < DV; ++dd) {
        const int d = lane + 32 * dd;
        float av = acc_v[kk][dd], ak = acc_k[kk][dd];
        for (int c = 0; c < BQ; ++c) {
          av += Ps[kl * BQ + c] * dOs[c * LDQ + d];
          ak += dSs[kl * BQ + c] * Qs[c * LDQ + d];
        }
        acc_v[kk][dd] = av;
        acc_k[kk][dd] = ak;
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < KEYS; ++kk) {
    const int key = kv0 + warp * KEYS + kk;
    if (key >= Tkv) continue;
#pragma unroll
    for (int dd = 0; dd < DV; ++dd) {
      const int d = lane + 32 * dd;
      if (d < D) {
        dk[((size_t)bh * Tkv + key) * D + d] = acc_k[kk][dd];
        dv[((size_t)bh * Tkv + key) * D + d] = acc_v[kk][dd];
      }
    }
  }
}

// --------------------------------------------------------------- launch

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, const float* bias, void* dk,
                        void* dv, int B, int H, int Tq, int Tkv, int D,
                        int causal, float scale, cudaStream_t stream) {
  const int smem = (2 * BKV + 4 * BQC) * (DP + PAD) *
                       (int)sizeof(__nv_bfloat16) +
                   4 * BQC * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_bf16_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(dout);
  const dim3 grid(B * H, (Tkv + BKV - 1) / BKV);
  flash_bwd_dkv_bf16_kernel<DP><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, bias,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H,
      Tq, Tkv, D, causal, scale, vec);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, const float* bias, void* dk,
                         void* dv, int B, int H, int Tq, int Tkv, int D,
                         int causal, float scale, cudaStream_t stream) {
  if (D % 8 != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(dout) || !aligned16(dk) || !aligned16(dv))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  if (!tensor_map(&tq, q, B * H, Tq, D, CH) ||
      !tensor_map(&tk, k, B * H, Tkv, D, WG_BKV) ||
      !tensor_map(&tv, v, B * H, Tkv, D, WG_BKV) ||
      !tensor_map(&tdo, dout, B * H, Tq, D, CH) ||
      !tensor_map(&tdk, dk, B * H, Tkv, D, 64) ||
      !tensor_map(&tdv, dv, B * H, Tkv, D, 64))
    return cudaErrorInvalidValue;
  constexpr int smem = wgmma_smem(DP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)B * H * ((Tkv + WG_BKV - 1) / WG_BKV);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  // Batch·heads whose Q and dO (4·Tq·D bytes each) fill 16 MiB of the
  // 50 MB L2 run as one group.
  const long long group =
      std::max(1LL, std::min((long long)B * H, (16LL << 20) / (4LL * Tq * D)));
  flash_bwd_dkv_wgmma_kernel<DP><<<(unsigned)grid, 3 * WG, smem, stream>>>(
      tq, tk, tv, tdo, tdk, tdv, lse, delta, bias, H, Tq, Tkv, causal, scale,
      (int)group);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const float* bias, void* dk, void* dv, int B, int H,
                       int Tq, int Tkv, int D, int causal, float scale,
                       cudaStream_t stream) {
  const int smem = (2 * BKV * DP + 2 * BQ * (DP + 1) + 2 * BKV * BQ +
                    2 * BQ) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_f32_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tkv + BKV - 1) / BKV);
  flash_bwd_dkv_f32_kernel<DP><<<grid, SIMT_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, bias, static_cast<float*>(dk), static_cast<float*>(dv), H, Tq,
      Tkv, D, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// variant: 0 = f32 FMA, 1 = bf16 mma.sync, 2 = bf16 wgmma; it must suit
// the dtype, and wgmma needs D % 8 == 0 and 16-byte aligned q, k, v, do,
// dk, dv. Returns the CUDA error of the launch (0 on success); launches on
// `stream` and does not synchronise.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* bias, void* dk,
                             void* dv, int B, int H, int Tq, int Tkv, int D,
                             int causal, int dtype, int variant,
                             void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tkv < 1 || D < 1 || D > 128 ||
      (Tkv + BKV - 1) / BKV > 65535 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (variant == 2 && dtype == 1) {
    if (D <= 64)
      err = launch_wgmma<64>(q, k, v, dout, ls, dl, b, dk, dv, B, H, Tq, Tkv, D, causal, scale, s);
    else
      err = launch_wgmma<128>(q, k, v, dout, ls, dl, b, dk, dv, B, H, Tq, Tkv, D, causal, scale, s);
  } else if (variant == 1 && dtype == 1) {
    if (D <= 32)
      err = launch_bf16<32>(q, k, v, dout, ls, dl, b, dk, dv, B, H, Tq, Tkv, D, causal, scale, s);
    else if (D <= 64)
      err = launch_bf16<64>(q, k, v, dout, ls, dl, b, dk, dv, B, H, Tq, Tkv, D, causal, scale, s);
    else
      err = launch_bf16<128>(q, k, v, dout, ls, dl, b, dk, dv, B, H, Tq, Tkv, D, causal, scale, s);
  } else if (variant == 0 && dtype == 0) {
    if (D <= 32)
      err = launch_f32<32>(q, k, v, dout, ls, dl, b, dk, dv, B, H, Tq, Tkv, D, causal, scale, s);
    else if (D <= 64)
      err = launch_f32<64>(q, k, v, dout, ls, dl, b, dk, dv, B, H, Tq, Tkv, D, causal, scale, s);
    else
      err = launch_f32<128>(q, k, v, dout, ls, dl, b, dk, dv, B, H, Tq, Tkv, D, causal, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

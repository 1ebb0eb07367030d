// K1: flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// rafiki_tpu/ops/attention.py (launched by `_flash_forward`). It computes
// the same function: softmax(q·kᵀ·scale + mask)·v with an online softmax
// in f32, causal masking end-aligned (query row r sits at key position
// r + Tkv - Tq), kv tiles wholly above that shifted diagonal skipped, an
// optional per-example additive key bias (0 or NEG_INF, from kv_mask),
// and the per-row log-sum-exp `lse = m + log l` that a backward needs.
//
// Layout: q (B, H, Tq, D), k and v (B, H, Tkv, D), contiguous; bias
// (B, Tkv) f32 or null; o like q; lse (B, H, Tq) f32.
//
// Design. One thread block per (batch·head, tile of query rows); a loop
// inside the block walks the kv tiles up to the shifted diagonal, so no
// state passes between blocks, which Hopper runs in any order. The TPU
// kernel carried m, l and acc in VMEM scratch from one grid step to the
// next; here they live in registers for the whole loop. Three variants;
// the caller picks one by the shape (`flash_forward_variant` in
// ops/attention.py) and passes it in:
//  - bf16, wgmma (the main path; D % 8 == 0 and 16-byte aligned q, k,
//    v, o, as TMA needs): one block per 128 query rows, 384 threads in
//    three warpgroups. A producer warp keeps TMA loads in flight: Q once,
//    then K and V tiles of 128 keys through a ring of STAGES buffers,
//    each with a `full` and an `empty` mbarrier. Two consumer warpgroups
//    of 64 rows each compute S = Q·Kᵀ by `wgmma` m64n128k16 from the
//    swizzled shared-memory tiles, the online softmax in f32 registers,
//    and O += P·V by `wgmma` with P packed to bf16 in registers (the A
//    operand) and V read MN-major from shared memory. A consumer's loop
//    is software-pipelined (tile j's softmax runs beside P·V of tile
//    j − 1), and the two consumers take turns to issue their products,
//    so one's softmax overlaps the other's products. `setmaxnreg` moves
//    registers from the producer to the consumers. O leaves through
//    shared memory and a TMA store, which clips at Tq and D. Blocks run
//    in groups of batch·heads whose K and V fit in L2 together.
//  - bf16, mma.sync (D % 8 != 0 or a misaligned base): 4 warps, 16 query
//    rows each. Scores and P·V are `mma.sync`
//    m16n8k16 (bf16 in, f32 accumulate). The score accumulators are
//    re-packed in registers as the A operand of P·V (p cast to bf16, the
//    dtype of v, as the reference does), so p never touches shared
//    memory. Q stays in registers. K and V tiles pass through padded
//    shared memory (conflict-free `ldmatrix`, V read transposed) in two
//    stages: `cp.async` brings tile j + 1 while tile j computes. Tiles
//    wholly inside the mask skip the masking arithmetic, and the blocks
//    with the most causal tiles start first.
//  - f32: plain FMA in f32 (the reference computes in full f32), 8 warps
//    of 8 rows; the lanes split the keys for the scores and the head dim
//    for the accumulator.
//
// Bound. At the flagship shape (1, 16, 2048, 128) causal the work is
// 4·B·H·Tq·Tkv·D/2 ≈ 17.2 GFLOP against 33.6 MB moved: about 500 FLOP a
// byte, above the H100's ridge (~295), so the tensor cores bound it, and
// only `wgmma` reaches their full rate.
//
// The wgmma variant keeps the 64-row / 64-key tiling of the other two and
// of the plain version. Visiting (`kv_tiles`): each consumer warpgroup
// walks the 128-key tiles that cover its own 64-key tiles, and past them
// its keys score 2·NEG_INF, like keys out of range. Such a key weighs
// exactly nothing (the running max never falls below NEG_INF), so every
// row, the tiling-dependent ones below included, gets what the 64/64 walk
// gives. Rounding: p is rounded to bf16 against the running max after
// each 64-key half, as the plain version rounds it per kv tile, and O is
// rescaled between the two halves' products. With one max per 128 keys,
// p would round against another max than the plain version's wherever a
// row's max rises inside a tile, and o would leave its tolerance.
//
// Masking, exactly as the reference kernel orders it: a causally hidden
// key scores NEG_INF, then the kv_mask bias (0 or NEG_INF) is added, so a
// key both hidden and padded scores 2·NEG_INF. Keys past Tkv score
// 2·NEG_INF too and so never weigh anything (the running max starts at
// NEG_INF). Consequently a row whose visible keys are all padded by
// kv_mask comes out as the mean of v over the keys its causal window
// allows (all keys when not causal) with lse ≈ NEG_INF, which is what the
// reference kernel gives for an example whose kv_mask is all False. A
// row with no visible key for another reason (a left-padded causal
// window, or a row before the first key when Tq > Tkv) depends on the
// tiling, in the reference as here; the port's plain version
// (`flash_attention_reference`) uses this kernel's tiling.

#include <math.h>

#include <algorithm>

#include "flash_common.cuh"
#include "flash_hopper.cuh"

namespace {

using namespace flash;

// ---------------------------------------------------------------- bf16

constexpr int MMA_THREADS = 128;  // 4 warps x 16 rows

// The masked score of query row `row` against key `col`.
__device__ __forceinline__ float mask_score(float s, int row, int col,
                                            int Tq, int Tkv, int causal,
                                            const float* bias) {
  if (col >= Tkv) return 2.f * NEG_INF;
  float x = s;
  if (causal && row + (Tkv - Tq) < col) x = NEG_INF;
  if (bias) x += bias[col];
  return x;
}

template <int DP>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int H, int Tq, int Tkv,
                          int D, int causal, float scale, int vec) {
  constexpr int LD = DP + PAD;
  constexpr int KD = DP / 16;    // k-steps over the head dim
  constexpr int NS = BKV / 8;    // n-tiles of a score tile
  constexpr int NO = DP / 8;     // n-tiles of the output
  constexpr int TILE = BKV * LD; // elements of one K or V tile
  extern __shared__ __align__(16) unsigned char smem[];
  // Q, then two stages of (K, V): tile j + 1 loads while tile j computes.
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* KVs = Qs + BQ * LD;

  const int bh = blockIdx.x;
  // Causal blocks further down the sequence have more tiles: start them
  // first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  const __nv_bfloat16* qb = q + (size_t)bh * Tq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * Tkv * D;
  const __nv_bfloat16* vb = v + (size_t)bh * Tkv * D;
  const float* bb = bias ? bias + (size_t)(bh / H) * Tkv : nullptr;
  const int n_tiles = kv_tiles(q0, Tq, Tkv, causal);

  load_tile_bf16<BQ, DP>(Qs, qb, q0, Tq, D, vec);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile_bf16<BKV, DP>(KVs, kb, 0, Tkv, D, vec);
    load_tile_bf16<BKV, DP>(KVs + TILE, vb, 0, Tkv, D, vec);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const __nv_bfloat16* p = Qs + (r0 + g) * LD + kk * 16 + 2 * t;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * LD);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * LD + 8);
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  // ldmatrix lane roles: row l % 8 of matrix l / 8.
  const int lr = lane & 7, lm = lane >> 3;

  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BKV;
    const __nv_bfloat16* Ks = KVs + (j & 1) * 2 * TILE;
    const __nv_bfloat16* Vs = Ks + TILE;
    if (j + 1 < n_tiles) {
      __nv_bfloat16* nk = KVs + ((j + 1) & 1) * 2 * TILE;
      load_tile_bf16<BKV, DP>(nk, kb, kv0 + BKV, Tkv, D, vec);
      load_tile_bf16<BKV, DP>(nk + TILE, vb, kv0 + BKV, Tkv, D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed; tile j + 1 may be in flight
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; kk += 2) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        // b0, b1 of k-steps kk and kk + 1 for keys n*8 .. n*8+7.
        uint32_t b[4];
        ldmatrix_x4<false>(b, Ks + (n * 8 + lr) * LD + kk * 16 + lm * 8);
        mma_bf16(s[n], qf[kk], b[0], b[1]);
        if (kk + 1 < KD) mma_bf16(s[n], qf[kk + 1], b[2], b[3]);
      }
    }

    // Interior tiles (every key in range and visible to every row of the
    // block, no bias) need no mask.
    const bool masked = bb != nullptr || kv0 + BKV > Tkv ||
                        (causal && kv0 + BKV - 1 > q0 + (Tkv - Tq));
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[n][i] * scale;
        if (masked)
          x = mask_score(x, rows[i >> 1], kv0 + n * 8 + 2 * t + (i & 1), Tq,
                         Tkv, causal, bb);
        s[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = __expf(m[r] - mx[r]);
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = __expf(s[n][i] - mx[i >> 1]);
        s[n][i] = p;
        rs[i >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // P·V: the score accumulators of n-tiles 2c and 2c+1 are exactly the
    // A fragment of the 16-key chunk c.
#pragma unroll
    for (int c = 0; c < BKV / 16; ++c) {
      uint32_t a[4];
      a[0] = pack_f32(s[2 * c][0], s[2 * c][1]);
      a[1] = pack_f32(s[2 * c][2], s[2 * c][3]);
      a[2] = pack_f32(s[2 * c + 1][0], s[2 * c + 1][1]);
      a[3] = pack_f32(s[2 * c + 1][2], s[2 * c + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        // b0, b1 of output n-tiles n and n + 1 (V read transposed).
        uint32_t b[4];
        ldmatrix_x4<true>(
            b, Vs + (c * 16 + (lm & 1) * 8 + lr) * LD + (n + (lm >> 1)) * 8);
        mma_bf16(acc[n], a, b[0], b[1]);
        mma_bf16(acc[n + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows[r];
    if (row >= Tq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = o + ((size_t)bh * Tq + row) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < D) orow[col] = __float2bfloat16(acc[n][2 * r] / lc);
      if (col + 1 < D) orow[col + 1] = __float2bfloat16(acc[n][2 * r + 1] / lc);
    }
    if (t == 0) lse[(size_t)bh * Tq + row] = m[r] + logf(lc);
  }
}

// --------------------------------------------------------- bf16, wgmma

constexpr int WG = 128;          // threads of a warpgroup
constexpr int WG_BQ = 2 * BQ;    // query rows of a block: BQ per consumer
constexpr int WG_BKV = 128;      // keys of a kv tile
constexpr int STAGES = 3;        // K and V tiles in flight
constexpr int BOX = 128 * 128;   // bytes of a 128-row x 64-column bf16 box
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of the wgmma variant: the 1024-byte alignment slack, Q and
// STAGES x (K, V), then the mbarriers.
constexpr int wgmma_smem(int DP) {
  return 1024 + (1 + 2 * STAGES) * (DP / 64) * BOX + 8 * (1 + 2 * STAGES);
}

// The 128-key tiles that cover what a consumer group of BQ rows from r0
// visits under the 64/64 rule, and the first key that scores 2·NEG_INF
// for it: past Tkv, or past the last 64-key tile the rule visits.
__device__ __forceinline__ void group_span(int r0, int Tq, int Tkv, int causal,
                                           int& tiles, int& klim) {
  const int n64 = r0 < Tq ? kv_tiles(r0, Tq, Tkv, causal) : 0;
  tiles = (n64 + 1) / 2;
  klim = min(n64 * BKV, Tkv);
}

template <int DP>
__global__ void __launch_bounds__(3 * WG, 1)
    flash_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q,
                           __grid_constant__ const CUtensorMap tm_k,
                           __grid_constant__ const CUtensorMap tm_v,
                           __grid_constant__ const CUtensorMap tm_o,
                           const float* __restrict__ bias,
                           float* __restrict__ lse, int H, int Tq, int Tkv,
                           int causal, float scale, int group) {
  constexpr int NB = DP / 64;     // 64-column boxes of a tile row
  constexpr int TILE = NB * BOX;  // bytes of a Q, K or V tile
  constexpr int NO = DP / 2;      // output accumulators a thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (sq - raw);
  // Barriers: Q landed, then `full` and `empty` of each stage.
  const uint32_t q_full = sq + (1 + 2 * STAGES) * TILE;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * STAGES;

  // Blocks run in groups of `group` batch·heads, whose K and V fit in L2
  // together; inside a group, q tiles further down the sequence, which
  // have more causal kv tiles, start first.
  const int nq = (Tq + WG_BQ - 1) / WG_BQ;
  const int bhs = gridDim.x / nq;
  const int grp = blockIdx.x / (group * nq);
  const int size = min(group, bhs - grp * group);
  const int rem = blockIdx.x - grp * group * nq;
  const int bh = grp * group + rem % size;
  const int q0 = (nq - 1 - rem / size) * WG_BQ;
  int tiles0, klim0, tiles1, klim1;
  group_span(q0, Tq, Tkv, causal, tiles0, klim0);
  group_span(q0 + BQ, Tq, Tkv, causal, tiles1, klim1);
  const int n = max(tiles0, tiles1);  // tiles the producer loads

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);  // one arrival per consumer group
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < WG) {
    // Producer warpgroup: one thread issues every load.
    regs_dec<40>();
    if (threadIdx.x == 0 && n > 0) {
      tma_prefetch(&tm_q);
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
      mbar_expect_tx(q_full, TILE);
      for (int c = 0; c < NB; ++c)
        tma_load_3d(sq + c * BOX, &tm_q, q_full, c * 64, q0, bh);
      for (int j = 0; j < n; ++j) {
        const int s = j % STAGES;
        const uint32_t sk = sq + (1 + 2 * s) * TILE;
        if (j >= STAGES) mbar_wait(empty0 + 8 * s, (j / STAGES - 1) & 1);
        mbar_expect_tx(full0 + 8 * s, 2 * TILE);
        for (int c = 0; c < NB; ++c) {
          tma_load_3d(sk + c * BOX, &tm_k, full0 + 8 * s, c * 64,
                      j * WG_BKV, bh);
          tma_load_3d(sk + TILE + c * BOX, &tm_v, full0 + 8 * s, c * 64,
                      j * WG_BKV, bh);
        }
      }
    }
  } else {
    // Consumer warpgroup w: query rows [r0, r0 + BQ). Both groups walk
    // all n tiles; past its own span a group's keys score 2·NEG_INF.
    regs_inc<232>();
    const int w = threadIdx.x / WG - 1;
    const int tw = threadIdx.x % WG;
    const int warp = tw / 32, lane = tw % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + w * BQ;
    const int rows[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
    const int klim = w == 0 ? klim0 : klim1;
    const int shift = Tkv - Tq;
    const float* bb = bias ? bias + (size_t)(bh / H) * Tkv : nullptr;
    const uint32_t sqw = sq + w * (BOX / 2);  // this group's rows of Q

    // Accumulator layout of wgmma m64nNk16, per warp: the m16n8 layout of
    // mma.sync repeated over N. Element 4·i + e sits at row g + 8·(e / 2),
    // column 8·i + 2·t + e % 2 of the warp's 16 rows.
    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums

    // S = Q·Kᵀ of the K tile at sk, over DP / 16 steps of 16 head dims.
    auto issue_scores = [&](float(&sc)[64], uint32_t sk) {
      wgmma_ss_init(sc, wgmma_desc(sqw, 16, 1024), wgmma_desc(sk, 16, 1024));
#pragma unroll
      for (int kk = 1; kk < DP / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
        wgmma_ss(sc, wgmma_desc(sqw + off, 16, 1024),
                 wgmma_desc(sk + off, 16, 1024));
      }
    };
    // O += P·V over half hf (keys [64 hf, 64 hf + 64)) of the V tile at sv.
    auto issue_pv = [&](const uint32_t(&pa)[8][4], uint32_t sv, int hf) {
#pragma unroll
      for (int c = 4 * hf; c < 4 * hf + 4; ++c)
        wgmma_rs_tb(acc, pa[c], wgmma_desc(sv + c * 16 * 128, BOX, 1024));
    };
    auto rescale = [&](const float(&a)[2]) {
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        acc[i] *= a[(i >> 1) & 1];
        reg_fence(acc[i]);
      }
    };
    // Online softmax of tile j's scores over its two halves of BKV keys,
    // each as the reference takes a kv tile: x = s·scale, the running max
    // over the half, p = exp(x − max) in place of the scores. alpha[hf]
    // rescales O before half hf's product. Interior tiles (every key in
    // range, visited and visible to every row of the group, no bias) skip
    // the mask.
    auto softmax = [&](float(&sc)[64], int j, float(&alpha)[2][2]) {
      const int kv0 = j * WG_BKV;
      const bool masked = bb != nullptr || kv0 + WG_BKV > klim ||
                          (causal && kv0 + WG_BKV - 1 > r0 + shift);
      if (masked) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int col = kv0 + (i >> 2) * 8 + 2 * t + (i & 1);
          float x = sc[i] * scale;
          if (col >= klim) {
            x = 2.f * NEG_INF;
          } else {
            if (causal && rows[(i >> 1) & 1] + shift < col) x = NEG_INF;
            if (bb) x += bb[col];
          }
          sc[i] = x;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) sc[i] *= scale;
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 32 * hf; i < 32 * hf + 32; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[hf][r] = ex2((m[r] - mx[r]) * LOG2E);
          m[r] = mx[r];
          l[r] *= alpha[hf][r];
        }
        // (x − max) is exact where both are NEG_INF: a row whose keys are
        // all padded weighs each of them 1, as the reference does.
#pragma unroll
        for (int i = 32 * hf; i < 32 * hf + 32; ++i) {
          sc[i] = ex2((sc[i] - mx[(i >> 1) & 1]) * LOG2E);
          l[(i >> 1) & 1] += sc[i];
        }
      }
    };
    // p cast to bf16 (v's dtype, as the reference casts it) into the A
    // fragments of P·V: the score accumulators of n-tiles 2c and 2c + 1
    // are exactly the A fragment of keys [16c, 16c + 16).
    auto pack = [&](const float(&sc)[64], uint32_t(&pa)[8][4]) {
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[c][e] = pack_f32(sc[8 * c + 2 * e], sc[8 * c + 2 * e + 1]);
          reg_fence(pa[c][e]);
        }
    };

    // Software pipeline: step j issues P·V of tile j − 1 and S of tile j,
    // so tile j's softmax runs while the tensor cores take the second half
    // of P·V of tile j − 1; a last step takes P·V of tile n − 1. Each half
    // of P·V follows O's rescale for it: the first half goes with the
    // scores, and once it has landed (the scores keep the tensor cores
    // busy) O is rescaled and the second half goes. No register a running
    // product reads is written: p stays in f32 until the product has
    // landed and is packed only then (ptxas serialises the products
    // otherwise). The groups take turns to issue (named barriers 3 and 4),
    // so one group's softmax also overlaps the other's products; group 0
    // goes first.
    uint32_t pa[8][4];
    float alpha[2][2];
    if (n > 0) {
      if (w == 1) named_arrive(3, 2 * WG);
      mbar_wait(q_full, 0);
      mbar_wait(full0, 0);
      float sc[64];
      named_sync(3 + w, 2 * WG);
      wgmma_fence();
      issue_scores(sc, sq + TILE);
      wgmma_commit();
      named_arrive(4 - w, 2 * WG);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 64; ++i) reg_fence(sc[i]);
      softmax(sc, 0, alpha);
      pack(sc, pa);
    }
    for (int j = 1; j < n; ++j) {
      const int sp = (j - 1) % STAGES, s = j % STAGES;
      mbar_wait(full0 + 8 * s, (j / STAGES) & 1);
      const uint32_t sv = sq + (2 + 2 * sp) * TILE;  // V of tile j − 1
      rescale(alpha[0]);
      named_sync(3 + w, 2 * WG);
      wgmma_fence();
      issue_pv(pa, sv, 0);
      wgmma_commit();
      float sc[64];
      issue_scores(sc, sq + (1 + 2 * s) * TILE);
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < NO; ++i) reg_fence(acc[i]);
      rescale(alpha[1]);
      wgmma_fence();
      issue_pv(pa, sv, 1);
      wgmma_commit();
      named_arrive(4 - w, 2 * WG);
      wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < 64; ++i) reg_fence(sc[i]);
      float an[2][2];
      softmax(sc, j, an);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NO; ++i) reg_fence(acc[i]);
      if (tw == 0) mbar_arrive(empty0 + 8 * sp);
      pack(sc, pa);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        alpha[hf][0] = an[hf][0];
        alpha[hf][1] = an[hf][1];
      }
    }
    if (n > 0) {
      const int sp = (n - 1) % STAGES;
      const uint32_t sv = sq + (2 + 2 * sp) * TILE;
      rescale(alpha[0]);
      named_sync(3 + w, 2 * WG);
      wgmma_fence();
      issue_pv(pa, sv, 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NO; ++i) reg_fence(acc[i]);
      rescale(alpha[1]);
      wgmma_fence();
      issue_pv(pa, sv, 1);
      wgmma_commit();
      if (w == 0) named_arrive(4, 2 * WG);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NO; ++i) reg_fence(acc[i]);
      if (tw == 0) mbar_arrive(empty0 + 8 * sp);
    }

    // Epilogue: o = acc / max(l, 1e-30) in bf16 through this group's Q
    // rows (swizzled as TMA reads them) and a TMA store; lse in f32.
    float lc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      lc[r] = fmaxf(l[r], 1e-30f);
    }
    named_sync(1 + w, WG);  // every warp of the group is done with Q
    unsigned char* so = smem + w * (BOX / 2);
#pragma unroll
    for (int i = 0; i < NO / 4; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = warp * 16 + g + 8 * r;
        *reinterpret_cast<uint32_t*>(so + (i / 8) * BOX + rr * 128 +
                                     (((i % 8) ^ (rr & 7)) << 4) + 4 * t) =
            pack_f32(acc[4 * i + 2 * r] / lc[r],
                     acc[4 * i + 2 * r + 1] / lc[r]);
      }
    }
    fence_async_shared();
    named_sync(1 + w, WG);
    if (tw == 0 && r0 < Tq) {
      for (int c = 0; c < NB; ++c)
        tma_store_3d(&tm_o, sqw + c * BOX, c * 64, r0, bh);
      tma_store_wait();
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (t == 0 && rows[r] < Tq)
        lse[(size_t)bh * Tq + rows[r]] = m[r] + logf(lc[r]);
  }
}

// ----------------------------------------------------------------- f32

constexpr int SIMT_WARPS = 8;
constexpr int SIMT_THREADS = SIMT_WARPS * 32;

template <int DP>
__global__ void __launch_bounds__(SIMT_THREADS)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ bias,
                         float* __restrict__ o, float* __restrict__ lse,
                         int H, int Tq, int Tkv, int D, int causal,
                         float scale) {
  constexpr int LDK = DP + 1;              // odd: lanes read rows conflict-free
  constexpr int ROWS = BQ / SIMT_WARPS;    // query rows per warp
  constexpr int DV = DP / 32;              // head dims per lane
  constexpr int KV = BKV / 32;             // keys per lane
  extern __shared__ float fsm[];
  float* Qs = fsm;                  // BQ x DP
  float* Ks = Qs + BQ * DP;         // BKV x LDK
  float* Vs = Ks + BKV * LDK;       // BKV x DP
  float* Ps = Vs + BKV * DP;        // BQ x BKV

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* qb = q + (size_t)bh * Tq * D;
  const float* kb = k + (size_t)bh * Tkv * D;
  const float* vb = v + (size_t)bh * Tkv * D;
  const float* bb = bias ? bias + (size_t)(bh / H) * Tkv : nullptr;

  for (int i = threadIdx.x; i < BQ * DP; i += blockDim.x) {
    const int r = i / DP, c = i % DP;
    Qs[i] = (q0 + r < Tq && c < D) ? qb[(size_t)(q0 + r) * D + c] : 0.f;
  }

  float acc[ROWS][DV];
  float m[ROWS], l[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int d = 0; d < DV; ++d) acc[r][d] = 0.f;
  }

  const int n_tiles = kv_tiles(q0, Tq, Tkv, causal);
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BKV;
    __syncthreads();
    for (int i = threadIdx.x; i < BKV * DP; i += blockDim.x) {
      const int r = i / DP, c = i % DP;
      const bool in = kv0 + r < Tkv && c < D;
      Ks[r * LDK + c] = in ? kb[(size_t)(kv0 + r) * D + c] : 0.f;
      Vs[i] = in ? vb[(size_t)(kv0 + r) * D + c] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int r = warp * ROWS + rr;
      const int row = q0 + r;
      float x[KV];
      float mx = m[rr];
#pragma unroll
      for (int h = 0; h < KV; ++h) {
        const int c = lane + 32 * h;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += Qs[r * DP + d] * Ks[c * LDK + d];
        x[h] = mask_score(dot * scale, row, kv0 + c, Tq, Tkv, causal, bb);
        mx = fmaxf(mx, x[h]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m[rr] - mx);
      float sum = 0.f;
#pragma unroll
      for (int h = 0; h < KV; ++h) {
        const float p = expf(x[h] - mx);
        Ps[r * BKV + lane + 32 * h] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[rr] = l[rr] * alpha + sum;
      m[rr] = mx;
      __syncwarp();
#pragma unroll
      for (int dv = 0; dv < DV; ++dv) {
        const int d = lane + 32 * dv;
        float a = acc[rr][dv] * alpha;
        for (int c = 0; c < BKV; ++c) a += Ps[r * BKV + c] * Vs[c * DP + d];
        acc[rr][dv] = a;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int row = q0 + warp * ROWS + rr;
    if (row >= Tq) continue;
    const float lc = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int dv = 0; dv < DV; ++dv) {
      const int d = lane + 32 * dv;
      if (d < D) o[((size_t)bh * Tq + row) * D + d] = acc[rr][dv] / lc;
    }
    if (lane == 0) lse[(size_t)bh * Tq + row] = m[rr] + logf(lc);
  }
}

// --------------------------------------------------------------- launch

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const float* bias, void* o, float* lse, int B, int H,
                        int Tq, int Tkv, int D, int causal, float scale,
                        cudaStream_t stream) {
  const int smem = (BQ + 4 * BKV) * (DP + PAD) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  flash_fwd_bf16_kernel<DP><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias,
      static_cast<__nv_bfloat16*>(o), lse, H, Tq, Tkv, D, causal, scale, vec);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point, so the library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (B·H, T, D) bf16 tensor as a 3-D tensor map of boxes of 64 columns x
// `rows` rows, 128-byte swizzled; TMA zero-fills a box past T and past D.
bool tensor_map(CUtensorMap* map, const void* base, int BH, int T, int D,
                int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const float* bias, void* o, float* lse, int B, int H,
                         int Tq, int Tkv, int D, int causal, float scale,
                         cudaStream_t stream) {
  if (D % 8 != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(o))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, to;
  if (!tensor_map(&tq, q, B * H, Tq, D, WG_BQ) ||
      !tensor_map(&tk, k, B * H, Tkv, D, WG_BKV) ||
      !tensor_map(&tv, v, B * H, Tkv, D, WG_BKV) ||
      !tensor_map(&to, o, B * H, Tq, D, BQ))
    return cudaErrorInvalidValue;
  constexpr int smem = wgmma_smem(DP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)B * H * ((Tq + WG_BQ - 1) / WG_BQ);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  // Batch·heads whose K and V (4·Tkv·D bytes each) fill 16 MiB of the
  // 50 MB L2 run as one group.
  const long long group =
      std::max(1LL, std::min((long long)B * H, (16LL << 20) / (4LL * Tkv * D)));
  flash_fwd_wgmma_kernel<DP><<<(unsigned)grid, 3 * WG, smem, stream>>>(
      tq, tk, tv, to, bias, lse, H, Tq, Tkv, causal, scale, (int)group);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const float* bias, void* o, float* lse, int B, int H,
                       int Tq, int Tkv, int D, int causal, float scale,
                       cudaStream_t stream) {
  const int smem =
      (BQ * DP + BKV * (DP + 1) + BKV * DP + BQ * BKV) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  flash_fwd_f32_kernel<DP><<<grid, SIMT_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<float*>(o), lse, H, Tq,
      Tkv, D, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// variant: 0 = f32 FMA, 1 = bf16 mma.sync, 2 = bf16 wgmma; it must suit
// the dtype, and wgmma needs D % 8 == 0 and 16-byte aligned q, k, v, o.
// Returns the CUDA error of the launch (0 on success); launches on `stream`
// and does not synchronise.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* bias, void* o, void* lse, int B, int H,
                         int Tq, int Tkv, int D, int causal, int dtype,
                         int variant, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tkv < 1 || D < 1 || D > 128 ||
      (Tq + BQ - 1) / BQ > 65535 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  const float* b = static_cast<const float*>(bias);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (variant == 2 && dtype == 1) {
    if (D <= 64)
      err = launch_wgmma<64>(q, k, v, b, o, ls, B, H, Tq, Tkv, D, causal, scale, s);
    else
      err = launch_wgmma<128>(q, k, v, b, o, ls, B, H, Tq, Tkv, D, causal, scale, s);
  } else if (variant == 1 && dtype == 1) {
    if (D <= 32)
      err = launch_bf16<32>(q, k, v, b, o, ls, B, H, Tq, Tkv, D, causal, scale, s);
    else if (D <= 64)
      err = launch_bf16<64>(q, k, v, b, o, ls, B, H, Tq, Tkv, D, causal, scale, s);
    else
      err = launch_bf16<128>(q, k, v, b, o, ls, B, H, Tq, Tkv, D, causal, scale, s);
  } else if (variant == 0 && dtype == 0) {
    if (D <= 32)
      err = launch_f32<32>(q, k, v, b, o, ls, B, H, Tq, Tkv, D, causal, scale, s);
    else if (D <= 64)
      err = launch_f32<64>(q, k, v, b, o, ls, B, H, Tq, Tkv, D, causal, scale, s);
    else
      err = launch_f32<128>(q, k, v, b, o, ls, B, H, Tq, Tkv, D, causal, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

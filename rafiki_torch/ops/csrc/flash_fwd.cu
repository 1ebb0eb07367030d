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
//  - f32 (the reference computes in full f32; the int8 ViT serving path
//    attends in f32): `mma.sync` m16n8k8 on TF32 tensor cores, each product in
//    three passes. One TF32 pass keeps 10 mantissa bits (about 5e-4 relative)
//    and would miss the f32 tolerance tens of times over; each operand x is
//    split into big = tf32(x) (round to nearest, ties away, as
//    `cvt.rna.tf32.f32`, on the bit pattern) and small = x − big, rounded to
//    TF32 too for q and k, and small·big′ + big·small′ + big·big′ leaves about
//    2^-22 relative per product (p and v: small is read to 10 mantissa bits as
//    it is, about 2^-21). Each 8-deep step of the scores sums into a fresh
//    accumulator, added to the running scores in f32, so the tensor cores' own
//    rounding of a sum stays at an 8-term partial; O accumulates in place. The
//    softmax stays in f32 registers in the plain version's order (`ex2.approx`
//    for its exponentials). Tiles fit short sequences: a warp owns 16 query
//    rows, a block up to 8 warps spread evenly (5 for 65 tokens: one block a
//    batch·head, its K and V read once), and keys walk 64-key tiles with the
//    last trimmed to a multiple of 8: 80 × 72 for 65 × 65, where the 64/64
//    tiling did 128 × 128. A warp walks the kv tiles its 64-row group walks
//    (`kv_tiles`), as the plain version does, so the tiling-dependent rows
//    below come out as the plain version's. K and V arrive by `cp.async` (16
//    bytes where D % 4 == 0 and the bases are aligned, else 4) into two
//    stages, a tile ahead of the one that computes. Bound: at the int8 ViT
//    shape (1024, 4, 65, 65, 32) the 137 MB take 0.041 ms at 3.35 TB/s and the
//    2.2 GFLOP 0.033 ms at f32's 67 TFLOP/s (the 9.1 GFLOP of three TF32
//    passes over the fitted tiles take 0.018 ms at 495): bytes bound it.
//    Choices against the obvious ones: `cvt.rna.tf32.f32` is done on the bit
//    pattern, and p's and v's small parts are not rounded, since ptxas expands
//    each cvt into about five instructions and the splits are most of the
//    kernel's instructions (the scores are where sharp attention needs the
//    bits); Q's fragments are read from shared memory at each step, not kept
//    in registers, and DP = 32 is held to 128 registers, so three blocks (15
//    warps) fit an SM; Q and K rows take a stride ≡ 8 (mod 32) with a step's
//    head dims in the order 2t, 2t + 1, so each of their fragments is one
//    conflict-free 8-byte load.
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
#include <type_traits>

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

// x rounded to TF32 (10 mantissa bits; ties away from zero), as the
// 32-bit pattern `mma.sync` takes with its low 13 bits zero. This is what
// `cvt.rna.tf32.f32` gives for a finite x, in two integer instructions;
// ptxas expands the cvt into about five (it also sorts out NaN and
// infinity).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small: big = tf32(x) and small = x − big, which f32 holds
// exactly. ROUND: small rounded to TF32 too, and big + small keeps x to
// about 2^-22; else `mma.sync` reads small to its top 10 mantissa bits
// (dropping the rest), to about 2^-21, for two instructions less.
template <bool ROUND>
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  const float rest = x - __uint_as_float(big);
  small = ROUND ? tf32(rest) : __float_as_uint(rest);
}

// d += a·b for one m16n8k8 tile (TF32 in, f32 accumulate).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b of one 8-deep step to f32 accuracy from split operands (a[0],
// b[0] big; a[1], b[1] small): small·big and big·small, then big·big.
// small·small (2^-22 relative) is dropped.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a)[2][4],
                                     const uint32_t (&b)[2][2]) {
  mma_tf32(d, a[1], b[0][0], b[0][1]);
  mma_tf32(d, a[0], b[1][0], b[1][1]);
  mma_tf32(d, a[0], b[0][0], b[0][1]);
}

// Rows [row0, row0 + rows) of a (T, D) f32 matrix into shared memory with
// row stride LD, zero past T and past D, by `cp.async`: 16 bytes a copy
// where `vec` (D % 4 == 0 and a 16-byte aligned base), else 4.
template <int DP, int LD>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int row0, int rows, int T,
                                              int D, bool vec) {
  if (vec) {
    constexpr int CH = DP / 4;
    for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
      const int r = i / CH, c = (i % CH) * 4;
      const bool in = row0 + r < T && c < D;
      const float* from = in ? src + (size_t)(row0 + r) * D + c : src;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   ::"r"(smem_addr(dst + r * LD + c)), "l"(from),
                   "r"(in ? 16 : 0));
    }
  } else {
    for (int i = threadIdx.x; i < rows * DP; i += blockDim.x) {
      const int r = i / DP, c = i % DP;
      const bool in = row0 + r < T && c < D;
      const float* from = in ? src + (size_t)(row0 + r) * D + c : src;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   ::"r"(smem_addr(dst + r * LD + c)), "l"(from),
                   "r"(in ? 4 : 0));
    }
  }
}

// Warps of a block of the f32 variant at most: 8 (128 query rows), 4 at
// DP = 128, where Q and two stages of K and V would not fit otherwise.
constexpr int f32_warps(int DP) { return DP == 128 ? 4 : 8; }

// Shared memory of the f32 variant for blocks of w warps: Q, then two
// stages of K and two of V.
constexpr int f32_smem(int DP, int w) {
  return (16 * w * (DP + 8) + 2 * BKV * ((DP + 8) + (DP + 4))) *
         (int)sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(f32_warps(DP) * 32, DP == 32 ? 2 : 1)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ bias,
                         float* __restrict__ o, float* __restrict__ lse,
                         int H, int Tq, int Tkv, int D, int causal,
                         float scale, int vec, int pair) {
  // Q and K rows: stride ≡ 8 (mod 32) floats, so the 8-byte fragment
  // loads of a half-warp hit 32 banks once. V rows: ≡ 4, so the two
  // 4-byte loads of a B fragment (keys 2t and 2t + 1) are conflict-free.
  constexpr int LDQ = DP + 8, LDK = DP + 8, LDV = DP + 4;
  constexpr int KD = DP / 8;    // k-steps of S; n-tiles of O
  constexpr int NC = BKV / 8;   // 8-key chunks of a kv tile
  extern __shared__ __align__(16) float fsm[];
  const int w = blockDim.x / 32;
  float* Qs = fsm;
  float* Ks = Qs + 16 * w * LDQ;
  float* Vs = Ks + 2 * BKV * LDK;

  const int bh = blockIdx.x;
  // Causal blocks further down the sequence have more tiles: start them
  // first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 16 * w;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 16 * warp;
  const int shift = Tkv - Tq;
  const float* bb = bias ? bias + (size_t)bh / H * Tkv : nullptr;
  // The visiting rule of the plain version: a row walks the kv tiles of
  // its 64-row group. The block walks those of its last real row.
  const int nw = r0 < Tq ? kv_tiles(r0 & ~(BQ - 1), Tq, Tkv, causal) : 0;
  const int n = kv_tiles((min(q0 + 16 * w, Tq) - 1) & ~(BQ - 1), Tq, Tkv,
                         causal);
  // Keys of the kv tile at kv0, trimmed to a multiple of 8.
  auto keys = [&](int kv0) { return min(BKV, (Tkv - kv0 + 7) & ~7); };
  // Tile j into stage j % 2; tile j + 1 lands while tile j computes.
  auto load_kv = [&](int j) {
    const size_t base = (size_t)bh * Tkv * D;
    load_rows_f32<DP, LDK>(Ks + (j & 1) * BKV * LDK, k + base, j * BKV,
                           keys(j * BKV), Tkv, D, vec);
    load_rows_f32<DP, LDV>(Vs + (j & 1) * BKV * LDV, v + base, j * BKV,
                           keys(j * BKV), Tkv, D, vec);
  };

  if (n > 0) {
    load_rows_f32<DP, LDQ>(Qs, q + (size_t)bh * Tq * D, q0, 16 * w, Tq, D,
                           vec);
    load_kv(0);
  }
  cp_async_commit();

  // A fragment of Q for k-step kk, split: with the head dims of a step
  // visited as 2t, 2t + 1 (k = t, t + 4), a row's pair is one 8-byte
  // load. Q and K take the same order, so S is unchanged.
  auto q_frag = [&](int kk, uint32_t(&a)[2][4]) {
    const float* p = Qs + (16 * warp + g) * LDQ + 8 * kk + 2 * t;
    const float2 x0 = *reinterpret_cast<const float2*>(p);
    const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * LDQ);
    split<true>(x0.x, a[0][0], a[1][0]);
    split<true>(x1.x, a[0][1], a[1][1]);
    split<true>(x0.y, a[0][2], a[1][2]);
    split<true>(x1.y, a[0][3], a[1][3]);
  };

  float acc[KD][4];
#pragma unroll
  for (int d = 0; d < KD; ++d)
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums

  for (int j = 0; j < n; ++j) {
    if (j + 1 < n) load_kv(j + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile j has landed; tile j + 1 may be in flight
    __syncthreads();
    if (j < nw) {
      const int kv0 = j * BKV;
      const float* Kt = Ks + (j & 1) * BKV * LDK;
      const float* Vt = Vs + (j & 1) * BKV * LDV;
      const int nc = keys(kv0) / 8;
      // Interior tiles (every key in range and visible to every row of
      // the warp, no bias) need no mask, and only a trimmed last tile
      // skips chunks: each case compiles to code without branches.
      const bool masked = bb != nullptr || kv0 + BKV > Tkv ||
                          (causal && kv0 + BKV - 1 > r0 + shift);
      auto tile = [&](auto full, auto masking) {
        constexpr bool FULL = decltype(full)::value;
        constexpr bool MASKED = decltype(masking)::value;
        auto live = [&](int c) { return FULL || c < nc; };

        // S = Q·Kᵀ over the tile's chunks of 8 keys. Accumulator
        // element e of chunk c: row g + 8·(e / 2), key 8c + 2t + e % 2.
        float s[NC][4];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          s[c][0] = s[c][1] = s[c][2] = s[c][3] = 0.f;
        // Unrolled at DP = 32, where it fits 128 registers unspilled.
#pragma unroll(DP == 32 ? DP / 8 : 1)
        for (int kk = 0; kk < KD; ++kk) {
          uint32_t a[2][4];
          q_frag(kk, a);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            if (live(c)) {
              const float2 kx = *reinterpret_cast<const float2*>(
                  Kt + (8 * c + g) * LDK + 8 * kk + 2 * t);
              uint32_t b[2][2];
              split<true>(kx.x, b[0][0], b[1][0]);
              split<true>(kx.y, b[0][1], b[1][1]);
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              mma3(d, a, b);
#pragma unroll
              for (int e = 0; e < 4; ++e) s[c][e] += d[e];
            }
          }
        }

        // The online softmax over the tile, in f32 as the plain version
        // takes a kv tile.
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (live(c)) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float x = s[c][e] * scale;
              if constexpr (MASKED)
                x = mask_score(x, r0 + g + 8 * (e >> 1),
                               kv0 + 8 * c + 2 * t + (e & 1), Tq, Tkv,
                               causal, bb);
              s[c][e] = x;
              mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
          }
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          // (x − max) is exact where both are NEG_INF: a row whose keys
          // so far are all hidden weighs each of them 1, as the plain
          // version does.
          alpha[r] = ex2((m[r] - mx[r]) * LOG2E);
          m[r] = mx[r];
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (live(c)) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[c][e] = ex2((s[c][e] - mx[e >> 1]) * LOG2E);
              l[e >> 1] += s[c][e];
            }
          }
        }
#pragma unroll
        for (int d = 0; d < KD; ++d) {
          acc[d][0] *= alpha[0];
          acc[d][1] *= alpha[0];
          acc[d][2] *= alpha[1];
          acc[d][3] *= alpha[1];
        }

        // O += P·V. With key 2t of a chunk as k = t and key 2t + 1 as
        // k = t + 4, this lane's own accumulators (c0, c2, c1, c3) are
        // its A fragment, and its B fragment is V's rows 2t and 2t + 1.
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (live(c)) {
            uint32_t pa[2][4];
            split<false>(s[c][0], pa[0][0], pa[1][0]);
            split<false>(s[c][2], pa[0][1], pa[1][1]);
            split<false>(s[c][1], pa[0][2], pa[1][2]);
            split<false>(s[c][3], pa[0][3], pa[1][3]);
            const float* vp = Vt + (8 * c + 2 * t) * LDV + g;
#pragma unroll
            for (int d = 0; d < KD; ++d) {
              uint32_t b[2][2];
              split<false>(vp[8 * d], b[0][0], b[1][0]);
              split<false>(vp[8 * d + LDV], b[0][1], b[1][1]);
              mma3(acc[d], pa, b);
            }
          }
        }
      };
      using yes = std::true_type;
      using no = std::false_type;
      if (nc < NC)
        tile(no{}, yes{});  // a trimmed tile is masked: keys past Tkv
      else if (masked)
        tile(yes{}, yes{});
      else
        tile(yes{}, no{});
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + g + 8 * r;
    if (row >= Tq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    float* orow = o + ((size_t)bh * Tq + row) * D;
#pragma unroll
    for (int d = 0; d < KD; ++d) {
      const int col = 8 * d + 2 * t;
      const float o0 = acc[d][2 * r] / lc, o1 = acc[d][2 * r + 1] / lc;
      if (pair && col + 1 < D) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(o0, o1);
      } else {
        if (col < D) orow[col] = o0;
        if (col + 1 < D) orow[col + 1] = o1;
      }
    }
    if (t == 0) lse[(size_t)bh * Tq + row] = m[r] + logf(lc);
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
  // Warps of 16 query rows, at most f32_warps(DP) a block, spread evenly
  // over a batch·head's blocks: every block holds a real row, and a short
  // sequence is one block a batch·head (5 warps at 65 tokens), its K and
  // V read once.
  const int groups = (Tq + 15) / 16;
  const int least = (groups + f32_warps(DP) - 1) / f32_warps(DP);
  const int w = (groups + least - 1) / least;
  const int smem = f32_smem(DP, w);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int vec = D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  const int pair = D % 2 == 0 && reinterpret_cast<uintptr_t>(o) % 8 == 0;
  const dim3 grid(B * H, (groups + w - 1) / w);
  flash_fwd_f32_kernel<DP><<<grid, 32 * w, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<float*>(o), lse, H, Tq,
      Tkv, D, causal, scale, vec, pair);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// variant: 0 = f32 (split TF32), 1 = bf16 mma.sync, 2 = bf16 wgmma; it
// must suit the dtype, and wgmma needs D % 8 == 0 and 16-byte aligned q,
// k, v, o.
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

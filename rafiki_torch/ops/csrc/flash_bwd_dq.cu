// K2: flash-attention backward, dq, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_dq_kernel` of
// rafiki_tpu/ops/attention.py (launched by `_flash_backward`). For one
// tile of query rows it walks the kv tiles the forward walked and
// computes, from the forward's per-row log-sum-exp `lse` and
// `delta = rowsum(do ⊙ o)`:
//
//   p  = exp(q·kᵀ·scale − lse)   on kept pairs, 0 elsewhere (a select)
//   dp = do·vᵀ
//   ds = p ⊙ (dp − delta) · scale
//   dq = Σ_tiles ds·k            (ds cast to k's dtype, f32 sums)
//
// A pair is kept when the key is in range, causally visible (end-aligned:
// query row r sits at key position r + Tkv − Tq) and kept by the kv_mask
// bias (0 or NEG_INF). On a dropped pair exp(...) may be +inf (a row whose
// keys are all padded has lse ≈ NEG_INF), so it is selected away, never
// multiplied by zero.
//
// Layout: q, do and dq (B, H, Tq, D); k, v (B, H, Tkv, D), contiguous;
// lse, delta (B, H, Tq) f32; bias (B, Tkv) f32 or null.
//
// Design. One thread block per (batch·head, tile of query rows). A loop
// inside the block walks the kv tiles of BKV = 64 keys up to the causal
// diagonal (the tiles K1 visits), with the dq accumulator in f32
// registers for the whole loop: the Hopper counterpart of the TPU's
// sequential "arbitrary" grid axis with VMEM scratch. Each block writes
// its own rows of dq once, with no atomics, so dq comes out the same from
// run to run. Three variants; the caller picks one by the shape
// (`flash_backward_variant` in ops/attention.py) and passes it in:
//  - bf16, wgmma (the main path; D % 8 == 0 and 16-byte aligned q, k, v,
//    do, dq, as TMA needs): one block per 128 query rows, 384 threads in
//    three warpgroups. A producer warp loads Q and dO once by TMA, then
//    streams K and V tiles through a ring of STAGES buffers, each with a
//    `full` and an `empty` mbarrier. Two consumer warpgroups own 64 rows
//    each, with dq (64 x D f32) in registers, and walk only the tiles
//    their own rows see: S = Q·Kᵀ and dP = dO·Vᵀ by `wgmma` m64n64k16
//    from the swizzled tiles (both K-major), p by `ex2` with scale·log2 e
//    and lse·log2 e folded in, and dQ += ds·K by `wgmma` with ds packed to
//    bf16 in registers (the A operand) and the K tile read MN-major: one
//    tile, two descriptors. A tile's p is taken while its dP runs, and its
//    dQ runs on into the next tile's S and dP; the two groups' products
//    and elementwise work interleave on their own. `setmaxnreg` moves
//    registers from the producer (24) to the consumers (240). dq leaves through the group's own Q rows in shared
//    memory and a TMA store, which clips at Tq and D. Blocks run in groups
//    of batch·heads whose K and V fit in L2 together, q tiles further down
//    the sequence (more kv tiles) first.
//  - bf16, mma.sync (D % 8 != 0 or a misaligned base): 4 warps of 16
//    query rows, BQ = 64 rows a block. The three products (q·kᵀ, do·vᵀ,
//    ds·k) are `mma.sync` m16n8k16 with f32 accumulators. Q and dO stay
//    in shared memory for the whole loop and feed `ldmatrix` A fragments;
//    K and V tiles pass through padded shared memory in two stages, tile
//    j + 1 arriving by `cp.async` while tile j computes. ds is re-packed
//    in registers as the bf16 A fragment of ds·k (K read transposed), so
//    it never touches shared memory. Interior tiles skip the masking.
//  - f32: plain FMA in f32, 8 warps of 8 rows, as K1's f32 path.
//
// The result does not depend on the tiling: every pair that is hidden,
// out of range or padded is selected to zero and each p and ds element is
// rounded on its own, so only the order of the f32 sums differs between
// the variants.
//
// Bound. At the flagship train shape (8, 16, 2048, 2048, 128) causal the
// three products over the unmasked pairs are 206.3 GFLOP against 0.34 GB
// of inputs and output, about 610 FLOP a byte: above the H100's ridge
// (~295), so the tensor cores bound it, at 0.2086 ms at 989 TFLOP/s.

#include <math.h>

#include <algorithm>

#include "flash_common.cuh"
#include "flash_hopper.cuh"

namespace {

using namespace flash;

constexpr int MMA_THREADS = 128;  // 4 warps x 16 rows

template <int DP>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const float* __restrict__ bias,
                             __nv_bfloat16* __restrict__ dq, int H, int Tq,
                             int Tkv, int D, int causal, float scale,
                             int vec) {
  constexpr int LD = DP + PAD;
  constexpr int KD = DP / 16;    // k-steps over the head dim
  constexpr int NS = BKV / 8;    // n-tiles of a score tile
  constexpr int NO = DP / 8;     // n-tiles of dq
  constexpr int TILE = BKV * LD; // elements of one K or V tile
  extern __shared__ __align__(16) unsigned char smem[];
  // Q, dO, then two stages of (K, V): tile j + 1 loads while tile j
  // computes.
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + BQ * LD;
  __nv_bfloat16* KVs = dOs + BQ * LD;

  const int bh = blockIdx.x;
  // Causal blocks further down the sequence have more tiles: start them
  // first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  const __nv_bfloat16* qb = q + (size_t)bh * Tq * D;
  const __nv_bfloat16* dob = dout + (size_t)bh * Tq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * Tkv * D;
  const __nv_bfloat16* vb = v + (size_t)bh * Tkv * D;
  const float* bb = bias ? bias + (size_t)(bh / H) * Tkv : nullptr;
  const int n_tiles = kv_tiles(q0, Tq, Tkv, causal);

  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < Tq;
    lse_r[r] = in ? lse[(size_t)bh * Tq + rows[r]] : 0.f;
    delta_r[r] = in ? delta[(size_t)bh * Tq + rows[r]] : 0.f;
  }

  load_tile_bf16<BQ, DP>(Qs, qb, q0, Tq, D, vec);
  load_tile_bf16<BQ, DP>(dOs, dob, q0, Tq, D, vec);
  if (n_tiles > 0) {
    load_tile_bf16<BKV, DP>(KVs, kb, 0, Tkv, D, vec);
    load_tile_bf16<BKV, DP>(KVs + TILE, vb, 0, Tkv, D, vec);
  }
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
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
    cp_async_wait<1>();  // tile j (and Q, dO) landed; j + 1 may be in flight
    __syncthreads();

    // s = q·kᵀ and dp = do·vᵀ, 16 rows x 64 keys per warp.
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KD; kk += 2) {
      uint32_t aq[2][4], ad[2][4];
      load_a<LD>(aq[0], Qs, r0, kk * 16, lane);
      load_a<LD>(aq[1], Qs, r0, kk * 16 + 16, lane);
      load_a<LD>(ad[0], dOs, r0, kk * 16, lane);
      load_a<LD>(ad[1], dOs, r0, kk * 16 + 16, lane);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        // b0, b1 of k-steps kk and kk + 1 for keys n*8 .. n*8+7.
        uint32_t b[4];
        ldmatrix_x4<false>(b, Ks + (n * 8 + lr) * LD + kk * 16 + lm * 8);
        mma_bf16(s[n], aq[0], b[0], b[1]);
        mma_bf16(s[n], aq[1], b[2], b[3]);
        ldmatrix_x4<false>(b, Vs + (n * 8 + lr) * LD + kk * 16 + lm * 8);
        mma_bf16(dp[n], ad[0], b[0], b[1]);
        mma_bf16(dp[n], ad[1], b[2], b[3]);
      }
    }

    // ds = p ⊙ (dp − delta) · scale, in place of s.
    const bool masked = !interior(q0, kv0, Tq, Tkv, causal, bb);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        float p = __expf(s[n][i] * scale - lse_r[r]);
        if (masked && !keep_pair(rows[r], kv0 + n * 8 + 2 * t + (i & 1), Tq,
                                 Tkv, causal, bb))
          p = 0.f;
        s[n][i] = p * (dp[n][i] - delta_r[r]) * scale;
      }
    }

    // dq += ds·k: the ds accumulators of n-tiles 2c and 2c+1 are the A
    // fragment of the 16-key chunk c; K is read transposed.
#pragma unroll
    for (int c = 0; c < BKV / 16; ++c) {
      uint32_t a[4];
      a[0] = pack_f32(s[2 * c][0], s[2 * c][1]);
      a[1] = pack_f32(s[2 * c][2], s[2 * c][3]);
      a[2] = pack_f32(s[2 * c + 1][0], s[2 * c + 1][1]);
      a[3] = pack_f32(s[2 * c + 1][2], s[2 * c + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t b[4];
        ldmatrix_x4<true>(
            b, Ks + (c * 16 + (lm & 1) * 8 + lr) * LD + (n + (lm >> 1)) * 8);
        mma_bf16(acc[n], a, b[0], b[1]);
        mma_bf16(acc[n + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rows[r];
    if (row >= Tq) continue;
    __nv_bfloat16* out = dq + ((size_t)bh * Tq + row) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + 2 * t;
      if (col < D) out[col] = __float2bfloat16(acc[n][2 * r]);
      if (col + 1 < D) out[col + 1] = __float2bfloat16(acc[n][2 * r + 1]);
    }
  }
}

// --------------------------------------------------------- bf16, wgmma

constexpr int WG = 128;            // threads of a warpgroup
constexpr int WG_BQ = 2 * BQ;      // query rows of a block: BQ per consumer
constexpr int STAGES = 4;          // K and V tiles of BKV keys in flight
constexpr int QBOX = WG_BQ * 128;  // bytes of a 128-row x 64-column bf16 box
constexpr int KBOX = BKV * 128;    // bytes of a 64-row box
constexpr int PRODUCER_REGS = 24;  // setmaxnreg: 128 x 24 + 256 x 240
constexpr int CONSUMER_REGS = 240; //   registers fit the SM's 65,536
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of the wgmma variant: the 1024-byte alignment slack, Q and
// dO, STAGES x (K, V), then the mbarriers.
constexpr int wgmma_smem(int DP) {
  return 1024 + 2 * (DP / 64) * QBOX + STAGES * 2 * (DP / 64) * KBOX +
         8 * (1 + 2 * STAGES);
}

template <int DP>
__global__ void __launch_bounds__(3 * WG, 1)
    flash_bwd_dq_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q,
                              __grid_constant__ const CUtensorMap tm_k,
                              __grid_constant__ const CUtensorMap tm_v,
                              __grid_constant__ const CUtensorMap tm_do,
                              __grid_constant__ const CUtensorMap tm_dq,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const float* __restrict__ bias, int H, int Tq,
                              int Tkv, int causal, float scale, int group) {
  constexpr int NB = DP / 64;     // 64-column boxes of a tile row
  constexpr int QT = NB * QBOX;   // bytes of the Q or dO tile
  constexpr int KT = NB * KBOX;   // bytes of a K or V tile
  constexpr int NO = DP / 2;      // dq accumulators a thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (sq - raw);
  const uint32_t sdo = sq + QT;
  const uint32_t ring = sdo + QT;  // stage s: K at ring + 2·s·KT, V after
  // Barriers: Q and dO landed, then `full` and `empty` of each stage.
  const uint32_t q_full = ring + STAGES * 2 * KT;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * STAGES;

  // q tiles further down the sequence, which have more causal kv tiles,
  // start first.
  const int nq = (Tq + WG_BQ - 1) / WG_BQ;
  int bh, qt;
  block_order(nq, group, bh, qt);
  const int q0 = (nq - 1 - qt) * WG_BQ;
  // The kv tiles each consumer group's rows see (K1's visiting rule).
  const int n0 = kv_tiles(q0, Tq, Tkv, causal);
  const int n1 = q0 + BQ < Tq ? kv_tiles(q0 + BQ, Tq, Tkv, causal) : 0;
  const int n = max(n0, n1);  // tiles the producer loads

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
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0 && n > 0) {
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
      mbar_expect_tx(q_full, 2 * QT);
      for (int b = 0; b < NB; ++b) {
        tma_load_3d(sq + b * QBOX, &tm_q, q_full, b * 64, q0, bh);
        tma_load_3d(sdo + b * QBOX, &tm_do, q_full, b * 64, q0, bh);
      }
      for (int j = 0; j < n; ++j) {
        const int s = j % STAGES;
        const uint32_t sk = ring + 2 * s * KT;
        if (j >= STAGES) mbar_wait(empty0 + 8 * s, (j / STAGES - 1) & 1);
        mbar_expect_tx(full0 + 8 * s, 2 * KT);
        for (int b = 0; b < NB; ++b) {
          tma_load_3d(sk + b * KBOX, &tm_k, full0 + 8 * s, b * 64, j * BKV,
                      bh);
          tma_load_3d(sk + KT + b * KBOX, &tm_v, full0 + 8 * s, b * 64,
                      j * BKV, bh);
        }
      }
    }
  } else {
    // Consumer warpgroup w: query rows [r0, r0 + BQ), over its own tiles.
    regs_inc<CONSUMER_REGS>();
    const int w = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0) - 1;
    const int tw = threadIdx.x % WG;
    const int warp = tw / 32, lane = tw % 32;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + w * BQ;
    const int nw = w == 0 ? n0 : n1;
    const int rows[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
    const float* bb = bias ? bias + (size_t)(bh / H) * Tkv : nullptr;
    const uint32_t sqw = sq + w * (QBOX / 2), sdow = sdo + w * (QBOX / 2);
    const float sl2 = scale * LOG2E;
    float lse_r[2], delta_r[2];  // lse times log2 e; 0 past Tq
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = rows[r] < Tq;
      lse_r[r] = in ? lse[(size_t)bh * Tq + rows[r]] * LOG2E : 0.f;
      delta_r[r] = in ? delta[(size_t)bh * Tq + rows[r]] : 0.f;
    }

    // Accumulator layout of wgmma m64nNk16, per warp: the m16n8 layout of
    // mma.sync repeated over N. Element 4·i + e sits at row g + 8·(e / 2),
    // column 8·i + 2·t + e % 2 of the warp's 16 rows.
    float dq[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) dq[i] = 0.f;

    // x = a·bᵀ over DP / 16 steps: a the group's 64 rows of Q or dO (boxes
    // of 128 rows), b a K or V tile (boxes of 64 rows), both K-major.
    auto issue_t = [&](float(&x)[32], uint32_t a, uint32_t b) {
      wgmma_ss_init(x, wgmma_desc(a, 16, 1024), wgmma_desc(b, 16, 1024));
#pragma unroll
      for (int kk = 1; kk < DP / 16; ++kk)
        wgmma_ss(x,
                 wgmma_desc(a + (kk / 4) * QBOX + (kk % 4) * 32, 16, 1024),
                 wgmma_desc(b + (kk / 4) * KBOX + (kk % 4) * 32, 16, 1024));
    };
    float sc[32], dp[32];
    uint32_t a[4][4];
    // S and dP of tile j, committed one after the other.
    auto issue_sdp = [&](int j) {
      const uint32_t sk = ring + 2 * (j % STAGES) * KT;
      issue_t(sc, sqw, sk);
      wgmma_commit();
      issue_t(dp, sdow, sk + KT);
      wgmma_commit();
    };
    // dQ += ds·K of tile j, K read MN-major.
    auto issue_dq = [&](int j) {
      const uint32_t sk = ring + 2 * (j % STAGES) * KT;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        wgmma_rs_tb(dq, a[c], wgmma_desc(sk + c * 16 * 128, KBOX, 1024));
      wgmma_commit();
    };
    // With S of tile j landed and dP in flight: p = exp(s·scale − lse) on
    // kept pairs, selected to 0 elsewhere (past Tkv, causally hidden or
    // dropped by the bias), where exp(...) may be +inf; then, once dP has
    // landed, ds = p ⊙ (dp − delta)·scale packed into the A fragments.
    auto take_ds = [&](int j) {
#pragma unroll
      for (int k = 0; k < 32; ++k) reg_fence(sc[k]);
      const int kv0 = j * BKV;
      const bool masked = !interior(r0, kv0, Tq, Tkv, causal, bb);
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int r = (k >> 1) & 1;
        float p = ex2(sc[k] * sl2 - lse_r[r]);
        if (masked && !keep_pair(rows[r], kv0 + 8 * (k >> 2) + 2 * t + (k & 1),
                                 Tq, Tkv, causal, bb))
          p = 0.f;
        sc[k] = p;
      }
      wgmma_wait<0>();  // dP has landed
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        reg_fence(dp[k]);
        dp[k] = sc[k] * (dp[k] - delta_r[(k >> 1) & 1]) * scale;
      }
      pack_a(dp, a);  // ds in k's dtype
    };
    auto release = [&](int j) {
      if (tw == 0) mbar_arrive(empty0 + 8 * (j % STAGES));
    };

    // One tile: S and dP go together; p is taken while dP runs, and
    // dQ += ds·K runs on into the next tile's S and dP. ds is packed only
    // once the product that last read its registers has landed (ptxas
    // serialises the products otherwise).
    if (nw > 0) mbar_wait(q_full, 0);
    for (int j = 0; j < nw; ++j) {
      mbar_wait(full0 + 8 * (j % STAGES), (j / STAGES) & 1);
      wgmma_fence();
      issue_sdp(j);
      wgmma_wait<1>();  // dQ of the tile before and S have landed
      if (j > 0) release(j - 1);
      take_ds(j);
      wgmma_fence();
      issue_dq(j);
    }
    wgmma_wait<0>();
    if (nw > 0) release(nw - 1);
    // The tiles past this group's own: let each go once it landed.
    for (int j = nw; j < n; ++j) {
      mbar_wait(full0 + 8 * (j % STAGES), (j / STAGES) & 1);
      release(j);
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) reg_fence(dq[i]);

    // Epilogue: dq in bf16 through this group's Q rows (swizzled as TMA
    // reads them) and a TMA store, which clips at Tq and D. A group that
    // saw no key writes zeros.
    if (r0 < Tq) {
      if (n > 0) mbar_wait(q_full, 0);
      named_sync(1 + w, WG);  // every warp of the group is done with Q
      stage_rows(smem + w * (QBOX / 2), dq, QBOX, warp, g, t);
      fence_async_shared();
      named_sync(1 + w, WG);
      if (tw == 0) {
        for (int b = 0; b < NB; ++b)
          tma_store_3d(&tm_dq, sqw + b * QBOX, b * 64, r0, bh);
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
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const float* __restrict__ bias,
                            float* __restrict__ dq, int H, int Tq, int Tkv,
                            int D, int causal, float scale) {
  constexpr int LDK = DP + 1;            // odd: lanes read rows conflict-free
  constexpr int ROWS = BQ / SIMT_WARPS;  // query rows per warp
  constexpr int DV = DP / 32;            // head dims per lane
  constexpr int KV = BKV / 32;           // keys per lane
  extern __shared__ float fsm[];
  float* Qs = fsm;                  // BQ x DP
  float* dOs = Qs + BQ * DP;        // BQ x DP
  float* Ks = dOs + BQ * DP;        // BKV x LDK
  float* Vs = Ks + BKV * LDK;       // BKV x LDK
  float* dSs = Vs + BKV * LDK;      // BQ x BKV

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* qb = q + (size_t)bh * Tq * D;
  const float* dob = dout + (size_t)bh * Tq * D;
  const float* kb = k + (size_t)bh * Tkv * D;
  const float* vb = v + (size_t)bh * Tkv * D;
  const float* bb = bias ? bias + (size_t)(bh / H) * Tkv : nullptr;

  for (int i = threadIdx.x; i < BQ * DP; i += blockDim.x) {
    const int r = i / DP, c = i % DP;
    const bool in = q0 + r < Tq && c < D;
    Qs[i] = in ? qb[(size_t)(q0 + r) * D + c] : 0.f;
    dOs[i] = in ? dob[(size_t)(q0 + r) * D + c] : 0.f;
  }

  float acc[ROWS][DV];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int d = 0; d < DV; ++d) acc[r][d] = 0.f;

  const int n_tiles = kv_tiles(q0, Tq, Tkv, causal);
  for (int j = 0; j < n_tiles; ++j) {
    const int kv0 = j * BKV;
    __syncthreads();
    for (int i = threadIdx.x; i < BKV * DP; i += blockDim.x) {
      const int r = i / DP, c = i % DP;
      const bool in = kv0 + r < Tkv && c < D;
      Ks[r * LDK + c] = in ? kb[(size_t)(kv0 + r) * D + c] : 0.f;
      Vs[r * LDK + c] = in ? vb[(size_t)(kv0 + r) * D + c] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int r = warp * ROWS + rr;
      const int row = q0 + r;
      const float lse_r = row < Tq ? lse[(size_t)bh * Tq + row] : 0.f;
      const float delta_r = row < Tq ? delta[(size_t)bh * Tq + row] : 0.f;
#pragma unroll
      for (int h = 0; h < KV; ++h) {
        const int c = lane + 32 * h;
        float sd = 0.f, pd = 0.f;
        for (int d = 0; d < D; ++d) {
          sd += Qs[r * DP + d] * Ks[c * LDK + d];
          pd += dOs[r * DP + d] * Vs[c * LDK + d];
        }
        const float p = keep_pair(row, kv0 + c, Tq, Tkv, causal, bb)
                            ? expf(sd * scale - lse_r)
                            : 0.f;
        dSs[r * BKV + c] = p * (pd - delta_r) * scale;
      }
      __syncwarp();
#pragma unroll
      for (int dv = 0; dv < DV; ++dv) {
        const int d = lane + 32 * dv;
        float a = acc[rr][dv];
        for (int c = 0; c < BKV; ++c) a += dSs[r * BKV + c] * Ks[c * LDK + d];
        acc[rr][dv] = a;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int row = q0 + warp * ROWS + rr;
    if (row >= Tq) continue;
#pragma unroll
    for (int dv = 0; dv < DV; ++dv) {
      const int d = lane + 32 * dv;
      if (d < D) dq[((size_t)bh * Tq + row) * D + d] = acc[rr][dv];
    }
  }
}

// --------------------------------------------------------------- launch

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, const float* bias, void* dq,
                        int B, int H, int Tq, int Tkv, int D, int causal,
                        float scale, cudaStream_t stream) {
  const int smem = (2 * BQ + 4 * BKV) * (DP + PAD) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_bf16_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int vec = D % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(dout);
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  flash_bwd_dq_bf16_kernel<DP><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, bias,
      static_cast<__nv_bfloat16*>(dq), H, Tq, Tkv, D, causal, scale, vec);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, const float* bias, void* dq,
                         int B, int H, int Tq, int Tkv, int D, int causal,
                         float scale, cudaStream_t stream) {
  if (D % 8 != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(dout) || !aligned16(dq))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!tensor_map(&tq, q, B * H, Tq, D, WG_BQ) ||
      !tensor_map(&tk, k, B * H, Tkv, D, BKV) ||
      !tensor_map(&tv, v, B * H, Tkv, D, BKV) ||
      !tensor_map(&tdo, dout, B * H, Tq, D, WG_BQ) ||
      !tensor_map(&tdq, dq, B * H, Tq, D, BQ))
    return cudaErrorInvalidValue;
  constexpr int smem = wgmma_smem(DP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)B * H * ((Tq + WG_BQ - 1) / WG_BQ);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  // Batch·heads whose K and V (4·Tkv·D bytes each) fill 16 MiB of the
  // 50 MB L2 run as one group.
  const long long group =
      std::max(1LL, std::min((long long)B * H, (16LL << 20) / (4LL * Tkv * D)));
  flash_bwd_dq_wgmma_kernel<DP><<<(unsigned)grid, 3 * WG, smem, stream>>>(
      tq, tk, tv, tdo, tdq, lse, delta, bias, H, Tq, Tkv, causal, scale,
      (int)group);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const float* bias, void* dq, int B, int H, int Tq,
                       int Tkv, int D, int causal, float scale,
                       cudaStream_t stream) {
  const int smem = (2 * BQ * DP + 2 * BKV * (DP + 1) + BQ * BKV) *
                   (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_f32_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  flash_bwd_dq_f32_kernel<DP><<<grid, SIMT_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, bias, static_cast<float*>(dq), H, Tq, Tkv, D, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// variant: 0 = f32 FMA, 1 = bf16 mma.sync, 2 = bf16 wgmma; it must suit
// the dtype, and wgmma needs D % 8 == 0 and 16-byte aligned q, k, v, do,
// dq. Returns the CUDA error of the launch (0 on success); launches on
// `stream` and does not synchronise.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* bias, void* dq,
                            int B, int H, int Tq, int Tkv, int D, int causal,
                            int dtype, int variant, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tkv < 1 || D < 1 || D > 128 ||
      (Tq + BQ - 1) / BQ > 65535 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (variant == 2 && dtype == 1) {
    if (D <= 64)
      err = launch_wgmma<64>(q, k, v, dout, ls, dl, b, dq, B, H, Tq, Tkv, D, causal, scale, s);
    else
      err = launch_wgmma<128>(q, k, v, dout, ls, dl, b, dq, B, H, Tq, Tkv, D, causal, scale, s);
  } else if (variant == 1 && dtype == 1) {
    if (D <= 32)
      err = launch_bf16<32>(q, k, v, dout, ls, dl, b, dq, B, H, Tq, Tkv, D, causal, scale, s);
    else if (D <= 64)
      err = launch_bf16<64>(q, k, v, dout, ls, dl, b, dq, B, H, Tq, Tkv, D, causal, scale, s);
    else
      err = launch_bf16<128>(q, k, v, dout, ls, dl, b, dq, B, H, Tq, Tkv, D, causal, scale, s);
  } else if (variant == 0 && dtype == 0) {
    if (D <= 32)
      err = launch_f32<32>(q, k, v, dout, ls, dl, b, dq, B, H, Tq, Tkv, D, causal, scale, s);
    else if (D <= 64)
      err = launch_f32<64>(q, k, v, dout, ls, dl, b, dq, B, H, Tq, Tkv, D, causal, scale, s);
    else
      err = launch_f32<128>(q, k, v, dout, ls, dl, b, dq, B, H, Tq, Tkv, D, causal, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

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
// Design. One thread block per (batch·head, tile of BQ = 64 query rows);
// a loop inside the block walks the kv tiles of BKV = 64 keys up to the
// shifted diagonal, so no state passes between blocks, which Hopper runs
// in any order. The TPU kernel carried m, l and acc in VMEM scratch from
// one grid step to the next; here they live in registers for the whole
// loop.
//  - bf16: 4 warps, 16 query rows each. Scores and P·V are `mma.sync`
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
// byte, above the H100's ridge (~295), so the tensor cores bound it.
// This version uses mma.sync and cp.async; wgmma fed by TMA, with warp
// specialisation, is the way to the bound.
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

#include "flash_common.cuh"

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
// Returns the CUDA error of the launch (0 on success); launches on `stream`
// and does not synchronise.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* bias, void* o, void* lse, int B, int H,
                         int Tq, int Tkv, int D, int causal, int dtype,
                         void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tkv < 1 || D < 1 || D > 128 ||
      (Tq + BQ - 1) / BQ > 65535 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  const float* b = static_cast<const float*>(bias);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    if (D <= 32)
      err = launch_bf16<32>(q, k, v, b, o, ls, B, H, Tq, Tkv, D, causal, scale, s);
    else if (D <= 64)
      err = launch_bf16<64>(q, k, v, b, o, ls, B, H, Tq, Tkv, D, causal, scale, s);
    else
      err = launch_bf16<128>(q, k, v, b, o, ls, B, H, Tq, Tkv, D, causal, scale, s);
  } else if (dtype == 0) {
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

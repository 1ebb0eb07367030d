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
// Design. One thread block per (batch·head, tile of BQ = 64 query rows).
// A loop inside the block walks the kv tiles of BKV = 64 keys up to the
// causal diagonal (the tiles K1 visits), with the dq accumulator in f32
// registers for the whole loop: the Hopper counterpart of the TPU's
// sequential "arbitrary" grid axis with VMEM scratch. Each block writes
// its own rows of dq once, with no atomics, so dq comes out the same from
// run to run.
//  - bf16: 4 warps of 16 query rows. The three products (q·kᵀ, do·vᵀ,
//    ds·k) are `mma.sync` m16n8k16 with f32 accumulators. Q and dO stay
//    in shared memory for the whole loop and feed `ldmatrix` A fragments;
//    K and V tiles pass through padded shared memory in two stages, tile
//    j + 1 arriving by `cp.async` while tile j computes. ds is re-packed
//    in registers as the bf16 A fragment of ds·k (K read transposed), so
//    it never touches shared memory. Interior tiles skip the masking.
//  - f32: plain FMA in f32, 8 warps of 8 rows, as K1's f32 path.
//
// Bound. At the flagship train shape (8, 16, 2048, 2048, 128) causal the
// three products over the unmasked pairs are 206.3 GFLOP against 0.34 GB
// of inputs and output, about 610 FLOP a byte: above the H100's ridge
// (~295), so the tensor cores bound it, at 0.2086 ms at 989 TFLOP/s.
// This version uses mma.sync and cp.async; wgmma fed by TMA, with warp
// specialisation, is the way to the bound.

#include <math.h>

#include "flash_common.cuh"

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
// Returns the CUDA error of the launch (0 on success); launches on `stream`
// and does not synchronise.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* bias, void* dq,
                            int B, int H, int Tq, int Tkv, int D, int causal,
                            int dtype, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tkv < 1 || D < 1 || D > 128 ||
      (Tq + BQ - 1) / BQ > 65535 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    if (D <= 32)
      err = launch_bf16<32>(q, k, v, dout, ls, dl, b, dq, B, H, Tq, Tkv, D, causal, scale, s);
    else if (D <= 64)
      err = launch_bf16<64>(q, k, v, dout, ls, dl, b, dq, B, H, Tq, Tkv, D, causal, scale, s);
    else
      err = launch_bf16<128>(q, k, v, dout, ls, dl, b, dq, B, H, Tq, Tkv, D, causal, scale, s);
  } else if (dtype == 0) {
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

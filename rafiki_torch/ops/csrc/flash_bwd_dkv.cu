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
// Design. One thread block per (batch·head, tile of BKV = 64 keys). A
// loop inside the block walks the query rows from the first chunk that
// sees the tile (the inverse of K2's causal test: chunk c is needed iff
// kv0 <= last row of c + Tkv − Tq) to the end, with the dk and dv
// accumulators in f32 registers for the whole loop: the Hopper
// counterpart of the TPU's sequential "arbitrary" grid axis with VMEM
// scratch. Each block writes its own rows of dk and dv once, with no
// atomics, so they come out the same from run to run.
//  - bf16: 4 warps of 16 keys. Two f32 accumulators of 16 keys x D per
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
// Bound. At the flagship train shape (8, 16, 2048, 2048, 128) causal the
// four products over the unmasked pairs are 275.0 GFLOP against 0.41 GB
// of inputs and outputs, about 680 FLOP a byte: above the H100's ridge
// (~295), so the tensor cores bound it, at 0.2781 ms at 989 TFLOP/s.
// This version uses mma.sync and cp.async; wgmma fed by TMA, with warp
// specialisation, is the way to the bound.

#include <math.h>

#include "flash_common.cuh"

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
// Returns the CUDA error of the launch (0 on success); launches on `stream`
// and does not synchronise.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* bias, void* dk,
                             void* dv, int B, int H, int Tq, int Tkv, int D,
                             int causal, int dtype, void* stream) {
  if (B < 1 || H < 1 || Tq < 1 || Tkv < 1 || D < 1 || D > 128 ||
      (Tkv + BKV - 1) / BKV > 65535 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    if (D <= 32)
      err = launch_bf16<32>(q, k, v, dout, ls, dl, b, dk, dv, B, H, Tq, Tkv, D, causal, scale, s);
    else if (D <= 64)
      err = launch_bf16<64>(q, k, v, dout, ls, dl, b, dk, dv, B, H, Tq, Tkv, D, causal, scale, s);
    else
      err = launch_bf16<128>(q, k, v, dout, ls, dl, b, dk, dv, B, H, Tq, Tkv, D, causal, scale, s);
  } else if (dtype == 0) {
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

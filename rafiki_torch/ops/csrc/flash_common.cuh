// Helpers shared by the port's flash-attention kernels (K1 flash_fwd.cu,
// K2 flash_bwd_dq.cu, K3 flash_bwd_dkv.cu): the tiling, the masking rule,
// and the bf16 tensor-core building blocks (`ldmatrix`, `mma.sync`
// m16n8k16, `cp.async`).
//
// Fragment layout of `mma.sync.m16n8k16` for lane = 4·g + t: the f32
// accumulator c[i] sits at row g + 8·(i / 2), column 2·t + (i % 2) of the
// 16x8 tile. The accumulators of two neighbouring n-tiles, packed to
// bf16 in pairs, are exactly the A fragment of a 16x16 tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;   // query rows per tile
constexpr int BKV = 64;  // keys per tile
constexpr int PAD = 8;   // bf16 padding per shared-memory row

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. `trans` hands each thread the transposed
// fragment (the B operand from a row-major K x N tile).
template <bool trans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  if (trans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

// The A fragment of the 16x16 tile at rows [r0, r0 + 16), columns
// [c0, c0 + 16) of a row-major shared-memory matrix with row stride LD.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* base, int r0,
                                       int c0, int lane) {
  ldmatrix_x4<false>(a, base + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}

// c += a·b for one m16n8k16 tile: a 16x16 row-major, b 16x8 column-major.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + ROWS) of a (T, D) matrix into shared memory with row
// stride DP + PAD, zero past T and past D. `vec` (D % 8 == 0 and 16-byte
// aligned rows): 16-byte `cp.async` copies that land while the block
// computes, complete at the next `cp_async_wait`; otherwise plain loads.
template <int ROWS, int DP>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int row0, int T, int D,
                                               bool vec) {
  constexpr int LD = DP + PAD;
  if (vec) {
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < ROWS * CH; i += blockDim.x) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = row0 + r < T && c < D;
      const __nv_bfloat16* from = in ? src + (size_t)(row0 + r) * D + c : src;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   ::"r"(smem_addr(dst + r * LD + c)), "l"(from),
                   "r"(in ? 16 : 0));
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += blockDim.x) {
      const int r = i / DP, c = i % DP;
      __nv_bfloat16 val = __float2bfloat16(0.f);
      if (row0 + r < T && c < D) val = src[(size_t)(row0 + r) * D + c];
      dst[r * LD + c] = val;
    }
  }
}

// Index of one past the last kv tile a block of query rows [q0, q0+BQ)
// must visit.
__device__ __forceinline__ int kv_tiles(int q0, int Tq, int Tkv, int causal) {
  int n = (Tkv + BKV - 1) / BKV;
  if (causal) {
    const int last = min(q0 + BQ - 1, Tq - 1) + (Tkv - Tq);
    n = last < 0 ? 0 : min(n, last / BKV + 1);
  }
  return n;
}

// Whether the backward keeps query row `row` against key `col`: the key
// is in range, causally visible (end-aligned) and kept by the kv_mask
// bias. The reference's `valid` (`_flash_dq_kernel`, `_flash_dkv_kernel`).
__device__ __forceinline__ bool keep_pair(int row, int col, int Tq, int Tkv,
                                          int causal, const float* bias) {
  if (col >= Tkv) return false;
  if (causal && row + (Tkv - Tq) < col) return false;
  return bias == nullptr || bias[col] > 0.5f * NEG_INF;
}

// Whether a (BQ-row, BKV-key) tile pair [q0, q0 + BQ) x [kv0, kv0 + BKV)
// needs no masking at all: every key in range and visible to every row,
// no bias.
__device__ __forceinline__ bool interior(int q0, int kv0, int Tq, int Tkv,
                                         int causal, const float* bias,
                                         int rows = BQ) {
  return bias == nullptr && kv0 + BKV <= Tkv && q0 + rows <= Tq &&
         !(causal && kv0 + BKV - 1 > q0 + (Tkv - Tq));
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace flash

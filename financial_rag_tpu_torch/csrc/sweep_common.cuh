// Shared pieces of the flat sweeps K5-K7 (bucketed_topk.cu, topk_exact.cu).
//
// tile16_scores (the older sweeps, which K7 and f32 corpora keep): raw
// similarity of 16 query rows against 16 consecutive
// corpus rows, as ops/topk.py::_tile_scores defines it: bf16 on the tensor
// cores with f32 accumulation, int8 on the tensor cores with int32
// accumulation (mma.sync m16n8k32, exact, converted to f32 once), f32 on the
// CUDA cores. weighted_score: ops/topk.py::_weighted_mask in its order
// (score * w, then + (live - 1) * 1e5), rounded as the plain version rounds.
// sweep_key: a 64-bit key whose unsigned order is (score descending, corpus
// index ascending); 0 is below every real key, so it marks "no candidate".
#pragma once

#include <mma.h>

#include "common.cuh"

constexpr float kSweepNeg = -3.0e4f;  // ops/topk.py NEG

__device__ __forceinline__ void tile16_scores(const __nv_bfloat16* q, const __nv_bfloat16* x,
                                              int D, float* sc, int ldc, int /*lane*/) {
  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
  wmma::fill_fragment(c, 0.f);
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
    wmma::load_matrix_sync(a, q + kk, D);
    wmma::load_matrix_sync(b, x + kk, D);  // element (k, n) = x[n*D + k]
    wmma::mma_sync(c, a, b, c);
  }
  wmma::store_matrix_sync(sc, c, ldc, wmma::mem_row_major);
}

__device__ __forceinline__ void tile16_scores(const float* q, const float* x, int D, float* sc,
                                              int ldc, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = lane + 32 * i, r = e >> 4, col = e & 15;
    const float* qr = q + (size_t)r * D;
    const float* xr = x + (size_t)col * D;
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot += qr[d] * xr[d];
    sc[r * ldc + col] = dot;
  }
}

// c[16x8] += a[16x32] * b[32x8], int8 in, int32 accumulate. Fragments
// (gid = lane / 4, tig = lane % 4), four int8 per register, lowest k in the
// low byte: A regs 0-3 = (row gid, k 4tig..), (row gid+8, k 4tig..),
// (row gid, k 16+4tig..), (row gid+8, k 16+4tig..); B regs 0-1 = (k 4tig..,
// col gid), (k 16+4tig.., col gid); C elt i = (row gid + 8*(i>>1), col
// 2tig + (i&1)).
__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_s8x4(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D % 32 == 0 and 4-byte aligned rows.
__device__ __forceinline__ void tile16_scores(const int8_t* q, const int8_t* x, int D, float* sc,
                                              int ldc, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  int c[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  for (int kk = 0; kk < D; kk += 32) {
    const int8_t* qa = q + (size_t)gid * D + kk + 4 * tig;
    const uint32_t a0 = ld_s8x4(qa), a1 = ld_s8x4(qa + 8 * (size_t)D);
    const uint32_t a2 = ld_s8x4(qa + 16), a3 = ld_s8x4(qa + 8 * (size_t)D + 16);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int8_t* xb = x + (size_t)(8 * t + gid) * D + kk + 4 * tig;
      mma_s8(c[t], a0, a1, a2, a3, ld_s8x4(xb), ld_s8x4(xb + 16));
    }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int col = 8 * t + 2 * tig;
    // |dot| <= 127 * 127 * D: exact in f32 for D <= 1040, as in the plain version
    sc[gid * ldc + col] = __int2float_rn(c[t][0]);
    sc[gid * ldc + col + 1] = __int2float_rn(c[t][1]);
    sc[(gid + 8) * ldc + col] = __int2float_rn(c[t][2]);
    sc[(gid + 8) * ldc + col + 1] = __int2float_rn(c[t][3]);
  }
}

__device__ __forceinline__ float weighted_score(float s, float w) {
  const float live = w > 0.f ? 1.f : 0.f;
  return __fadd_rn(__fmul_rn(s, w), (live - 1.f) * 1.0e5f);
}

__device__ __forceinline__ unsigned long long sweep_key(float s, int idx) {
  unsigned int u = __float_as_uint(s == 0.f ? 0.f : s);  // -0 ties with +0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);       // order-preserving
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (unsigned int)idx);
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  const unsigned int u = (unsigned int)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (unsigned int)(key & 0xFFFFFFFFull));
}

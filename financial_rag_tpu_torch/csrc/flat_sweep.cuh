// The Hopper machinery of the flat sweeps K5 (bucketed_topk.cu) and K6
// (topk_exact.cu), bf16 and int8 corpora, a template over the width kD the
// features are zero-padded to: 384 (bge-small, gte-small) or 768 (bge-base,
// gte-base; K5 and K7 only, K6 stays at 384).
//
// A block scores a tile of queries (64 a consumer warpgroup) against tiles
// of 32 consecutive corpus rows. Its queries are loaded into shared memory
// once (cp.async, 128-byte swizzle, zeros past Bq and past D). A producer
// warp has the TMA copy each corpus tile (regions of 32 rows x 128 bytes,
// swizzled as the products read them, zeros past D) and its 32 weights (a
// bulk copy) into a ring of stages, as soon as every consumer warp has
// released the stage through its empty mbarrier; the bytes complete the
// stage's full mbarrier (the ring of K4, packed_topk.cu). Each warpgroup
// then takes scores = Q X^T by wgmma m64n32: k16 steps for bf16 with f32
// accumulation, k32 steps for int8 with exact int32 accumulation. Both
// operands are K-major, as [Bq, D] and [N, D] already lie (wgmma takes
// 8-bit operands in no other layout), so nothing is transposed. A thread's
// accumulator element i is (query row 16*(warp%4) + lane/4 + 8*((i>>1)&1),
// tile row 8*(i>>2) + 2*(lane%4) + (i&1)) in every tile, so what a sweep
// keeps per (query, column) can stay in registers across its tiles.
//
// block_topk is the selection both sweeps' merges share: the k largest of a
// block's 64-bit keys without k rounds of a block-wide maximum.
#pragma once

#include "hopper.cuh"
#include "sweep_common.cuh"

namespace flat {

using namespace hopper;

constexpr int kRows = 32;                 // corpus rows a tile (the wgmma N)
constexpr int kNarrowD = 384;             // features, zero-padded to this or to
constexpr int kWideD = 768;               // this one
constexpr int kRegionQ = 64 * 128;        // 64 query rows x 128 bytes
constexpr int kRegionX = kRows * 128;     // 32 corpus rows x 128 bytes
constexpr int kSmemBudget = 229376;       // dynamic shared memory a block may take (224 KB)

template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kBytes = 2;
  using Acc = float;
};
template <>
struct Elem<int8_t> {
  static constexpr int kBytes = 1;
  using Acc = int;
};

template <typename T, int kD>
struct Tiles {
  static_assert(kD == kNarrowD || kD == kWideD, "the sweeps pad to 384 or 768 features");
  static constexpr int kRowBytes = kD * Elem<T>::kBytes;     // 768 / 384 at 384, 1536 / 768 at 768
  static constexpr int kRegions = kRowBytes / 128;           // 128-byte column regions
  static constexpr int kChunks = kRowBytes / 16;             // 16-byte chunks of a row
  static constexpr int kQBytes = kRegions * kRegionQ;        // one warpgroup's queries
  static constexpr int kXBytes = kRegions * kRegionX;        // one corpus tile (a stage)
  static constexpr int kBoxCols = 128 / Elem<T>::kBytes;     // elements a TMA box row
};

__device__ __forceinline__ float acc_f32(float v) { return v; }
// |dot| <= 127 * 127 * 768 = 12,386,304 < 2^24: exact in f32, as in the
// plain version
__device__ __forceinline__ float acc_f32(int v) { return __int2float_rn(v); }

__device__ __forceinline__ void mma_n32(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_n32(d, a, b, acc);
}
__device__ __forceinline__ void mma_n32(int (&d)[16], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_n32_s8(d, a, b, acc);
}

// Rows q0 .. q0 + rows - 1 of q [Bq, D] into regions of 64 rows (one
// warpgroup's operand each), zeros past Bq and past D; published to the
// async proxy. Run by the `nthreads` consumer threads (thread `tid`).
template <typename T, int kD>
__device__ __forceinline__ void stage_queries(uint32_t sQ, const T* q, int q0, int rows, int Bq,
                                              int D, int tid, int nthreads) {
  constexpr int kChunks = Tiles<T, kD>::kChunks;
  const int row_bytes = D * Elem<T>::kBytes, dch = row_bytes / 16;
  const char* qb = reinterpret_cast<const char*>(q);
  for (int e = tid; e < rows * kChunks; e += nthreads) {
    const int r = e / kChunks, ch = e - r * kChunks, row = q0 + r;
    const bool ok = row < Bq && ch < dch;
    cp_async16(sQ + (r >> 6) * Tiles<T, kD>::kQBytes + sw128_chunk(r & 63, ch),
               qb + (ok ? (size_t)row * row_bytes + 16 * ch : 0), ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
}

// Lane 0 of the producer warp: tile t < nt is corpus rows first + t*step ..
// +31 (all below N) into stage t % stages with its 32 weights, `stages` tiles
// ahead of the slowest consumer warp.
template <typename T, int kD>
__device__ __forceinline__ void produce_tiles(const CUtensorMap* tm, const float* valid,
                                              uint32_t sX, float (*sval)[kRows], uint64_t* full,
                                              uint64_t* empty, int stages, int nt, int first,
                                              int step) {
  for (int t = 0; t < nt; ++t) {
    const int st = t % stages, n0 = first + t * step;
    if (t >= stages) mbar_wait(&empty[st], (t / stages - 1) & 1);
    mbar_expect_tx(&full[st], Tiles<T, kD>::kXBytes + 4 * kRows);
#pragma unroll
    for (int r = 0; r < Tiles<T, kD>::kRegions; ++r)
      tma_load_2d(sX + st * Tiles<T, kD>::kXBytes + r * kRegionX, tm, Tiles<T, kD>::kBoxCols * r, n0,
                  &full[st]);
    bulk_load(smem_u32(sval[st]), valid + n0, 4 * kRows, &full[st]);
  }
}

// acc = the warpgroup's 64 queries (q_desc) times the 32 rows of a tile
// (x_desc), over all kD features.
template <typename T, int kD>
__device__ __forceinline__ void tile_product(typename Elem<T>::Acc (&acc)[16], uint64_t q_desc,
                                             uint64_t x_desc) {
  wgmma_fence();
#pragma unroll
  for (int r = 0; r < Tiles<T, kD>::kRegions; ++r)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_n32(acc, desc_add(q_desc, r * kRegionQ + 32 * kk),
              desc_add(x_desc, r * kRegionX + 32 * kk), (r | kk) > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
}

// The tensor map of x [N, D] in boxes of 32 rows x 128 bytes, 128-byte
// swizzle (false if cuTensorMapEncodeTiled refuses it).
template <typename T>
inline bool corpus_map(CUtensorMap* map, const void* x, int N, int D) {
  return tensor_map_2d(map, x, N, D, kRows, 128 / Elem<T>::kBytes, CU_TENSOR_MAP_SWIZZLE_128B,
                       Elem<T>::kBytes);
}

struct SelectShared {
  unsigned long long tau;
  int n;
};

// The k largest of the block's keys, thread t holding key[0 .. P) (0 = none;
// live keys are distinct), written in descending order to out[0 .. n) with
// n = min(k, live keys), which every thread gets back. Rather than k rounds
// of a block-wide maximum: tau is the k-th largest of the threads' own
// maxima (at least k keys lie at or above it, so the k largest all do; with
// fewer than k live maxima every live key is kept), the keys >= tau are
// collected, and each is ranked by counting the collected keys above it.
// `kept` holds kThreads * P keys; `out` may hold keys passed in (they are
// copied first). A few block barriers whatever k is.
template <int kThreads, int P>
__device__ __forceinline__ int block_topk(const unsigned long long (&key)[P], int k,
                                          unsigned long long* thread_max,
                                          unsigned long long* kept, unsigned long long* out,
                                          SelectShared* sh) {
  const int tid = threadIdx.x;
  unsigned long long mine = 0ull;
#pragma unroll
  for (int i = 0; i < P; ++i) mine = key[i] > mine ? key[i] : mine;
  thread_max[tid] = mine;
  if (tid == 0) {
    sh->tau = 1ull;
    sh->n = 0;
  }
  __syncthreads();
  if (mine != 0ull) {
    int above = 0;
    for (int i = 0; i < kThreads; ++i) above += thread_max[i] > mine;
    if (above == k - 1) sh->tau = mine;
  }
  __syncthreads();
  const unsigned long long tau = sh->tau;
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (key[i] != 0ull && key[i] >= tau) kept[atomicAdd(&sh->n, 1)] = key[i];
  __syncthreads();
  const int n = sh->n;
  for (int e = tid; e < n; e += kThreads) {
    const unsigned long long me = kept[e];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += kept[j] > me;
    if (rank < k) out[rank] = me;
  }
  __syncthreads();
  return n < k ? n : k;
}

}  // namespace flat

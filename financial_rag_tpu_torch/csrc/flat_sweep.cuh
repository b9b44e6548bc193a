// The Hopper machinery of the flat sweeps K5 (bucketed_topk.cu) and K6
// (topk_exact.cu), bf16 and int8 corpora, a template over the width kD the
// features are zero-padded to: 384 (bge-small, gte-small), 768 (bge-base,
// gte-base) or 1,024 (bge-large, gte-large); K5 and K7 take all three, K6
// stays at 384.
//
// A block scores a tile of queries (64 a consumer warpgroup) against tiles
// of 32 consecutive corpus rows (16 for a bf16 row of 1,024 features: see
// Tiles). Its queries are loaded into shared memory once (cp.async,
// 128-byte swizzle, zeros past Bq and past D). A producer warp has the TMA
// copy each corpus tile (regions of kTileRows rows x 128 bytes, swizzled
// as the products read them, zeros past D) and its weights (a bulk copy)
// into a ring of stages, as soon as every consumer warp has released the
// stage through its empty mbarrier; the bytes complete the stage's full
// mbarrier (the ring of K4, packed_topk.cu). Each warpgroup then takes
// scores = Q X^T by wgmma m64n32 (m64n16 on 16-row tiles): k16 steps for
// bf16 with f32 accumulation, k32 steps for int8 with exact int32
// accumulation. Both operands are K-major, as [Bq, D] and [N, D] already
// lie (wgmma takes 8-bit operands in no other layout), so nothing is
// transposed. A thread's accumulator element i is (query row 16*(warp%4) +
// lane/4 + 8*((i>>1)&1), tile row 8*(i>>2) + 2*(lane%4) + (i&1)) in every
// tile, so what a sweep keeps per (query, column) can stay in registers
// across its tiles.
//
// block_topk is the selection both sweeps' merges share: the k largest of a
// block's 64-bit keys without k rounds of a block-wide maximum.
#pragma once

#include "hopper.cuh"
#include "sweep_common.cuh"

namespace flat {

using namespace hopper;

constexpr int kRows = 32;                 // corpus rows a tile (the wgmma N), but see Tiles
constexpr int kNarrowD = 384;             // features, zero-padded to this, to
constexpr int kWideD = 768;               // this one or to
constexpr int kLargeD = 1024;             // this one
constexpr int kRegionQ = 64 * 128;        // 64 query rows x 128 bytes
constexpr int kSmemBudget = 230400;       // dynamic shared memory a block may take (225 KB)

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

// The tile rows: 32, except where one warpgroup's queries leave room for
// fewer than 2 stages of 32 rows, a bf16 row of 1,024 features (queries
// 128 KB, a 32-row stage 64 KB): there 16 rows (wgmma n16), a 32 KB stage,
// and 3 of them beside the queries.
template <typename T, int kD>
struct Tiles {
  static_assert(kD == kNarrowD || kD == kWideD || kD == kLargeD,
                "the sweeps pad to 384, 768 or 1,024 features");
  static constexpr int kRowBytes = kD * Elem<T>::kBytes;     // 768 / 384 at 384 ... 2048 / 1024 at 1024
  static constexpr int kRegions = kRowBytes / 128;           // 128-byte column regions
  static constexpr int kChunks = kRowBytes / 16;             // 16-byte chunks of a row
  static constexpr int kQBytes = kRegions * kRegionQ;        // one warpgroup's queries
  static constexpr int kTileRows =
      (kSmemBudget - 1024 - kQBytes) / (kRegions * kRows * 128) >= 2 ? kRows : kRows / 2;
  static constexpr int kRegionX = kTileRows * 128;           // a tile's rows x 128 bytes
  static constexpr int kXBytes = kRegions * kRegionX;        // one corpus tile (a stage)
  static constexpr int kAcc = kTileRows / 2;                 // accumulator registers a thread
  static constexpr int kBoxCols = 128 / Elem<T>::kBytes;     // elements a TMA box row
};

__device__ __forceinline__ float acc_f32(float v) { return v; }
// |dot| <= 127 * 127 * 1024 = 16,516,096 < 2^24 = 16,777,216: exact in
// f32 at every padded width, as in the plain version
__device__ __forceinline__ float acc_f32(int v) { return __int2float_rn(v); }

// one k step of a tile's product, its N the accumulator's size (32 rows, or
// 16 for a bf16 row of 1,024 features; an int8 row of 1,024 keeps 32)
__device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_n32(d, a, b, acc);
}
__device__ __forceinline__ void mma(int (&d)[16], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_n32_s8(d, a, b, acc);
}
__device__ __forceinline__ void mma(float (&d)[8], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_n16(d, a, b, acc);
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
// + kTileRows - 1 (all below N) into stage t % stages with their weights,
// `stages` tiles ahead of the slowest consumer warp.
template <typename T, int kD>
__device__ __forceinline__ void produce_tiles(const CUtensorMap* tm, const float* valid,
                                              uint32_t sX, float (*sval)[Tiles<T, kD>::kTileRows],
                                              uint64_t* full, uint64_t* empty, int stages, int nt,
                                              int first, int step) {
  using Tl = Tiles<T, kD>;
  for (int t = 0; t < nt; ++t) {
    const int st = t % stages, n0 = first + t * step;
    if (t >= stages) mbar_wait(&empty[st], (t / stages - 1) & 1);
    mbar_expect_tx(&full[st], Tl::kXBytes + 4 * Tl::kTileRows);
#pragma unroll
    for (int r = 0; r < Tl::kRegions; ++r)
      tma_load_2d(sX + st * Tl::kXBytes + r * Tl::kRegionX, tm, Tl::kBoxCols * r, n0, &full[st]);
    bulk_load(smem_u32(sval[st]), valid + n0, 4 * Tl::kTileRows, &full[st]);
  }
}

// acc = the warpgroup's 64 queries (q_desc) times the rows of a tile
// (x_desc), over all kD features.
template <typename T, int kD>
__device__ __forceinline__ void tile_product(typename Elem<T>::Acc (&acc)[Tiles<T, kD>::kAcc],
                                             uint64_t q_desc, uint64_t x_desc) {
  using Tl = Tiles<T, kD>;
  wgmma_fence();
#pragma unroll
  for (int r = 0; r < Tl::kRegions; ++r)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma(acc, desc_add(q_desc, r * kRegionQ + 32 * kk),
          desc_add(x_desc, r * Tl::kRegionX + 32 * kk), (r | kk) > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
}

// The tensor map of x [N, D] in boxes of kTileRows rows x 128 bytes,
// 128-byte swizzle (false if cuTensorMapEncodeTiled refuses it).
template <typename T, int kD>
inline bool corpus_map(CUtensorMap* map, const void* x, int N, int D) {
  return tensor_map_2d(map, x, N, D, Tiles<T, kD>::kTileRows, 128 / Elem<T>::kBytes,
                       CU_TENSOR_MAP_SWIZZLE_128B, Elem<T>::kBytes);
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

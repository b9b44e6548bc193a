// K4: the serving sweep, packed score+tile bucketed top-k over a float corpus.
//
// Replaces financial_rag_tpu/ops/topk.py:packed_topk_fused (the Pallas kernel
// _packed_kernel) and keeps its result contract, not a plain exact top-k:
//   block_n = min(1024, N), ntiles = N / block_n, bits = max(ceil(log2
//   ntiles), 1), maxj = ntiles - 1;
//   p = s*live + (live ? 2 : -2) with s = q . x in f32;
//   packed = (bits(p) & ~mask) | (maxj - j) for corpus row j*block_n + t;
//   column t of every tile competes in bucket t, which keeps its best and
//   runner-up (running top-2 from a 0 init, compared as int32);
//   the final exact top-k runs over [best | runner-up] (2*block_n candidates
//   per query) with ties to the earlier position, and decodes
//   slot = (maxj - (packed & mask))*block_n + t, score = f32(packed & ~mask) - 2,
//   -1 / NEG where the bucket is dead (packed <= 0).
//
// Bound on the H100: device-memory bytes. The corpus (N*D*2 bytes in bf16)
// is streamed once per query tile; 2*Bq*N*D flops at Bq = 128 are ~1/2 of the
// byte time at the bf16 tensor-core rate.
//
// Design: the TPU runs the corpus tiles j in order and carries the buckets in
// scratch. Hopper blocks run in no order, so a block owns a 64-query tile, 16
// bucket columns t and one group of consecutive tiles j, and loops over its
// tiles itself: each warp takes 16 queries x 16 columns, computes the scores
// with one bf16 mma chain (WMMA 16x16x16, f32 accumulate; f32 corpora take a
// CUDA-core dot), stages them in shared memory, and each lane keeps the
// running top-2 of 8 (query, bucket) pairs in registers. The tile groups
// exist to put enough blocks in flight (a query tile has only block_n/16
// column blocks); the top-2 of a bucket over all tiles is the top-2 of the
// groups' top-2s, whatever their order, so splitting changes no result.
// A second kernel (one block per query) folds the groups' pairs, then
// extracts the exact top-k of the 2*block_n candidates, k steps of a
// block-wide max over 64-bit keys (orderable score, inverted position) so
// equal scores go to the earlier position, as _merge_topk does.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr float kNeg = -3.0e4f;  // ops/topk.py NEG
constexpr int kSweepWarps = 4;   // 4 x 16 = 64 queries per block
constexpr int kCols = 16;        // bucket columns per block
constexpr int kMergeThreads = 256;
constexpr int kMergePerThread = 8;  // 256 * 8 >= 2 * 1024 candidates
constexpr int kMaxK = 256;

// 16x16 tile of scores q[16 rows] . x[16 rows] into sc (row-major, ld 16).
__device__ __forceinline__ void tile_scores(const __nv_bfloat16* q, const __nv_bfloat16* x,
                                            int D, float* sc, int /*lane*/) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
  wmma::fill_fragment(c, 0.f);
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
    wmma::load_matrix_sync(a, q + kk, D);
    wmma::load_matrix_sync(b, x + kk, D);  // element (k, n) = x[n*D + k]
    wmma::mma_sync(c, a, b, c);
  }
  wmma::store_matrix_sync(sc, c, 16, wmma::mem_row_major);
}

__device__ __forceinline__ void tile_scores(const float* q, const float* x, int D, float* sc,
                                            int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = lane + 32 * i, r = e >> 4, col = e & 15;
    const float* qr = q + (size_t)r * D;
    const float* xr = x + (size_t)col * D;
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot += qr[d] * xr[d];
    sc[e] = dot;
  }
}

template <typename T>
__global__ void __launch_bounds__(kSweepWarps * 32)
packed_sweep_kernel(const T* __restrict__ q, const T* __restrict__ x,
                    const float* __restrict__ valid, int* __restrict__ b1_out,
                    int* __restrict__ b2_out, int D, int block_n, int ntiles, int bits,
                    int tiles_per_group) {
  __shared__ __align__(128) float sc_all[kSweepWarps][16 * 16];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * (kSweepWarps * 16) + warp * 16;
  const int t0 = blockIdx.x * kCols;
  const int mask = (1 << bits) - 1, maxj = ntiles - 1;
  float* sc = sc_all[warp];
  const T* qw = q + (size_t)q0 * D;

  int b1[8], b2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) b1[i] = b2[i] = 0;

  const int j_end = min(ntiles, (int)(blockIdx.z + 1) * tiles_per_group);
  for (int j = blockIdx.z * tiles_per_group; j < j_end; ++j) {
    const size_t n0 = (size_t)j * block_n + t0;
    tile_scores(qw, x + n0 * D, D, sc, lane);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = lane + 32 * i, col = e & 15;
      const bool live = valid[n0 + col] > 0.f;
      const float p = live ? sc[e] + 2.f : -2.f;
      const int pb = (__float_as_int(p) & ~mask) | (maxj - j);
      const int old = b1[i];
      b1[i] = max(old, pb);
      b2[i] = max(b2[i], min(old, pb));
    }
    __syncwarp();  // sc is rewritten by the next tile
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = lane + 32 * i, r = e >> 4, col = e & 15;
    const size_t at = ((size_t)blockIdx.z * gridDim.y * (kSweepWarps * 16) + q0 + r) * block_n + t0 + col;
    b1_out[at] = b1[i];
    b2_out[at] = b2[i];
  }
}

__device__ __forceinline__ unsigned long long merge_key(float v, int pos) {
  unsigned int u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // order-preserving
  return ((unsigned long long)u << 32) | (unsigned int)(0xFFFFFFFFu - (unsigned int)pos);
}

__global__ void __launch_bounds__(kMergeThreads)
packed_merge_kernel(const int* __restrict__ b1, const int* __restrict__ b2,
                    float* __restrict__ out_s, int* __restrict__ out_i, int Bqp, int block_n,
                    int ntiles, int bits, int k, int groups) {
  __shared__ unsigned long long warp_best[2][kMergeThreads / 32];
  __shared__ float sel_p[kMaxK];
  __shared__ int sel_i[kMaxK];
  const int row = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int mask = (1 << bits) - 1, maxj = ntiles - 1;
  const int ncand = 2 * block_n;

  float val[kMergePerThread];
  int idx[kMergePerThread];
#pragma unroll
  for (int i = 0; i < kMergePerThread; ++i) {
    const int pos = tid + kMergeThreads * i;
    val[i] = -INFINITY;  // no such candidate: below every real one
    idx[i] = -1;
    if (pos < ncand) {
      const int t = pos < block_n ? pos : pos - block_n;
      int p1 = 0, p2 = 0;  // the bucket's top-2 over every tile group
      for (int g = 0; g < groups; ++g) {
        const size_t at = ((size_t)g * Bqp + row) * block_n + t;
        const int a1 = b1[at], a2 = b2[at];
        p2 = max(max(p2, a2), min(p1, a1));
        p1 = max(p1, a1);
      }
      const int packed = pos < block_n ? p1 : p2;
      const bool live = packed > 0;
      val[i] = live ? __int_as_float(packed) : kNeg;
      idx[i] = live ? (maxj - (packed & mask)) * block_n + t : -1;
    }
  }

  for (int step = 0; step < k; ++step) {
    unsigned long long best = 0ull;
#pragma unroll
    for (int i = 0; i < kMergePerThread; ++i) {
      const int pos = tid + kMergeThreads * i;
      if (pos < ncand) {
        const unsigned long long key = merge_key(val[i], pos);
        best = key > best ? key : best;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, best, off);
      best = other > best ? other : best;
    }
    unsigned long long* wb = warp_best[step & 1];
    if (lane == 0) wb[warp] = best;
    __syncthreads();
    best = 0ull;
#pragma unroll
    for (int w = 0; w < kMergeThreads / 32; ++w) best = wb[w] > best ? wb[w] : best;
    const int pos = (int)(0xFFFFFFFFu - (unsigned int)(best & 0xFFFFFFFFull));
    if (pos % kMergeThreads == tid) {
      const int i = pos / kMergeThreads;
#pragma unroll
      for (int ii = 0; ii < kMergePerThread; ++ii) {
        if (ii == i) {
          sel_p[step] = val[ii];
          sel_i[step] = idx[ii];
          val[ii] = kNeg;  // extracted, as _merge_topk does
        }
      }
    }
  }
  __syncthreads();
  for (int s = tid; s < k; s += kMergeThreads) {
    const float p = sel_p[s];
    const bool empty = p <= kNeg;
    const float score = __int_as_float(__float_as_int(p) & ~mask) - 2.f;
    out_s[(size_t)row * k + s] = empty ? kNeg : score;
    out_i[(size_t)row * k + s] = empty ? -1 : sel_i[s];
  }
}

}  // namespace

// q [Bqp,D] (Bqp % 64 == 0, rows >= Bq zero), x [N,D] in the same dtype, valid
// [N] f32, scratch b1/b2 [groups,Bqp,block_n] int32 (group g sweeps tiles
// g*tiles_per_group ..), outputs out_s [Bq,k] f32 and out_i [Bq,k] int32.
// N % block_n == 0, block_n % 16 == 0, block_n <= 1024, D % 16 == 0, k <= 256.
FRAG_EXPORT int frag_packed_topk(const void* q, const void* x, const float* valid, int* b1,
                                 int* b2, float* out_s, int* out_i, int Bq, int Bqp, int N,
                                 int D, int block_n, int bits, int k, int tiles_per_group,
                                 int dtype, void* stream) {
  if (Bqp % (kSweepWarps * 16) || block_n % kCols || block_n > 1024 || N % block_n ||
      D % 16 || k > kMaxK || k < 1 || tiles_per_group < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = N / block_n;
  const int groups = (ntiles + tiles_per_group - 1) / tiles_per_group;
  const dim3 grid(block_n / kCols, Bqp / (kSweepWarps * 16), groups);
  if (dtype == FRAG_BF16) {
    packed_sweep_kernel<__nv_bfloat16><<<grid, kSweepWarps * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(x), valid,
        b1, b2, D, block_n, ntiles, bits, tiles_per_group);
  } else {
    packed_sweep_kernel<float><<<grid, kSweepWarps * 32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(x), valid, b1, b2, D,
        block_n, ntiles, bits, tiles_per_group);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  packed_merge_kernel<<<Bq, kMergeThreads, 0, st>>>(b1, b2, out_s, out_i, Bqp, block_n,
                                                    ntiles, bits, k, groups);
  return (int)cudaGetLastError();
}

// K5 + K7: the bucketed flat sweep, with the final top-k fused (K5) or with
// the bucket maxima written out (K7).
//
// Replaces financial_rag_tpu/ops/topk.py:bucketed_topk_fused (Pallas kernel
// _bucketed_fused_kernel, the int8 index's sweep) and topk.py:bucketed_topk
// (kernel _bucketed_kernel, backend "pallas_bucketed"). Both compute the
// same bucket maxima:
//   s = q . x (int8 x int8 -> int32 exact, or bf16/f32 -> f32), then
//   s * w + (live - 1) * 1e5 with w the row's weight (1.0, or max|v|/127
//   for int8; 0 = empty slot);
//   corpus column c competes in bucket c mod nbuckets; a bucket keeps the
//   best score, and on equal scores the lower column (strict > over columns
//   in order); a bucket nothing live reached holds (NEG, -1).
// K5 then extracts k from the nbuckets maxima as _merge_topk does: k steps
// of "largest, ties to the lower bucket position", the taken one set to NEG
// (its index kept), so once the live buckets are spent every further step
// takes position 0 again. K7 writes [Bq, nbuckets] scores and indices; the
// wrapper's stable top-k replaces lax.top_k. The per-query int8 scale is
// applied by the wrapper, as in JAX.
//
// Bound on the H100: device-memory bytes. The corpus (N*D bytes in int8,
// twice that in bf16) is read once per 64-query tile; at Bq = 128 the dot
// products (2*Bq*N*D) are a fraction of the byte time at the tensor-core
// rates.
//
// Design: the TPU walks the corpus tiles in order and keeps the buckets in
// scratch. Hopper blocks run in no order, so the bucket max is kept as a
// 64-bit key (orderable score, inverted column): its maximum is associative,
// and equal scores resolve to the lower column whatever the order of the
// blocks. A block owns 64 queries (4 warps x 16), 16 bucket positions and a
// group of consecutive rounds (round r covers columns r*nbuckets ..); each
// warp scores 16 queries x 16 columns per round (bf16: WMMA; int8: mma.sync
// m16n8k32; f32: CUDA cores) and each lane keeps the running max key of 8
// (query, bucket) pairs in registers. The round groups exist to put enough
// blocks in flight. A second kernel folds the groups' keys and either
// extracts k (one block per query, 512 threads x 8 positions) or writes the
// buckets out.
#include "sweep_common.cuh"

namespace {

constexpr int kWarps = 4;  // 4 x 16 = 64 queries per block
constexpr int kCols = 16;  // bucket positions per block
constexpr int kExtractThreads = 512;
constexpr int kExtractPer = 8;  // 512 * 8 = 4096 bucket positions
constexpr int kMaxK = 256;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
bucketed_sweep_kernel(const T* __restrict__ q, const T* __restrict__ x,
                      const float* __restrict__ valid, unsigned long long* __restrict__ keys,
                      int N, int D, int nbuckets, int rounds_per_group) {
  __shared__ __align__(128) float sc_all[kWarps][16 * 16];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * (kWarps * 16) + warp * 16;
  const int b0 = blockIdx.x * kCols;
  float* sc = sc_all[warp];
  const T* qw = q + (size_t)q0 * D;

  unsigned long long best[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) best[i] = 0ull;

  const int r0 = blockIdx.z * rounds_per_group;
  for (int r = r0; r < r0 + rounds_per_group; ++r) {
    const int c0 = r * nbuckets + b0;  // N % 16 == 0: a 16-column block is whole or absent
    if (c0 >= N) break;
    tile16_scores(qw, x + (size_t)c0 * D, D, sc, 16, lane);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = lane + 32 * i, col = c0 + (e & 15);
      const float s = weighted_score(sc[e], valid[col]);
      if (s > kSweepNeg) {
        const unsigned long long key = sweep_key(s, col);
        best[i] = key > best[i] ? key : best[i];
      }
    }
    __syncwarp();  // sc is rewritten by the next round
  }
  const size_t bqp = (size_t)gridDim.y * (kWarps * 16);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = lane + 32 * i;
    keys[(blockIdx.z * bqp + q0 + (e >> 4)) * nbuckets + b0 + (e & 15)] = best[i];
  }
}

__device__ __forceinline__ unsigned long long fold_groups(const unsigned long long* keys,
                                                          size_t stride, int groups) {
  unsigned long long k = 0ull;
  for (int g = 0; g < groups; ++g) k = keys[g * stride] > k ? keys[g * stride] : k;
  return k;
}

// one block per query: the exact top-k of the nbuckets maxima, _merge_topk's way
__global__ void __launch_bounds__(kExtractThreads)
bucketed_extract_kernel(const unsigned long long* __restrict__ keys, float* __restrict__ out_s,
                        int* __restrict__ out_i, int Bqp, int nbuckets, int groups, int k) {
  __shared__ unsigned long long warp_best[2][kExtractThreads / 32];
  __shared__ float sel_s[kMaxK];
  __shared__ int sel_i[kMaxK];
  const int row = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t stride = (size_t)Bqp * nbuckets;

  float val[kExtractPer];
  int idx[kExtractPer];
#pragma unroll
  for (int i = 0; i < kExtractPer; ++i) {
    const int pos = tid + kExtractThreads * i;
    val[i] = kSweepNeg;
    idx[i] = -1;
    if (pos < nbuckets) {
      const unsigned long long key = fold_groups(keys + (size_t)row * nbuckets + pos, stride, groups);
      if (key) {
        val[i] = key_score(key);
        idx[i] = key_index(key);
      }
    }
  }

  for (int step = 0; step < k; ++step) {
    unsigned long long best = 0ull;
#pragma unroll
    for (int i = 0; i < kExtractPer; ++i) {
      const int pos = tid + kExtractThreads * i;
      if (pos < nbuckets) {
        const unsigned long long key = sweep_key(val[i], pos);
        best = key > best ? key : best;
      }
    }
    best = warp_max_u64(best);
    unsigned long long* wb = warp_best[step & 1];
    if (lane == 0) wb[warp] = best;
    __syncthreads();
    best = 0ull;
#pragma unroll
    for (int w = 0; w < kExtractThreads / 32; ++w) best = wb[w] > best ? wb[w] : best;
    const int pos = key_index(best);
    if (pos % kExtractThreads == tid) {
      const int i = pos / kExtractThreads;
#pragma unroll
      for (int ii = 0; ii < kExtractPer; ++ii) {
        if (ii == i) {
          sel_s[step] = val[ii];
          sel_i[step] = idx[ii];
          val[ii] = kSweepNeg;  // taken, as _merge_topk does; its index stays
        }
      }
    }
  }
  __syncthreads();
  for (int s = tid; s < k; s += kExtractThreads) {
    out_s[(size_t)row * k + s] = sel_s[s];
    out_i[(size_t)row * k + s] = sel_i[s];
  }
}

// the bucket maxima themselves, [Bq, nbuckets]
__global__ void bucketed_write_kernel(const unsigned long long* __restrict__ keys,
                                      float* __restrict__ out_s, int* __restrict__ out_i, int Bqp,
                                      int nbuckets, int groups) {
  const int pos = blockIdx.x * blockDim.x + threadIdx.x, row = blockIdx.y;
  if (pos >= nbuckets) return;
  const unsigned long long key = fold_groups(keys + (size_t)row * nbuckets + pos,
                                             (size_t)Bqp * nbuckets, groups);
  out_s[(size_t)row * nbuckets + pos] = key ? key_score(key) : kSweepNeg;
  out_i[(size_t)row * nbuckets + pos] = key ? key_index(key) : -1;
}

template <typename T>
void launch_sweep(const void* q, const void* x, const float* valid, unsigned long long* keys,
                  dim3 grid, int N, int D, int nbuckets, int rounds_per_group, cudaStream_t st) {
  bucketed_sweep_kernel<T><<<grid, kWarps * 32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(x), valid, keys, N, D, nbuckets,
      rounds_per_group);
}

}  // namespace

// q [Bqp,D] (Bqp % 64 == 0, rows >= Bq zero), x [N,D] in the same dtype
// (f32 / bf16 / int8), valid [N] f32 weights, scratch keys
// [groups,Bqp,nbuckets] u64 (group g sweeps rounds g*rounds_per_group ..).
// k > 0 (K5): out_s / out_i [Bq,k]; k == 0 (K7): out_s / out_i [Bq,nbuckets].
// N % 16 == 0, nbuckets % 16 == 0, D % 16 == 0 (D % 32 for int8); K5 needs
// nbuckets <= 4096 and k <= min(256, nbuckets).
FRAG_EXPORT int frag_bucketed_topk(const void* q, const void* x, const float* valid,
                                   unsigned long long* keys, float* out_s, int* out_i, int Bq,
                                   int Bqp, int N, int D, int nbuckets, int k,
                                   int rounds_per_group, int dtype, void* stream) {
  if (Bqp % (kWarps * 16) || Bq > Bqp || N % 16 || nbuckets % kCols || nbuckets < kCols ||
      D % 16 || (dtype == FRAG_I8 && D % 32) || rounds_per_group < 1 || k < 0 ||
      (k > 0 && (k > kMaxK || k > nbuckets || nbuckets > kExtractThreads * kExtractPer)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rounds = (N + nbuckets - 1) / nbuckets;
  const int groups = (rounds + rounds_per_group - 1) / rounds_per_group;
  const dim3 grid(nbuckets / kCols, Bqp / (kWarps * 16), groups);
  if (dtype == FRAG_BF16) {
    launch_sweep<__nv_bfloat16>(q, x, valid, keys, grid, N, D, nbuckets, rounds_per_group, st);
  } else if (dtype == FRAG_I8) {
    launch_sweep<int8_t>(q, x, valid, keys, grid, N, D, nbuckets, rounds_per_group, st);
  } else {
    launch_sweep<float>(q, x, valid, keys, grid, N, D, nbuckets, rounds_per_group, st);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (k > 0) {
    bucketed_extract_kernel<<<Bq, kExtractThreads, 0, st>>>(keys, out_s, out_i, Bqp, nbuckets,
                                                            groups, k);
  } else {
    bucketed_write_kernel<<<dim3((nbuckets + 255) / 256, Bq), 256, 0, st>>>(keys, out_s, out_i,
                                                                           Bqp, nbuckets, groups);
  }
  return (int)cudaGetLastError();
}

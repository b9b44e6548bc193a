// K6: the exact flat sweep, a running top-k per query.
//
// Replaces financial_rag_tpu/ops/topk.py:topk_matmul (Pallas kernel
// _topk_kernel, backend "pallas_exact"). What it computes:
//   s = q . x (int8 x int8 -> int32 exact, or bf16/f32 -> f32), then
//   s * w + (live - 1) * 1e5 (ops/topk.py:_weighted_mask);
//   the exact top-k of the live scores (> NEG), ties to the lower corpus
//   index: the TPU re-extracts k from [running k | 1024-row tile] on every
//   tile, and on equal scores the running entries (lower indices) and then
//   the earlier columns win.
//   When fewer than k rows are live, the TPU's extraction leaves each empty
//   slot at (NEG, i) where i is the running list's first entry before the
//   last tile: the best live row outside the last 1024-row tile, or -1. The
//   merge reproduces that, so results match the TPU kernel bit for bit.
// The per-query int8 scale is applied by the wrapper, as in JAX.
//
// Bound on the H100: device-memory bytes (the corpus read once per
// 64-query tile); the dot products at Bq = 128 are below the byte time at the
// tensor-core rates, and the selection work is data-dependent but small.
//
// Design: the TPU's grid walks the tiles in order and carries the running
// top-k in the output block. Hopper blocks run in no order, so a block owns
// (64 queries = 4 warps x 16, a group of consecutive 128-column chunks, as
// many groups as fill the card and the merge) and each warp
// keeps, in shared memory, a sorted list of the k best 64-bit keys
// (orderable score, inverted index) of each of its 16 queries. Per step a
// warp scores 16 queries x 128 columns (bf16: WMMA; int8: mma.sync m16n8k32;
// f32: CUDA cores) into shared memory, then for each query compares the 128
// keys with the list's k-th key; a ballot collects the few that beat it and
// the warp inserts them one by one (after a group's first chunks few do).
// Keys are unique, so the groups' lists merge exactly: a second kernel (one
// block per query) extracts the k largest of groups x k keys.
#include "sweep_common.cuh"

namespace {

constexpr int kWarps = 4;    // 4 x 16 = 64 queries per block (block_q)
constexpr int kChunk = 128;  // corpus columns scored per step
constexpr int kMaxK = 128;
constexpr int kMergeThreads = 256;
constexpr int kMergePer = 16;  // 256 * 16 = 4096 candidates (groups * k)

// Insert key into the descending list[0..k) (key > list[k-1], keys unique).
__device__ __forceinline__ void list_insert(unsigned long long* list, int k, unsigned long long key,
                                            int lane) {
  int above = 0;
  for (int e = lane; e < k; e += 32) above += list[e] > key;
  const int pos = __reduce_add_sync(0xffffffffu, above);
  unsigned long long moved[kMaxK / 32];
#pragma unroll
  for (int j = 0; j < kMaxK / 32; ++j) {
    const int e = lane + 32 * j;
    moved[j] = (e >= pos && e < k - 1) ? list[e] : 0ull;
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kMaxK / 32; ++j) {
    const int e = lane + 32 * j;
    if (e >= pos && e < k - 1) list[e + 1] = moved[j];
  }
  if (lane == 0) list[pos] = key;
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
exact_sweep_kernel(const T* __restrict__ q, const T* __restrict__ x,
                   const float* __restrict__ valid, unsigned long long* __restrict__ lists_out,
                   int N, int D, int k, int kcap, int cols_per_group) {
  extern __shared__ __align__(128) unsigned char smem[];  // WMMA stores need 32-byte alignment
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sc = reinterpret_cast<float*>(smem) + warp * 16 * kChunk;
  unsigned long long* lists =
      reinterpret_cast<unsigned long long*>(smem + kWarps * 16 * kChunk * sizeof(float)) +
      (size_t)warp * 16 * kcap;
  const int q0 = blockIdx.x * (kWarps * 16) + warp * 16;
  const T* qw = q + (size_t)q0 * D;
  for (int e = lane; e < 16 * kcap; e += 32) lists[e] = 0ull;
  __syncwarp();

  const int c_begin = blockIdx.y * cols_per_group;
  const int c_end = min(N, c_begin + cols_per_group);
  for (int c0 = c_begin; c0 < c_end; c0 += kChunk) {
#pragma unroll 1
    for (int t = 0; t < kChunk / 16; ++t)
      tile16_scores(qw, x + (size_t)(c0 + 16 * t) * D, D, sc + 16 * t, kChunk, lane);
    __syncwarp();
    float w[kChunk / 32];
#pragma unroll
    for (int part = 0; part < kChunk / 32; ++part) w[part] = valid[c0 + 32 * part + lane];
#pragma unroll 1
    for (int r = 0; r < 16; ++r) {
      unsigned long long* list = lists + r * kcap;
      unsigned long long thr = list[k - 1];
#pragma unroll
      for (int part = 0; part < kChunk / 32; ++part) {
        const int col = c0 + 32 * part + lane;
        const float s = weighted_score(sc[r * kChunk + 32 * part + lane], w[part]);
        const unsigned long long key = s > kSweepNeg ? sweep_key(s, col) : 0ull;
        unsigned int m = __ballot_sync(0xffffffffu, key > thr);
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const unsigned long long kk = __shfl_sync(0xffffffffu, key, src);
          if (kk > thr) {
            list_insert(list, k, kk, lane);
            thr = list[k - 1];
          }
        }
      }
    }
    __syncwarp();  // sc is rewritten by the next step
  }
  const size_t bqp = (size_t)gridDim.x * (kWarps * 16);
  for (int e = lane; e < 16 * k; e += 32) {
    const int r = e / k, j = e % k;
    lists_out[(blockIdx.y * bqp + q0 + r) * kcap + j] = lists[r * kcap + j];
  }
}

// one block per query: the k largest of the groups' lists, and the TPU's
// fill for the slots no live row reached
__global__ void __launch_bounds__(kMergeThreads)
exact_merge_kernel(const unsigned long long* __restrict__ lists, float* __restrict__ out_s,
                   int* __restrict__ out_i, int Bqp, int k, int kcap, int groups,
                   int last_tile_start) {
  __shared__ unsigned long long warp_best[2][kMergeThreads / 32];
  __shared__ unsigned long long sel[kMaxK];
  __shared__ int nsel_s, fill_s;
  const int row = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ncand = groups * k;

  unsigned long long cand[kMergePer];
#pragma unroll
  for (int i = 0; i < kMergePer; ++i) {
    const int p = tid + kMergeThreads * i;
    cand[i] = p < ncand ? lists[((size_t)(p / k) * Bqp + row) * kcap + p % k] : 0ull;
  }
  int nsel = 0;
  for (int step = 0; step < k; ++step) {
    unsigned long long best = 0ull;
#pragma unroll
    for (int i = 0; i < kMergePer; ++i) best = cand[i] > best ? cand[i] : best;
    best = warp_max_u64(best);
    unsigned long long* wb = warp_best[step & 1];
    if (lane == 0) wb[warp] = best;
    __syncthreads();
    best = 0ull;
#pragma unroll
    for (int w = 0; w < kMergeThreads / 32; ++w) best = wb[w] > best ? wb[w] : best;
    if (best == 0ull) break;  // uniform: every thread read the same maxima
#pragma unroll
    for (int i = 0; i < kMergePer; ++i)
      if (cand[i] == best) cand[i] = 0ull;  // keys are unique
    if (tid == 0) sel[step] = best;
    nsel = step + 1;
  }
  if (tid == 0) {
    int fill = -1;
    for (int s = 0; s < nsel; ++s) {
      if (key_index(sel[s]) < last_tile_start) {
        fill = key_index(sel[s]);
        break;
      }
    }
    nsel_s = nsel;
    fill_s = fill;
  }
  __syncthreads();
  for (int s = tid; s < k; s += kMergeThreads) {
    const bool live = s < nsel_s;
    out_s[(size_t)row * k + s] = live ? key_score(sel[s]) : kSweepNeg;
    out_i[(size_t)row * k + s] = live ? key_index(sel[s]) : fill_s;
  }
}

template <typename T>
int launch_sweep(const void* q, const void* x, const float* valid, unsigned long long* lists,
                 dim3 grid, int N, int D, int k, int kcap, int cols_per_group, cudaStream_t st) {
  const size_t smem = (size_t)kWarps * 16 * (kChunk * sizeof(float) + kcap * sizeof(unsigned long long));
  cudaError_t err = cudaFuncSetAttribute(exact_sweep_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  exact_sweep_kernel<T><<<grid, kWarps * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(x), valid, lists, N, D, k, kcap,
      cols_per_group);
  return (int)cudaGetLastError();
}

}  // namespace

// q [Bqp,D] (Bqp % 64 == 0, rows >= Bq zero), x [N,D] in the same dtype
// (f32 / bf16 / int8), valid [N] f32 weights, scratch lists
// [groups,Bqp,kcap] u64 (group g sweeps columns g*cols_per_group ..),
// outputs out_s / out_i [Bq,k]. last_tile_start = N - block_n. N % 128 == 0,
// cols_per_group % 128 == 0, D % 16 == 0 (D % 32 for int8), 1 <= k <= 128,
// kcap = k rounded up to 32, groups * k <= 4096.
FRAG_EXPORT int frag_topk_exact(const void* q, const void* x, const float* valid,
                                unsigned long long* lists, float* out_s, int* out_i, int Bq,
                                int Bqp, int N, int D, int k, int kcap, int cols_per_group,
                                int last_tile_start, int dtype, void* stream) {
  if (Bqp % (kWarps * 16) || Bq > Bqp || N % kChunk || cols_per_group % kChunk ||
      cols_per_group < kChunk || D % 16 || (dtype == FRAG_I8 && D % 32) || k < 1 ||
      k > kMaxK || kcap % 32 || kcap < k || kcap > kMaxK)
    return (int)cudaErrorInvalidValue;
  const int groups = (N + cols_per_group - 1) / cols_per_group;
  if (groups * k > kMergeThreads * kMergePer) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(Bqp / (kWarps * 16), groups);
  int rc;
  if (dtype == FRAG_BF16) {
    rc = launch_sweep<__nv_bfloat16>(q, x, valid, lists, grid, N, D, k, kcap, cols_per_group, st);
  } else if (dtype == FRAG_I8) {
    rc = launch_sweep<int8_t>(q, x, valid, lists, grid, N, D, k, kcap, cols_per_group, st);
  } else {
    rc = launch_sweep<float>(q, x, valid, lists, grid, N, D, k, kcap, cols_per_group, st);
  }
  if (rc != 0) return rc;
  exact_merge_kernel<<<Bq, kMergeThreads, 0, st>>>(lists, out_s, out_i, Bqp, k, kcap, groups,
                                                   last_tile_start);
  return (int)cudaGetLastError();
}

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
// Bound on the H100: device-memory bytes (the corpus read once); the dot
// products at Bq = 128 take about half the byte time at the tensor-core
// rates, and the selection work depends on the data.
//
// Design. The TPU's grid walks the tiles in order and carries the running
// top-k in the output block. Hopper blocks run in no order, so a block owns
// a query tile and a group of consecutive corpus tiles, keeps the exact
// top-k of its group for each query, and a second kernel merges the groups'
// lists: 64-bit keys (orderable score above the inverted index) are unique,
// so the lists of any split merge exactly.
//
// The sweep over an int8 or bf16 corpus (sm_90a, flat_sweep.cuh). It
// replaces one (43x its bound at Bq = 128, N = 102,400) that scored 16 x 16
// WMMA tiles from device memory into shared memory and then, query by
// query, took ballots against the k-th key and inserted each passing key by
// shifting a sorted shared list. A block is now one consumer warpgroup of 64
// queries and a producer warp; its queries are staged once and its tiles of
// 32 rows stream through the TMA ring (scores by wgmma m64n32k16 in bf16,
// m64n32k32 s32 in int8, in registers). A thread's accumulator holds two
// query rows of 8 columns each. Each row has a list of its k best keys so
// far, a candidate buffer and a threshold: the score of the list's k-th
// key, or NEG while the list is short. The thread compares its elements'
// weighted scores with its rows' thresholds and appends the few that beat
// them to the row's buffer through a shared atomic counter. Strictly
// greater suffices: every key kept so far has a lower corpus index than
// this tile's, so an equal score loses. The rows of a warp are that warp's
// alone, so the warp flushes them itself, with no block barrier, before a
// tile could overflow a buffer. After the group's last tile it flushes
// nothing: each row's [list | buffer] goes out as it is, with its length,
// and the merge selects. A row's list and buffer share 224 keys in bf16,
// 256 in int8 (buffer 192 / 224 at k <= 32, 96 / 128 at k = 128), so at k
// = 24 a row flushes after its first 6-7 tiles and then a few times. A
// flush takes the top k of [list | buffer]: for k <= 32 and more than 2k
// candidates, the k-th largest of the lanes' own two largest first prunes
// them to those at or above it (at least k are), then each kept key is
// ranked by the kept keys above it (warp shuffles, or shared-memory
// broadcasts past 64 kept keys), which writes the list sorted and gives
// the new threshold. The worst case is a corpus whose every tile beats the
// one before: every key passes, and a row flushes every 6-7 tiles at k =
// 24, every 3-4 at k = 128.
//
// What bounds it on the H100 is the flush, not the bytes: a row's flush is
// a chain of dependent warp steps, a warp flushes its 16 rows in turn, and
// wgmma is a warpgroup's collective, so every warp's next products wait
// for the slowest warp's flushes (0.150 ms at Bq = 128, N = 102,400, 6.3x
// the bound; the sweep 0.130, the merge 0.020). Tried on the card and
// dropped, device time at that shape: a 64-key buffer (a flush every two
// tiles) with the lanes' maxima as the pivot and ranks in shared memory,
// 0.239 ms; a 160-key buffer with a flush after the last tile, 0.157 (the
// merge then took 5 us, not 21); the pivot and the kept keys sorted by
// warp bitonic networks (fewer shuffles, more registers: 0.217);
// shared-memory broadcasts for the pivot and the ranks up to 64 keys;
// appends placed by a quad prefix count instead of an atomic (no change);
// the flush out of line (slower); rows in the merge assigned a rank per
// thread (the groups' sorted lists made each thread hold the same rank of
// 16 groups, and at k = 128 the threshold kept thousands: 0.098 against
// 0.016 ms).
//
// Shared memory a block (bf16 / int8, D <= 384): queries 48 / 24 KB; the
// rows' lists and buffers and a flush scratch a warp, 68 x 224 / 256 x 8
// bytes = 119 / 136 KB; and as many 24 / 12 KB ring stages as fit in 224
// KB: 2 in bf16, 5 in int8. A query tile of 128 (two warpgroups) would
// need twice the lists and queries and leave a bf16 ring no room, so at
// Bq = 128 two blocks read each tile, the second mostly from L2
// (blockIdx.x is the query tile, so the two run side by side). The
// wrapper's grid (exact_sweep_grid) fills the SMs once.
//
// The merge (one block of 256 threads per query) takes the top k of the
// groups' entries in chunks of 4,096: each chunk's keys and the running
// top k go through flat::block_topk (a threshold and a rank count, not k
// block-wide rounds), so neither the grid nor k = 128 is capped by it.
// Entries go to threads rank-major (entry j of group g is candidate j *
// groups + g), so a thread holds entries of several ranks of the sorted
// lists; once k are kept, a key at or below the k-th drops, and a chunk
// left empty is skipped. The groups' lengths are staged in shared memory
// (up to kMaxMergeGroups groups). Then it fills the slots past the live
// rows as the TPU does.
//
// f32 corpora keep the CUDA-core sweep below (exact_sweep_kernel: 4 warps x
// 16 queries a block, 128-column steps scored into shared memory, a sorted
// list per query grown by insertion).
#include "flat_sweep.cuh"

namespace {

constexpr int kWarps = 4;    // 4 x 16 = 64 queries per block (block_q)
constexpr int kChunk = 128;  // corpus columns scored per step (f32 sweep)
constexpr int kMaxK = 128;
constexpr int kMergeThreads = 256;
constexpr int kMergePer = 16;  // 256 * 16 = 4096 candidates a chunk of the merge
constexpr int kMaxStages = 8;
constexpr int kMaxMergeGroups = 1024;  // groups of the int8 / bf16 sweep the merge stages
// The Hopper sweep's padded width: at 768 a bf16 block's queries (96 KB)
// and its rows' lists and buffers (119 KB) would leave no ring stage.
constexpr int kD = flat::kNarrowD;

// Shared memory of the bf16 / int8 sweep beyond its static arrays: the
// queries, the lists and buffers of 64 rows and the flush scratch of 4
// warps (kRowLen keys each), and the ring.
template <typename T>
struct ExactSweep {
  static constexpr int kThreads = 160;  // a consumer warpgroup and a producer warp
  // a row's list (kcap) and buffer (kRowLen - kcap) keys: 224 in bf16
  // leaves 2 ring stages, 256 in int8 5
  static constexpr int kRowLen = sizeof(T) == 1 ? 256 : 224;
  static constexpr int kFixed = 1024 + flat::Tiles<T, kD>::kQBytes + (64 + 4) * kRowLen * 8;
  static constexpr int kFree = (flat::kSmemBudget - kFixed) / flat::Tiles<T, kD>::kXBytes;
  static constexpr int kStages = kFree < kMaxStages ? kFree : kMaxStages;
  static constexpr int kSmemBytes = kFixed + kStages * flat::Tiles<T, kD>::kXBytes;
};

// The ranks of the n (<= 32 * P) kept keys in scratch, lane l holding keys
// l, l + 32, ..: up to 64 keys by warp shuffles of every lane's keys (a
// key past n is 0, above no live key), more by reading each key of
// scratch as a shared-memory broadcast to the warp (one 64-bit load where
// the shuffles take two 32-bit ones, but slower at k <= 32 on the H100:
// 0.180 against 0.161 ms at the table's shape; at k = 128, 1.16 against
// 2.03 ms). The first k land sorted in L, and the k-th sets the threshold.
template <int P>
__device__ __forceinline__ void rank_kept(const unsigned long long* scratch, int n, int k,
                                          unsigned long long* L, float* thr_io, int lane) {
  unsigned long long me[P];
  int rank[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    me[i] = lane + 32 * i < n ? scratch[lane + 32 * i] : 0ull;
    rank[i] = 0;
  }
  if constexpr (P <= 2) {
#pragma unroll
    for (int o = 0; o < 32; ++o)
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const unsigned long long other = __shfl_sync(0xffffffffu, me[j], o);
#pragma unroll
        for (int i = 0; i < P; ++i) rank[i] += other > me[i];
      }
  } else {
#pragma unroll 4
    for (int o = 0; o < n; ++o) {
      const unsigned long long other = scratch[o];
#pragma unroll
      for (int i = 0; i < P; ++i) rank[i] += other > me[i];
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (lane + 32 * i < n && rank[i] < k) {
      L[rank[i]] = me[i];
      if (rank[i] == k - 1) *thr_io = key_score(me[i]);
    }
}

// One row's flush, by its warp: the top k of [list L[0..nl) | buffer
// L[kcap..kcap+cnt)] into L[0..) in descending order; updates the row's
// list length, empties its buffer and sets its threshold. A row's keys are
// few, so the steps are latency-bound and run back to back. For k <= 32 and
// more than 2k candidates a pivot prunes them first: the k-th largest of
// the lanes' own two largest candidates (64 values, at least min(m, 64) >=
// k of them live; keys are distinct), so at least k candidates lie at or
// above it. With the lanes' maxima alone (32 values) a k near 32 pruned
// little, and the first design's flushes ranked ~100 keys in shared memory.
template <int kPer>
__device__ __forceinline__ void flush_row(unsigned long long* L, int* nl_io, int* cnt_io,
                                          float* thr_io, int k, int kcap,
                                          unsigned long long* scratch, int lane) {
  const int nl = *nl_io, m = nl + *cnt_io;
  unsigned long long c[kPer];
  unsigned long long t0 = 0ull, t1 = 0ull;  // the lane's two largest
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = lane + 32 * i;
    c[i] = j < m ? L[j < nl ? j : kcap + j - nl] : 0ull;
    const unsigned long long lo = c[i] < t0 ? c[i] : t0;
    t0 = c[i] > t0 ? c[i] : t0;
    t1 = lo > t1 ? lo : t1;
  }
  unsigned long long pivot = 1ull;  // keep every candidate
  if (k <= 32 && m > 2 * k) {
    int above0 = 0, above1 = 0;
#pragma unroll
    for (int o = 0; o < 32; ++o) {
      const unsigned long long a = __shfl_sync(0xffffffffu, t0, o);
      const unsigned long long b = __shfl_sync(0xffffffffu, t1, o);
      above0 += (a > t0) + (b > t0);
      above1 += (a > t1) + (b > t1);
    }
    const unsigned int sel0 = __ballot_sync(0xffffffffu, t0 != 0ull && above0 == k - 1);
    const unsigned int sel1 = __ballot_sync(0xffffffffu, t1 != 0ull && above1 == k - 1);
    pivot = sel0 ? __shfl_sync(0xffffffffu, t0, __ffs(sel0) - 1)
                 : __shfl_sync(0xffffffffu, t1, __ffs(sel1) - 1);
  }
  unsigned int b[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) b[i] = __ballot_sync(0xffffffffu, c[i] >= pivot);
  int n = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    if ((b[i] >> lane) & 1u) scratch[n + __popc(b[i] & ((1u << lane) - 1))] = c[i];
    n += __popc(b[i]);
  }
  __syncwarp();
  if (n <= 32) {
    rank_kept<1>(scratch, n, k, L, thr_io, lane);
  } else if (n <= 64) {
    rank_kept<2>(scratch, n, k, L, thr_io, lane);
  } else {
    rank_kept<kPer>(scratch, n, k, L, thr_io, lane);
  }
  if (lane == 0) {
    *nl_io = n < k ? n : k;
    *cnt_io = 0;
    if (n < k) *thr_io = kSweepNeg;
  }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(ExactSweep<T>::kThreads, 1)
exact_wgmma_sweep_kernel(const T* __restrict__ q, const __grid_constant__ CUtensorMap tm_x,
                         const float* __restrict__ valid,
                         unsigned long long* __restrict__ lists_out, int Bq, int Bqp, int N,
                         int D, int k, int kcap, int tiles_per_group) {
  using namespace flat;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(16) float sval[kMaxStages][kRows];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ int s_cnt[64], s_nl[64];
  __shared__ float s_thr[64];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sQ = (base + 1023) & ~1023u;
  const uint32_t sX = sQ + Tiles<T, kD>::kQBytes;
  constexpr int stages = ExactSweep<T>::kStages, kRowLen = ExactSweep<T>::kRowLen;
  unsigned long long* lists = reinterpret_cast<unsigned long long*>(
      smem_raw + (sX - base) + stages * Tiles<T, kD>::kXBytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * 64;
  const int j0 = blockIdx.y * tiles_per_group;
  const int nt = min(N / kRows, j0 + tiles_per_group) - j0;

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(&full[st], 1);  // the producer's expect_tx; then the bytes
      mbar_init(&empty[st], 4);  // each consumer warp, once done with the tile
    }
    mbar_init_fence();
  }
  if (tid < 64) {
    s_cnt[tid] = 0;
    s_nl[tid] = 0;
    s_thr[tid] = kSweepNeg;
  }
  __syncthreads();

  if (warp == 4) {
    if (lane == 0)
      produce_tiles<T, kD>(&tm_x, valid, sX, sval, full, empty, stages, nt, j0 * kRows, kRows);
    return;
  }
  stage_queries<T, kD>(sQ, q, q0, 64, Bq, D, tid, 128);
  named_barrier(1, 128);

  const int gid = lane >> 2, tig = lane & 3;
  const int rA = 16 * warp + gid, rB = rA + 8;  // the thread's two rows of the tile
  const bool warp_live = q0 + 16 * warp < Bq;
  const bool liveA = q0 + rA < Bq, liveB = q0 + rB < Bq;
  unsigned long long* scratch = lists + (64 + warp) * kRowLen;
  const uint64_t q_desc = make_desc(sQ, 16, 1024, kSw128);

  for (int t = 0; t < nt; ++t) {
    const int st = t % stages;
    mbar_wait(&full[st], (t / stages) & 1);  // tile j0 + t landed
    typename Elem<T>::Acc acc[16];
    tile_product<T, kD>(acc, q_desc, make_desc(sX + st * Tiles<T, kD>::kXBytes, 16, 1024, kSw128));
    if (warp_live) {
      // a dead row (past Bq) takes nothing
      const float thrA = liveA ? s_thr[rA] : INFINITY, thrB = liveB ? s_thr[rB] : INFINITY;
      const int col0 = (j0 + t) * kRows;
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int lc = 8 * c + 2 * tig + e2;
          const float w8 = sval[st][lc];
          const float bias = w8 > 0.f ? 0.f : -1.0e5f;  // (live - 1) * 1e5
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float s = __fadd_rn(__fmul_rn(acc_f32(acc[4 * c + 2 * h + e2]), w8), bias);
            if (s > (h ? thrB : thrA)) {
              const int r = h ? rB : rA;
              const int slot = atomicAdd(&s_cnt[r], 1);
              lists[r * kRowLen + kcap + slot] = sweep_key(s, col0 + lc);
            }
          }
        }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // the warp is done with the stage
    if (warp_live && t < nt - 1) {
      // flush the rows whose buffer the next tile could overflow; after the
      // group's last tile the merge takes list and buffer as they are
      const int limit = kRowLen - kcap - kRows;
      unsigned int need = __ballot_sync(0xffffffffu, lane < 16 && s_cnt[16 * warp + lane] > limit);
      while (need) {
        const int r = 16 * warp + __ffs(need) - 1;
        need &= need - 1;
        flush_row<kRowLen / 32>(lists + r * kRowLen, &s_nl[r], &s_cnt[r], &s_thr[r], k, kcap,
                                scratch, lane);
      }
    }
  }

  // each live row's [list | buffer] and its length, for the merge
  if (!warp_live) return;
  __syncwarp();
  int* counts = reinterpret_cast<int*>(lists_out + (size_t)gridDim.y * Bqp * kRowLen);
  for (int rr = 0; rr < 16; ++rr) {
    const int r = 16 * warp + rr;
    if (q0 + r >= Bq) break;
    const int nl = s_nl[r], n = nl + s_cnt[r];
    unsigned long long* out = lists_out + ((size_t)blockIdx.y * Bqp + q0 + r) * kRowLen;
    for (int j = lane; j < n; j += 32) out[j] = lists[r * kRowLen + (j < nl ? j : kcap + j - nl)];
    if (lane == 0) counts[(size_t)blockIdx.y * Bqp + q0 + r] = n;
  }
}

template <typename T>
int launch_wgmma_sweep(const void* q, const void* x, const float* valid,
                       unsigned long long* lists, int Bq, int Bqp, int N, int D, int k, int kcap,
                       int tiles_per_group, int groups, cudaStream_t st) {
  CUtensorMap tm_x;
  if (!flat::corpus_map<T, kD>(&tm_x, x, N, D)) return (int)cudaErrorInvalidValue;
  constexpr int smem = ExactSweep<T>::kSmemBytes;
  // above 48 KB of dynamic shared memory a kernel must opt in, on each
  // device it runs on (the attribute is the current device's)
  cudaError_t err = cudaFuncSetAttribute(exact_wgmma_sweep_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  exact_wgmma_sweep_kernel<T><<<dim3(Bqp / 64, groups), ExactSweep<T>::kThreads, smem, st>>>(
      static_cast<const T*>(q), tm_x, valid, lists, Bq, Bqp, N, D, k, kcap, tiles_per_group);
  return (int)cudaGetLastError();
}

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

// one block per query: the k largest of the groups' lists, in chunks of
// 4,096 keys beside the running top k, and the TPU's fill for the slots no
// live row reached
__global__ void __launch_bounds__(kMergeThreads)
exact_merge_kernel(const unsigned long long* __restrict__ lists, const int* __restrict__ counts,
                   float* __restrict__ out_s, int* __restrict__ out_i, int Bqp, int k,
                   int stride, int groups, int last_tile_start) {
  __shared__ unsigned long long thread_max[kMergeThreads];
  __shared__ unsigned long long kept[kMergeThreads * (kMergePer + 1)];
  __shared__ unsigned long long run[kMaxK];
  __shared__ flat::SelectShared sh;
  __shared__ int fill_s, most_s;
  __shared__ int len[kMaxMergeGroups];
  const int row = blockIdx.x, tid = threadIdx.x;
  // a group's candidates: its first k keys (the f32 sweep), or as many as
  // its count says (the int8 / bf16 sweep), staged here once
  if (tid == 0) most_s = counts ? 0 : k;
  __syncthreads();
  if (counts) {
    int most = 0;
    for (int g = tid; g < groups; g += kMergeThreads) {
      len[g] = counts[(size_t)g * Bqp + row];
      most = max(most, len[g]);
    }
    atomicMax(&most_s, most);
  }
  __syncthreads();
  const int ncand = groups * most_s;

  int nrun = 0;
  for (int base = 0; base < ncand; base += kMergeThreads * kMergePer) {
    // with k kept, a key at or below the k-th cannot enter: after the first
    // chunk (every group's sorted list) most buffered keys drop here, and a
    // chunk left empty is skipped
    const unsigned long long floor = nrun == k ? run[k - 1] : 0ull;
    unsigned long long cand[kMergePer + 1];
    bool any = false;
#pragma unroll
    for (int i = 0; i < kMergePer; ++i) {
      const int p = base + tid + kMergeThreads * i;
      // rank-major: candidate p is entry p / groups of group p % groups, so a
      // thread holds entries of several ranks (each group's list is sorted)
      // and the threads' maxima spread like the keys themselves
      const int g = p % groups, j = p / groups;
      const size_t at = (size_t)g * Bqp + row;
      const unsigned long long key =
          p < ncand && (!counts || j < len[g]) ? lists[at * stride + j] : 0ull;
      cand[i] = key > floor ? key : 0ull;
      any |= cand[i] != 0ull;
    }
    if (!__syncthreads_or(any)) continue;
    cand[kMergePer] = tid < nrun ? run[tid] : 0ull;
    nrun = flat::block_topk<kMergeThreads, kMergePer + 1>(cand, k, thread_max, kept, run, &sh);
  }
  if (tid == 0) {
    int fill = -1;
    for (int s = 0; s < nrun; ++s) {
      if (key_index(run[s]) < last_tile_start) {
        fill = key_index(run[s]);
        break;
      }
    }
    fill_s = fill;
  }
  __syncthreads();
  for (int s = tid; s < k; s += kMergeThreads) {
    const bool live = s < nrun;
    out_s[(size_t)row * k + s] = live ? key_score(run[s]) : kSweepNeg;
    out_i[(size_t)row * k + s] = live ? key_index(run[s]) : fill_s;
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

// q, x [N,D] in the same dtype (f32 / bf16 / int8), valid [N] f32 weights,
// scratch lists (group g sweeps columns g*cols_per_group ..): f32
// [groups,Bqp,kcap] u64; int8 / bf16 [groups,Bqp,256 / 224] u64 followed by
// [groups,Bqp] int32 counts (ops/topk.py:exact_scratch_keys); outputs
// out_s / out_i [Bq,k]. last_tile_start = N -
// block_n. Bqp % 64 == 0, D % 16 == 0 (D % 32 for int8), 1 <= k <= 128,
// kcap = k rounded up to 32. int8 and bf16: q [>= Bq, D] (rows from Bq on
// are not read), q and x 16-byte aligned, D <= 384, N % 32 == 0,
// cols_per_group % 32 == 0. f32: q [Bqp,D] with rows >= Bq zero, N % 128 ==
// 0, cols_per_group % 128 == 0.
FRAG_EXPORT int frag_topk_exact(const void* q, const void* x, const float* valid,
                                unsigned long long* lists, float* out_s, int* out_i, int Bq,
                                int Bqp, int N, int D, int k, int kcap, int cols_per_group,
                                int last_tile_start, int dtype, void* stream) {
  const int step = dtype == FRAG_F32 ? kChunk : flat::kRows;
  if (Bq < 1 || Bqp % (kWarps * 16) || Bq > Bqp || N % step || cols_per_group % step ||
      cols_per_group < step || D % 16 || (dtype == FRAG_I8 && D % 32) || k < 1 || k > kMaxK ||
      kcap % 32 || kcap < k || kcap > kMaxK ||
      (dtype != FRAG_F32 && (D > kD || (reinterpret_cast<uintptr_t>(q) & 15) ||
                             (reinterpret_cast<uintptr_t>(x) & 15))))
    return (int)cudaErrorInvalidValue;
  const int groups = (N + cols_per_group - 1) / cols_per_group;
  if (dtype != FRAG_F32 && groups > kMaxMergeGroups) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == FRAG_BF16) {
    rc = launch_wgmma_sweep<__nv_bfloat16>(q, x, valid, lists, Bq, Bqp, N, D, k, kcap,
                                           cols_per_group / flat::kRows, groups, st);
  } else if (dtype == FRAG_I8) {
    rc = launch_wgmma_sweep<int8_t>(q, x, valid, lists, Bq, Bqp, N, D, k, kcap,
                                    cols_per_group / flat::kRows, groups, st);
  } else {
    rc = launch_sweep<float>(q, x, valid, lists, dim3(Bqp / (kWarps * 16), groups), N, D, k,
                             kcap, cols_per_group, st);
  }
  if (rc != 0) return rc;
  const int stride = dtype == FRAG_BF16  ? ExactSweep<__nv_bfloat16>::kRowLen
                     : dtype == FRAG_I8 ? ExactSweep<int8_t>::kRowLen
                                        : kcap;
  const int* counts = dtype == FRAG_F32 ? nullptr
                                        : reinterpret_cast<const int*>(lists + (size_t)groups * Bqp * stride);
  exact_merge_kernel<<<Bq, kMergeThreads, 0, st>>>(lists, counts, out_s, out_i, Bqp, k, stride,
                                                   groups, last_tile_start);
  return (int)cudaGetLastError();
}

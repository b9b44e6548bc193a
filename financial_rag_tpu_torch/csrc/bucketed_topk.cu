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
// takes position 0 again: the empty results are (NEG, index of bucket 0).
// K7 writes [Bq, nbuckets] scores and indices; the wrapper's stable top-k
// replaces lax.top_k. The per-query int8 scale is applied by the wrapper,
// as in JAX.
//
// Bound on the H100: device-memory bytes. The corpus (N*D bytes in int8,
// twice that in bf16) is read once; at Bq = 128 the dot products (2*Bq*N*D)
// take about half the byte time at the int8 tensor-core rate.
//
// K5's and K7's sweep over an int8 or bf16 corpus (sm_90a, flat_sweep.cuh). It
// replaces a sweep whose every warp ran mma.sync on 4-byte loads straight
// from device memory for 64 queries a block, re-read each block's 16 corpus
// rows for those 64 queries only, and passed every round's scores through
// shared memory (25x its bound at Bq = 128, N = 102,400). A block now owns
// 32 bucket positions b0 .. b0+31, a tile of up to 128 queries (two consumer
// warpgroups of 64 from Bqp >= 128) and a group of consecutive rounds r;
// round r is corpus rows r*nbuckets + b0 .. +31, which lie wholly below N or
// wholly past it. Its queries are staged once, and the rounds' rows (12 KB
// in int8, 24 KB in bf16 at D = 384) stream through the TMA ring of
// flat_sweep.cuh: 12 stages in int8, 5-7 in bf16 (at D = 1,024, where a
// block takes one warpgroup: 5 in int8, and 3 of 16 rows in bf16, whose 128
// KB of queries leave no room for two 64 KB stages of 32 rows; such a block
// owns 16 bucket positions). The scores are
// wgmma m64n32k32 s32 (int8) or m64n32k16 f32 (bf16) products, and the
// bucket update runs on the accumulator registers: accumulator element i of
// a thread is the same (query, bucket position) in every round, so the
// thread keeps that bucket's best weighted score and its round in 2 x 16
// registers (strict >, rounds in order: the lower column keeps a tie), and
// no score passes through shared memory. The sweep writes each bucket's
// 64-bit key (orderable score above the inverted column, 0 if nothing live
// reached it), whose maximum over round groups is the bucket's running max
// in column order, so the wrapper picks the groups (bucketed_sweep_grid) to
// fill the SMs once without changing a result: one group at N = 102,400
// (128 blocks, 25 rounds each) and at the served N = 4,096 (128 blocks of
// one round). K7 takes the same sweep and grid, and its write kernel folds
// the same keys; its bound also counts the [Bq, nbuckets] maxima it writes
// (0.0249 ms at Bq = 128, N = 102,400 in bf16 at 3.35 TB/s). f32 corpora
// keep the older CUDA-core / mma.sync sweep (bucketed_sweep_kernel below:
// 64 queries = 4 warps x 16, 16 bucket positions a block, round groups for
// ~8 blocks an SM).
//
// K5's extract (one block of 256 threads per query, any sweep) folds the
// groups' keys of its 16 bucket positions a thread and re-keys each live
// bucket as (score, inverted position, inverted round): ordered by score
// and then by the lower bucket position, _merge_topk's order, with the
// column recoverable (nbuckets <= 4096, rounds < 2^20). flat::block_topk
// selects the k largest by a threshold and a rank count instead of k
// block-wide rounds with a barrier each (that shape took 23.5 us at k = 24
// in K4's earlier merge), and the slots past the live buckets get (NEG,
// bucket 0's column or -1). Its first version folded each bucket's groups
// in a loop of its own, which serialised a thread's 16 loads: 12.6 us
// against 6.4 with a group's loads in flight together (Bq = 128, N =
// 102,400).
#include "flat_sweep.cuh"

namespace {

constexpr int kWarps = 4;  // 4 x 16 = 64 queries per block
constexpr int kCols = 16;  // bucket positions per block
constexpr int kExtractThreads = 256;
constexpr int kExtractPer = 16;  // 256 * 16 = 4096 bucket positions
constexpr int kMaxK = 256;
constexpr int kMaxBuckets = 4096;  // 12 bits of an extract key
constexpr int kRoundBits = 20;     // the round below them

// K5's Hopper sweep: kWG consumer warpgroups of 64 queries and a producer
// warp, over rows zero-padded to kD features. Stages: 12 in int8 and 5-7 in
// bf16 at kD = 384; 5 in int8 (two warpgroups, a 768-byte row as bf16 at
// 384) and 2 in bf16 (one warpgroup: two would leave no stage) at kD = 768;
// at kD = 1,024 one warpgroup, 5 stages of 32 rows in int8 (64 KB of
// queries) and 3 of 16 rows in bf16 (128 KB of queries, flat::Tiles).
template <typename T, int kD>
struct SweepShape {
  using Tl = flat::Tiles<T, kD>;
  static constexpr int kMaxWG = Tl::kRowBytes <= 768 ? 2 : 1;  // ops/topk.py query_tile
};

template <typename T, int kWG, int kD>
struct BucketSweep {
  using Tl = flat::Tiles<T, kD>;
  static_assert(kWG <= SweepShape<T, kD>::kMaxWG, "no ring stage would fit");
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 32;
  static constexpr int kFree = flat::kSmemBudget - 1024 - kWG * Tl::kQBytes;
  static constexpr int kStages = kFree / Tl::kXBytes < 12 ? kFree / Tl::kXBytes : 12;
  static constexpr int kSmemBytes = 1024 + kWG * Tl::kQBytes + kStages * Tl::kXBytes;
};

template <typename T, int kWG, int kD>
__global__ void __launch_bounds__(BucketSweep<T, kWG, kD>::kThreads, 1)
bucketed_wgmma_sweep_kernel(const T* __restrict__ q, const __grid_constant__ CUtensorMap tm_x,
                            const float* __restrict__ valid,
                            unsigned long long* __restrict__ keys, int Bq, int Bqp, int N, int D,
                            int nbuckets, int rounds_per_group) {
  using namespace flat;
  using S = BucketSweep<T, kWG, kD>;
  using Tl = typename S::Tl;
  constexpr int kStages = S::kStages;
  constexpr int kTileRows = Tl::kTileRows, kAcc = Tl::kAcc;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(16) float sval[kStages][kTileRows];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sX = sQ + kWG * Tl::kQBytes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b0 = blockIdx.x * kTileRows;
  const int q0 = blockIdx.y * (64 * kWG);
  const int r0 = blockIdx.z * rounds_per_group;
  // round r reaches rows r*nbuckets + b0 .. + kTileRows - 1: all below N or
  // all past it (N and nbuckets are multiples of 32)
  const int r_end = min(r0 + rounds_per_group, (N - b0 + nbuckets - 1) / nbuckets);
  const int nt = max(0, r_end - r0);

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);                    // the producer's expect_tx; then the bytes
      mbar_init(&empty[st], S::kConsumers / 32);  // each consumer warp, once done with it
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == S::kConsumers / 32) {
    if (lane == 0)
      produce_tiles<T, kD>(&tm_x, valid, sX, sval, full, empty, kStages, nt, r0 * nbuckets + b0,
                       nbuckets);
    return;
  }
  stage_queries<T, kD>(sQ, q, q0, 64 * kWG, Bq, D, tid, S::kConsumers);
  named_barrier(1, S::kConsumers);

  const int w = warp >> 2;  // warpgroup
  const bool wg_live = q0 + 64 * w < Bq;
  const bool warp_live = q0 + 64 * w + 16 * (warp & 3) < Bq;
  const int gid = lane >> 2, tig = lane & 3;
  const uint64_t q_desc = make_desc(sQ + w * Tl::kQBytes, 16, 1024, kSw128);
  // bs[4*c + e]: query row 16*(warp%4) + gid + 8*(e/2) of the warpgroup,
  // bucket position b0 + 8*c + 2*tig + e%2; br the round of its best
  float bs[kAcc];
  int br[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    bs[i] = kSweepNeg;  // below every live score: a dead row (-1e5) never enters
    br[i] = 0;
  }

  for (int t = 0; t < nt; ++t) {
    const int st = t % kStages;
    mbar_wait(&full[st], (t / kStages) & 1);  // round r0 + t landed
    if (wg_live) {
      typename Elem<T>::Acc acc[kAcc];
      tile_product<T, kD>(acc, q_desc, make_desc(sX + st * Tl::kXBytes, 16, 1024, kSw128));
      if (warp_live) {
#pragma unroll
        for (int c = 0; c < kTileRows / 8; ++c)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const float w8 = sval[st][8 * c + 2 * tig + e2];
            const float bias = w8 > 0.f ? 0.f : -1.0e5f;  // (live - 1) * 1e5
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * c + 2 * h + e2;
              const float s = __fadd_rn(__fmul_rn(acc_f32(acc[i]), w8), bias);
              if (s > bs[i]) {
                bs[i] = s;
                br[i] = t;
              }
            }
          }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // the warp is done with the stage
  }

  if (!warp_live) return;
  const int row0 = q0 + 64 * w + 16 * (warp & 3) + gid;
#pragma unroll
  for (int c = 0; c < kTileRows / 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h, pos = b0 + 8 * c + 2 * tig;
      if (row >= Bq) continue;
      unsigned long long out[2];
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int i = 4 * c + 2 * h + e2;
        out[e2] = bs[i] > kSweepNeg ? sweep_key(bs[i], (r0 + br[i]) * nbuckets + pos + e2) : 0ull;
      }
      *reinterpret_cast<ulonglong2*>(keys + ((size_t)blockIdx.z * Bqp + row) * nbuckets + pos) =
          make_ulonglong2(out[0], out[1]);
    }
}

template <typename T, int kWG, int kD>
cudaError_t launch_wgmma_sweep(const void* q, const CUtensorMap& tm_x, const float* valid,
                               unsigned long long* keys, int Bq, int Bqp, int N, int D,
                               int nbuckets, int rounds_per_group, int groups, cudaStream_t st) {
  using S = BucketSweep<T, kWG, kD>;
  // above 48 KB of dynamic shared memory a kernel must opt in, on each
  // device it runs on (the attribute is the current device's)
  const cudaError_t opt_in = cudaFuncSetAttribute(
      bucketed_wgmma_sweep_kernel<T, kWG, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kSmemBytes);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid(nbuckets / S::Tl::kTileRows, (Bqp + 64 * kWG - 1) / (64 * kWG), groups);
  bucketed_wgmma_sweep_kernel<T, kWG, kD><<<grid, S::kThreads, S::kSmemBytes, st>>>(
      static_cast<const T*>(q), tm_x, valid, keys, Bq, Bqp, N, D, nbuckets, rounds_per_group);
  return cudaGetLastError();
}

template <typename T, int kD>
cudaError_t launch_wgmma_sweep(const void* q, const void* x, const float* valid,
                               unsigned long long* keys, int Bq, int Bqp, int N, int D,
                               int nbuckets, int rounds_per_group, int groups, cudaStream_t st) {
  CUtensorMap tm_x;
  if (!flat::corpus_map<T, kD>(&tm_x, x, N, D)) return cudaErrorInvalidValue;
  if constexpr (SweepShape<T, kD>::kMaxWG == 2) {
    if (Bqp >= 128)
      return launch_wgmma_sweep<T, 2, kD>(q, tm_x, valid, keys, Bq, Bqp, N, D, nbuckets,
                                          rounds_per_group, groups, st);
  }
  return launch_wgmma_sweep<T, 1, kD>(q, tm_x, valid, keys, Bq, Bqp, N, D, nbuckets,
                                      rounds_per_group, groups, st);
}

template <typename T>
cudaError_t launch_wgmma_sweep(const void* q, const void* x, const float* valid,
                               unsigned long long* keys, int Bq, int Bqp, int N, int D,
                               int nbuckets, int rounds_per_group, int groups, cudaStream_t st) {
  if (D <= flat::kNarrowD)
    return launch_wgmma_sweep<T, flat::kNarrowD>(q, x, valid, keys, Bq, Bqp, N, D, nbuckets,
                                                 rounds_per_group, groups, st);
  if (D <= flat::kWideD)
    return launch_wgmma_sweep<T, flat::kWideD>(q, x, valid, keys, Bq, Bqp, N, D, nbuckets,
                                               rounds_per_group, groups, st);
  return launch_wgmma_sweep<T, flat::kLargeD>(q, x, valid, keys, Bq, Bqp, N, D, nbuckets,
                                              rounds_per_group, groups, st);
}

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

// K5's extract, one block per query: the k largest bucket maxima, ties to
// the lower bucket position, then (NEG, bucket 0's column or -1) past the
// live buckets
__global__ void __launch_bounds__(kExtractThreads)
bucketed_extract_kernel(const unsigned long long* __restrict__ keys, float* __restrict__ out_s,
                        int* __restrict__ out_i, int Bqp, int nbuckets, int groups, int k) {
  __shared__ unsigned long long thread_max[kExtractThreads];
  __shared__ unsigned long long kept[kExtractThreads * kExtractPer];
  __shared__ unsigned long long sel[kMaxK];
  __shared__ flat::SelectShared sh;
  __shared__ int fill;
  const int row = blockIdx.x, tid = threadIdx.x;
  const size_t stride = (size_t)Bqp * nbuckets;

  // each bucket's key folded over the groups, all of a group's loads in
  // flight together
  unsigned long long mk[kExtractPer];
#pragma unroll
  for (int i = 0; i < kExtractPer; ++i) {
    const int pos = tid + kExtractThreads * i;
    mk[i] = pos < nbuckets ? keys[(size_t)row * nbuckets + pos] : 0ull;
  }
  for (int g = 1; g < groups; ++g) {
#pragma unroll
    for (int i = 0; i < kExtractPer; ++i) {
      const int pos = tid + kExtractThreads * i;
      const unsigned long long key =
          pos < nbuckets ? keys[g * stride + (size_t)row * nbuckets + pos] : 0ull;
      mk[i] = key > mk[i] ? key : mk[i];
    }
  }
  if (tid == 0) fill = mk[0] ? key_index(mk[0]) : -1;
  // re-key: (score, inverted position, inverted round)
#pragma unroll
  for (int i = 0; i < kExtractPer; ++i) {
    const int pos = tid + kExtractThreads * i;
    if (mk[i]) {
      const unsigned int round = (unsigned int)(key_index(mk[i]) - pos) / nbuckets;
      mk[i] = (mk[i] & 0xFFFFFFFF00000000ull) |
              ((unsigned long long)(kMaxBuckets - 1 - pos) << kRoundBits) |
              ((1u << kRoundBits) - 1 - round);
    }
  }
  const int n = flat::block_topk<kExtractThreads, kExtractPer>(mk, k, thread_max, kept, sel, &sh);
  for (int s = tid; s < k; s += kExtractThreads) {
    if (s < n) {
      const unsigned long long key = sel[s];
      const int pos = kMaxBuckets - 1 - (int)((key >> kRoundBits) & (kMaxBuckets - 1));
      const int round = (1 << kRoundBits) - 1 - (int)(key & ((1u << kRoundBits) - 1));
      out_s[(size_t)row * k + s] = key_score(key);
      out_i[(size_t)row * k + s] = round * nbuckets + pos;
    } else {
      out_s[(size_t)row * k + s] = kSweepNeg;
      out_i[(size_t)row * k + s] = fill;
    }
  }
}

// K7: the bucket maxima themselves, [Bq, nbuckets], from either sweep's keys
// (4 MB of keys read and 4 MB written at Bq = 128, nbuckets = 4,096)
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

// q, x [N,D] in the same dtype (f32 / bf16 / int8), valid [N] f32 weights,
// scratch keys [groups,Bqp,nbuckets] u64 (group g sweeps rounds
// g*rounds_per_group ..). K5 (k > 0) writes out_s / out_i [Bq,k], K7 (k ==
// 0) [Bq,nbuckets]. Over int8 or bf16 (the Hopper sweep): q [>= Bq, D] (rows
// from Bq on are not read), both 16-byte aligned, D <= 1024, N % 32 == 0,
// nbuckets % 32 == 0. Over f32: q [Bqp,D] with rows >= Bq zero, N % 16 == 0,
// nbuckets % 16 == 0. Bqp % 64 == 0, D % 16 == 0 (D % 32 for int8); K5 also
// needs nbuckets <= 4096, fewer than 2^20 rounds and k <= min(256, nbuckets).
FRAG_EXPORT int frag_bucketed_topk(const void* q, const void* x, const float* valid,
                                   unsigned long long* keys, float* out_s, int* out_i, int Bq,
                                   int Bqp, int N, int D, int nbuckets, int k,
                                   int rounds_per_group, int dtype, void* stream) {
  const bool hopper = dtype != FRAG_F32;
  const int rounds = nbuckets > 0 ? (N + nbuckets - 1) / nbuckets : 0;
  if (Bq < 1 || Bqp % (kWarps * 16) || Bq > Bqp || N % (hopper ? 32 : 16) || nbuckets % kCols ||
      nbuckets < kCols || D % 16 || (dtype == FRAG_I8 && D % 32) || rounds_per_group < 1 ||
      k < 0 || (k > 0 && (k > kMaxK || k > nbuckets || nbuckets > kMaxBuckets ||
                          rounds >= (1 << kRoundBits))) ||
      (hopper && (nbuckets % flat::kRows || D > flat::kLargeD ||
                  (reinterpret_cast<uintptr_t>(q) & 15) || (reinterpret_cast<uintptr_t>(x) & 15))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = (rounds + rounds_per_group - 1) / rounds_per_group;
  cudaError_t err;
  if (hopper) {
    err = dtype == FRAG_BF16
              ? launch_wgmma_sweep<__nv_bfloat16>(q, x, valid, keys, Bq, Bqp, N, D, nbuckets,
                                                  rounds_per_group, groups, st)
              : launch_wgmma_sweep<int8_t>(q, x, valid, keys, Bq, Bqp, N, D, nbuckets,
                                           rounds_per_group, groups, st);
  } else {
    const dim3 grid(nbuckets / kCols, Bqp / (kWarps * 16), groups);
    if (dtype == FRAG_BF16) {
      launch_sweep<__nv_bfloat16>(q, x, valid, keys, grid, N, D, nbuckets, rounds_per_group, st);
    } else if (dtype == FRAG_I8) {
      launch_sweep<int8_t>(q, x, valid, keys, grid, N, D, nbuckets, rounds_per_group, st);
    } else {
      launch_sweep<float>(q, x, valid, keys, grid, N, D, nbuckets, rounds_per_group, st);
    }
    err = cudaGetLastError();
  }
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

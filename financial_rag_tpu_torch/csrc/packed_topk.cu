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
// is read once for up to 128 queries; 2*Bq*N*D flops at Bq = 128 are ~1/2 of
// the byte time at the bf16 tensor-core rate.
//
// Design of the bf16 sweep (sm_90a), one template over the padded width kD
// = 384 (D <= 384), 768 (D <= 768: bge-base, gte-base) or 1,024 (D <=
// 1,024: bge-large, gte-large). The TPU runs the corpus tiles j in
// order and carries the buckets in scratch. Hopper blocks run in no order,
// so a block owns 32 bucket columns t0 .. t0+31, a tile of up to 128 queries
// and one group of consecutive tiles j, and walks its tiles itself. Its
// queries (one warpgroup per 64, zeros past Bq and past D) are loaded into
// shared memory once, 128-byte swizzled (cp.async). The 32 corpus rows of
// each tile j*block_n + t0 .. +31 (24 KB at D = 384) and their 32 weights
// stream through a ring of 5 stages (6 with one warpgroup): a producer warp
// has the TMA copy each tile (6 boxes of 32 rows x 64 features, swizzled as
// the products read them, zeros past N and D; the weights by a bulk copy)
// as soon as every consumer warp has released its stage through the
// stage's empty mbarrier, and the bytes complete its full mbarrier. At kD =
// 768 a warpgroup's queries are 96 KB and a stage 48 KB (12 boxes), so a
// block holds one warpgroup of 64 queries and a ring of 2 stages (193 KB):
// a query batch of 128 takes two query tiles over the same corpus, the
// second mostly from L2 (blockIdx.x runs fastest, so both read a tile
// about together), and a stage in flight is still 48 KB of corpus. At kD =
// 1,024 a warpgroup's queries are 128 KB and a 32-row stage 64 KB, which
// leaves one stage: there a block owns 16 bucket columns (wgmma m64n16, 16
// corpus rows a tile, a 32 KB stage) and a ring of 3 stages (225 KB). So the
// copies run on while the consumers multiply and update, with no block
// barrier between tiles. Each
// warpgroup takes scores = Q X^T by wgmma m64n32k16 (queries as the 64-row
// M operand, the corpus tile as the K-major B operand: the corpus's own
// row-major layout, nothing transposed). Padding a small query batch to 64
// rows costs tensor-core time only, and the sweep is bound by the corpus
// bytes, not by that. The bucket update runs on the accumulator registers:
// a thread's accumulator element i is the same (query, bucket) pair in every
// tile, so its running top-2 stays in 2 x 16 registers across the block's
// tiles, and no score goes through shared memory. A warp whose 16 queries
// all lie past Bq skips the update, a warpgroup whose 64 all do skips the
// products, and only rows below Bq are written. The grid is 32-column
// slices x query tiles x tile groups, one block an SM (~193 or ~217 KB of
// shared memory): the wrapper picks the groups so that the grid fills the
// SMs once.
// The top-2 of a bucket over all tiles is the top-2 of the groups' top-2s,
// whatever their order, so splitting changes no result. An f32 corpus (not
// the flat index's default) keeps a CUDA-core dot, 16 columns x 64 queries
// a block.
//
// Tried on the H100 and dropped, each slower in its own A/B: every thread
// issuing the tiles by cp.async three tiles ahead, behind a block barrier a
// tile (at 128 queries the products and updates then held up the copies);
// the same with 5-6 stages; and a tile's 24 products split over two
// accumulator chains.
//
// The merge (one block per query) folds the groups' pairs, so each thread
// holds 8 candidates as 64-bit keys (packed word, inverted position: equal
// words go to the earlier position, as _merge_topk does; a dead one is 0).
// Rather than k rounds of a block-wide maximum, it takes the k-th largest of
// the 256 threads' own maxima as a threshold tau (at least k candidates lie
// at or above it, so the top k all do), keeps the live candidates >= tau
// (about k of them on real data), and ranks each kept one by counting the
// kept keys above it: a handful of block barriers whatever k is.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kNeg = -3.0e4f;  // ops/topk.py NEG
constexpr int kMaxK = 256;

// bf16 sweep
constexpr int kNarrowD = 384;                 // features, zero-padded to this, to
constexpr int kWideD = 768;                   // this one or to
constexpr int kLargeD = 1024;                 // this one
constexpr int kQRegion = 64 * 128;            // 64 query rows x 64 features, SW128

// consumer warpgroups (64 queries each) and a producer warp, over kD features
template <int kWG, int kD>
struct Sweep {
  static_assert(kD == kNarrowD || ((kD == kWideD || kD == kLargeD) && kWG == 1),
                "K4's bf16 sweep shapes");
  static constexpr int kCols = kD == kLargeD ? 16 : 32;   // bucket columns a block (wgmma N)
  static constexpr int kXRegion = kCols * 128;             // kCols corpus rows x 64 features, SW128
  static constexpr int kChunks = kD / 8;                   // 16-byte chunks of a row
  static constexpr int kQBytes = (kD / 64) * kQRegion;     // one warpgroup's queries: 48 / 96 / 128 KB
  static constexpr int kXBytes = (kD / 64) * kXRegion;     // one stage: 24 / 48 / 32 KB
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 32;
  static constexpr int kStages = kD == kLargeD ? 3 : kD == kWideD ? 2 : kWG == 1 ? 6 : 5;
  static constexpr int kSmemBytes = kWG * kQBytes + kStages * kXBytes + 1024;  // + alignment
};

// one k16 step of a tile's scores, its N the accumulator's size
__device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_n32(d, a, b, acc);
}
__device__ __forceinline__ void mma(float (&d)[8], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_n16(d, a, b, acc);
}

// f32 sweep
constexpr int kF32Warps = 4;   // 4 x 16 = 64 queries a block
constexpr int kF32Cols = 16;   // bucket columns a block

// merge
constexpr int kMergeThreads = 256;
constexpr int kMergeBuckets = 4;                  // 256 * 4 >= 1024 buckets
constexpr int kMergeCands = 2 * kMergeBuckets;    // best and runner-up of each
constexpr int kMaxCands = kMergeThreads * kMergeCands;
constexpr int kFoldGroups = 4;                    // tile groups whose pairs load together

// The bucket update of one packed word: best and runner-up, signed.
__device__ __forceinline__ void top2(int& b1, int& b2, int pb) {
  const int old = b1;
  b1 = max(old, pb);
  b2 = max(b2, min(old, pb));
}

__device__ __forceinline__ int pack(float s, bool live, int mask, int tag) {
  const float p = live ? s + 2.f : -2.f;
  return (__float_as_int(p) & ~mask) | tag;
}

template <int kWG, int kD>
__global__ void __launch_bounds__(Sweep<kWG, kD>::kThreads, 1)
packed_sweep_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __grid_constant__ CUtensorMap tm_x,
                         const float* __restrict__ valid, int* __restrict__ b1_out,
                         int* __restrict__ b2_out, int Bq, int Bqp, int D, int block_n,
                         int ntiles, int bits, int tiles_per_group) {
  using Sw = Sweep<kWG, kD>;
  constexpr int kStages = Sw::kStages, kConsumers = Sw::kConsumers;
  constexpr int kChunks = Sw::kChunks, kQBytes = Sw::kQBytes, kXBytes = Sw::kXBytes;
  constexpr int kCols = Sw::kCols, kXRegion = Sw::kXRegion, kAcc = kCols / 2;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(16) float sval[kStages][kCols];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sX = sQ + kWG * kQBytes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = blockIdx.x * kCols;
  const int q0 = blockIdx.y * (64 * kWG);
  const int j0 = blockIdx.z * tiles_per_group;
  const int nt = min(ntiles, j0 + tiles_per_group) - j0;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);                 // the producer's expect_tx; then the tile's bytes
      mbar_init(&empty[st], kConsumers / 32);  // each consumer warp, once done with the tile
    }
    mbar_init_fence();
  }
  for (int i = tid; i < kStages * kCols; i += Sw::kThreads) (&sval[0][0])[i] = 0.f;
  fence_proxy_async();  // the zeros land before any bulk copy into sval
  __syncthreads();

  if (warp == kConsumers / 32) {
    // the producer: tile j's kCols corpus rows (kD/64 swizzled boxes; zeros past N
    // and past D) and their weights (zeros past block_n stay from above),
    // kStages tiles ahead of the slowest consumer warp
    if (lane == 0) {
      const uint32_t vbytes = 4 * min(kCols, block_n - t0);
      for (int t = 0; t < nt; ++t) {
        const int st = t % kStages, n0 = (j0 + t) * block_n + t0;
        if (t >= kStages) mbar_wait(&empty[st], (t / kStages - 1) & 1);
        mbar_expect_tx(&full[st], kXBytes + vbytes);
#pragma unroll
        for (int r = 0; r < kD / 64; ++r)
          tma_load_2d(sX + st * kXBytes + r * kXRegion, &tm_x, 64 * r, n0, &full[st]);
        bulk_load(smem_u32(sval[st]), valid + n0, vbytes, &full[st]);
      }
    }
    return;
  }

  // the consumers: the block's queries, zeros past Bq and past D
  const int dch = D / 8;
  for (int e = tid; e < kWG * 64 * kChunks; e += kConsumers) {
    const int r = e / kChunks, ch = e - r * kChunks, row = q0 + r;
    const bool ok = row < Bq && ch < dch;
    cp_async16(sQ + (r >> 6) * kQBytes + sw128_chunk(r & 63, ch),
               q + (ok ? (size_t)row * D + 8 * ch : 0), ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  named_barrier(1, kConsumers);

  const int w = warp >> 2;  // warpgroup
  const bool wg_live = q0 + 64 * w < Bq;
  const bool warp_live = q0 + 64 * w + 16 * (warp & 3) < Bq;
  const int gid = lane >> 2, tig = lane & 3;
  const int mask = (1 << bits) - 1, maxj = ntiles - 1;
  const uint64_t q_desc = make_desc(sQ + w * kQBytes, 16, 1024, kSw128);
  // acc[4*c + e]: query row 16*(warp%4) + gid + 8*(e/2) of the warpgroup,
  // bucket column t0 + 8*c + 2*tig + e%2; b1/b2 the same pairs' top-2
  int b1[kAcc], b2[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) b1[i] = b2[i] = 0;

  for (int t = 0; t < nt; ++t) {
    const int st = t % kStages;
    mbar_wait(&full[st], (t / kStages) & 1);  // tile t landed
    if (wg_live) {
      const uint64_t x_desc = make_desc(sX + st * kXBytes, 16, 1024, kSw128);
      float acc[kAcc];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        mma(acc, desc_add(q_desc, (kk >> 2) * kQRegion + off),
            desc_add(x_desc, (kk >> 2) * kXRegion + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      if (warp_live) {
        const int tag = maxj - (j0 + t);
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          const bool live = sval[st][8 * (i >> 2) + 2 * tig + (i & 1)] > 0.f;
          top2(b1[i], b2[i], pack(acc[i], live, mask, tag));
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // the warp is done with the stage
  }

  if (!warp_live) return;
  const int row0 = q0 + 64 * w + 16 * (warp & 3) + gid;
#pragma unroll
  for (int c = 0; c < kCols / 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h, col = t0 + 8 * c + 2 * tig;
      if (row >= Bq || col >= block_n) continue;
      const size_t at = ((size_t)blockIdx.z * Bqp + row) * block_n + col;
      const int i = 4 * c + 2 * h;
      *reinterpret_cast<int2*>(b1_out + at) = make_int2(b1[i], b1[i + 1]);
      *reinterpret_cast<int2*>(b2_out + at) = make_int2(b2[i], b2[i + 1]);
    }
}

// f32 corpus: lane l of warp w scores query q0 + 16*w + e/16 against bucket
// column t0 + e%16, for e = l + 32*i, by a sequential CUDA-core dot.
__global__ void __launch_bounds__(kF32Warps * 32)
packed_sweep_f32_kernel(const float* __restrict__ q, const float* __restrict__ x,
                        const float* __restrict__ valid, int* __restrict__ b1_out,
                        int* __restrict__ b2_out, int Bq, int Bqp, int D, int block_n, int ntiles,
                        int bits, int tiles_per_group) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * (kF32Warps * 16) + warp * 16;
  const int t0 = blockIdx.x * kF32Cols;
  const int mask = (1 << bits) - 1, maxj = ntiles - 1;
  if (q0 >= Bq) return;

  int b1[8], b2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) b1[i] = b2[i] = 0;
  const int j_end = min(ntiles, (int)(blockIdx.z + 1) * tiles_per_group);
  for (int j = blockIdx.z * tiles_per_group; j < j_end; ++j) {
    const size_t n0 = (size_t)j * block_n + t0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = lane + 32 * i, r = e >> 4, col = e & 15;
      float dot = 0.f;
      if (q0 + r < Bq) {
        const float* qr = q + (size_t)(q0 + r) * D;
        const float* xr = x + (n0 + col) * D;
        for (int d = 0; d < D; ++d) dot += qr[d] * xr[d];
      }
      top2(b1[i], b2[i], pack(dot, valid[n0 + col] > 0.f, mask, maxj - j));
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = lane + 32 * i, r = e >> 4, col = e & 15;
    if (q0 + r >= Bq) continue;
    const size_t at = ((size_t)blockIdx.z * Bqp + q0 + r) * block_n + t0 + col;
    b1_out[at] = b1[i];
    b2_out[at] = b2[i];
  }
}

// A candidate's order key: the packed word above the inverted position, so
// a larger key is a larger word or, for equal words, the earlier position;
// 0 for a dead bucket (packed <= 0), below every live key.
__device__ __forceinline__ unsigned long long cand_key(int packed, int pos) {
  return packed > 0 ? ((unsigned long long)(unsigned int)packed << 32) |
                          (unsigned int)(0xFFFFFFFFu - (unsigned int)pos)
                    : 0ull;
}

__global__ void __launch_bounds__(kMergeThreads)
packed_merge_kernel(const int* __restrict__ b1, const int* __restrict__ b2,
                    float* __restrict__ out_s, int* __restrict__ out_i, int Bqp, int block_n,
                    int ntiles, int bits, int k, int groups) {
  __shared__ unsigned long long thread_max[kMergeThreads];
  __shared__ unsigned long long kept[kMaxCands];
  __shared__ unsigned long long s_tau;
  __shared__ int s_kept;
  const int row = blockIdx.x, tid = threadIdx.x;
  const int mask = (1 << bits) - 1, maxj = ntiles - 1;

  // buckets t = tid + 256*i: best at position t, runner-up at block_n + t.
  // Each bucket's top-2 over the tile groups, in group order; the loads of
  // kFoldGroups groups are issued together (a (0, 0) pair changes nothing:
  // every word kept is >= 0)
  int p1[kMergeBuckets] = {}, p2[kMergeBuckets] = {};
  for (int g0 = 0; g0 < groups; g0 += kFoldGroups) {
    int a1[kMergeBuckets][kFoldGroups], a2[kMergeBuckets][kFoldGroups];
#pragma unroll
    for (int i = 0; i < kMergeBuckets; ++i)
#pragma unroll
      for (int gg = 0; gg < kFoldGroups; ++gg) {
        const int t = tid + kMergeThreads * i, g = g0 + gg;
        const size_t at = ((size_t)g * Bqp + row) * block_n + t;
        const bool ok = t < block_n && g < groups;
        a1[i][gg] = ok ? b1[at] : 0;
        a2[i][gg] = ok ? b2[at] : 0;
      }
#pragma unroll
    for (int i = 0; i < kMergeBuckets; ++i)
#pragma unroll
      for (int gg = 0; gg < kFoldGroups; ++gg) {
        p2[i] = max(max(p2[i], a2[i][gg]), min(p1[i], a1[i][gg]));
        p1[i] = max(p1[i], a1[i][gg]);
      }
  }
  unsigned long long key[kMergeCands];
  unsigned long long mine = 0ull;
#pragma unroll
  for (int i = 0; i < kMergeBuckets; ++i) {
    const int t = tid + kMergeThreads * i;
    key[2 * i] = t < block_n ? cand_key(p1[i], t) : 0ull;
    key[2 * i + 1] = t < block_n ? cand_key(p2[i], block_n + t) : 0ull;
    mine = max(mine, max(key[2 * i], key[2 * i + 1]));
  }
  thread_max[tid] = mine;
  if (tid == 0) {
    s_tau = 1ull;  // fewer than k live thread maxima: keep every live candidate
    s_kept = 0;
  }
  __syncthreads();
  // tau: the k-th largest thread maximum (live keys are distinct)
  if (mine != 0ull) {
    int above = 0;
    for (int i = 0; i < kMergeThreads; ++i) above += thread_max[i] > mine;
    if (above == k - 1) s_tau = mine;
  }
  __syncthreads();
  const unsigned long long tau = s_tau;
#pragma unroll
  for (int i = 0; i < kMergeCands; ++i)
    if (key[i] != 0ull && key[i] >= tau) kept[atomicAdd(&s_kept, 1)] = key[i];
  __syncthreads();
  const int n = s_kept;
  for (int i = tid; i < n; i += kMergeThreads) {
    const unsigned long long me = kept[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += kept[j] > me;
    if (rank >= k) continue;
    const int packed = (int)(me >> 32);
    const int pos = (int)(0xFFFFFFFFu - (unsigned int)me);
    const int t = pos < block_n ? pos : pos - block_n;
    out_s[(size_t)row * k + rank] = __int_as_float(packed & ~mask) - 2.f;
    out_i[(size_t)row * k + rank] = (maxj - (packed & mask)) * block_n + t;
  }
  for (int r = n + tid; r < k; r += kMergeThreads) {  // fewer live candidates than k
    out_s[(size_t)row * k + r] = kNeg;
    out_i[(size_t)row * k + r] = -1;
  }
}

template <int kWG, int kD>
cudaError_t launch_bf16_sweep(const void* q, const void* x, const float* valid, int* b1, int* b2,
                              int Bq, int Bqp, int N, int D, int block_n, int ntiles, int bits,
                              int tiles_per_group, int groups, cudaStream_t st) {
  using Sw = Sweep<kWG, kD>;
  CUtensorMap tm_x;  // x [N][D] in boxes of kCols rows x 64 features, 128-byte swizzle
  if (!hopper::tensor_map_2d(&tm_x, x, N, D, Sw::kCols, 64, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory a kernel must opt in, on each
  // device it runs on (the attribute is the current device's)
  const cudaError_t opt_in = cudaFuncSetAttribute(
      packed_sweep_bf16_kernel<kWG, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Sw::kSmemBytes);
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid((block_n + Sw::kCols - 1) / Sw::kCols, (Bqp + 64 * kWG - 1) / (64 * kWG), groups);
  packed_sweep_bf16_kernel<kWG, kD><<<grid, Sw::kThreads, Sw::kSmemBytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), tm_x, valid, b1, b2, Bq, Bqp, D, block_n, ntiles,
      bits, tiles_per_group);
  return cudaGetLastError();
}

}  // namespace

// q [>= Bq, D] (rows from Bq on are not read; 16-byte aligned for bf16), x
// [N,D] in the same dtype, valid [N] f32, scratch b1/b2 [groups,Bqp,block_n]
// int32 (group g sweeps tiles g*tiles_per_group ..; only rows below Bq are
// written and read), outputs out_s [Bq,k] f32 and out_i [Bq,k] int32. Bqp %
// 64 == 0 and Bqp >= Bq, N % block_n == 0, block_n % 16 == 0, block_n <=
// 1024, D % 16 == 0 (D <= 1024 for bf16), 1 <= k <= 256. A bf16 sweep of D
// <= 384 takes 128 queries a block once Bqp >= 128, else (and above 384)
// 64.
FRAG_EXPORT int frag_packed_topk(const void* q, const void* x, const float* valid, int* b1,
                                 int* b2, float* out_s, int* out_i, int Bq, int Bqp, int N,
                                 int D, int block_n, int bits, int k, int tiles_per_group,
                                 int dtype, void* stream) {
  if (Bq < 1 || Bqp < Bq || Bqp % 64 || block_n < 16 || block_n % 16 || block_n > 1024 ||
      N % block_n || D < 16 || D % 16 || k > kMaxK || k < 1 || tiles_per_group < 1 ||
      (dtype == FRAG_BF16 && (D > kLargeD || (reinterpret_cast<uintptr_t>(q) & 15) ||
                              (reinterpret_cast<uintptr_t>(x) & 15))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = N / block_n;
  const int groups = (ntiles + tiles_per_group - 1) / tiles_per_group;
  cudaError_t err;
  if (dtype == FRAG_BF16) {
    err = D > kWideD     ? launch_bf16_sweep<1, kLargeD>(q, x, valid, b1, b2, Bq, Bqp, N, D, block_n,
                                                         ntiles, bits, tiles_per_group, groups, st)
          : D > kNarrowD ? launch_bf16_sweep<1, kWideD>(q, x, valid, b1, b2, Bq, Bqp, N, D, block_n,
                                                        ntiles, bits, tiles_per_group, groups, st)
          : Bqp >= 128   ? launch_bf16_sweep<2, kNarrowD>(q, x, valid, b1, b2, Bq, Bqp, N, D, block_n,
                                                          ntiles, bits, tiles_per_group, groups, st)
                         : launch_bf16_sweep<1, kNarrowD>(q, x, valid, b1, b2, Bq, Bqp, N, D, block_n,
                                                          ntiles, bits, tiles_per_group, groups, st);
  } else {
    const dim3 grid(block_n / kF32Cols, Bqp / (kF32Warps * 16), groups);
    packed_sweep_f32_kernel<<<grid, kF32Warps * 32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(x), valid, b1, b2, Bq, Bqp, D,
        block_n, ntiles, bits, tiles_per_group);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  packed_merge_kernel<<<Bq, kMergeThreads, 0, st>>>(b1, b2, out_s, out_i, Bqp, block_n, ntiles,
                                                    bits, k, groups);
  return (int)cudaGetLastError();
}

// K2: fused bidirectional multi-head self-attention, forward.
//
// Replaces financial_rag_tpu/ops/flash_attention.py:flash_attention (line
// 28; the Pallas kernel _attn_kernel via _fwd_call, pallas_call at :94): q,
// k, v are [B,S,H] bf16 with the heads interleaved along H (head g owns
// columns g*D .. g*D+D-1, head_dim D = 32 for bge-small / gte-small /
// MiniLM, 64 for bge-base / gte-base), bias is an additive [B,S] f32 key
// bias (0 or -1e9), the output is [B,S,H] bf16. Scores, bias and softmax
// stay f32; P is rounded to bf16 (v's dtype) before P@V, as the TPU kernel
// does.
//
// Bound on the H100: per (batch row, head) the products are 4*S*L*D flops
// over its L live keys against 2*D bytes a row of q and out and of k and v,
// ~L/2 flop/byte at any D, so the bytes bound it below L ~ 600; and one
// exponential per score on the SFUs (16 a clock on each of 132 SMs) is a
// floor of about the same size at D = 32 and half the products' time at D =
// 64. At 12 heads of 64, over the live keys of chip_smoke.py's padded masks
// (its bound_ms): B=256 S=512 0.1784 ms of bytes, the products
// and the exponentials each about 0.10; B=68 S=512 (the wide ingest's
// batch) and B=256 S=128 bound by the bytes too; B=8 S=64 by the bytes,
// 0.0008 ms, far below one launch. The softmax arithmetic, not the tensor
// cores, sets the pace.
//
// attn_fwd_kernel (sm_90a; head_dim 32, and 64 at S <= 64), one template
// over D: a block takes 128 query rows of one (batch row, head): two
// consumer warpgroups of 64 rows and one producer warp (at S <= 64 one
// consumer warpgroup, so that more blocks share an SM). The producer streams
// 64-key tiles of K and V by cp.async into a ring of 4 stages, one head's
// 2*D-byte slice of each row in the swizzle of that width (64-byte rows at
// D = 32, 128-byte rows at D = 64; a K + V stage is 8 or 16 KB), with each
// tile's bias times log2(e) beside it, and publishes each stage through an
// mbarrier; the consumers release it through a second one. Per tile a
// consumer warpgroup runs S = Q K^T (wgmma m64n64k16, D/16 k-steps, Q and K
// K-major from shared memory), the online softmax in base 2 (log2(e)/sqrt(D)
// folded into one FMA with the bias, one ex2 per score), then O += P V
// (wgmma m64nDk16, P from registers as bf16, V [key][d] read MN-major
// through the transpose bit: nothing is transposed in memory; O is D/2
// registers a thread). The two warpgroups are not in lock step, so one's
// softmax runs while the other's products do, and two blocks share an SM
// (three at D = 64 and S <= 64, four at D = 32 and S <= 64). Every warp
// scans the row's bias itself (which tiles are live), so no block-wide
// barrier waits for the scan, and the producer starts the first tile's
// copies before it: at S <= 64, where a block's whole work is one tile, the
// scan, the Q copy and the K/V copy overlap.
//
// attn_fwd_d64_kernel (sm_90a; head_dim 64 above S = 64, the bge-base
// width's encodes). The design above, templated to D = 64, ran 0.52 ms at
// B=256 S=512 (34% of its bound): its cp.async producer spent 1,024 copies
// on a 64-key stage. This kernel keeps 64-key tiles, two consumer
// warpgroups of 64 rows and a producer warp, two blocks an SM, and changes
// the rest (a clock64 count of each phase guided it: a first TMA version,
// one item a block, waited ~8,900 cycles a block for its Q, 44% of a
// block's life at S = 128):
//  - Persistent blocks (2 an SM) walk items of 128 query rows of one
//    (batch row, head), in the order that puts an item's neighbours, which
//    read the same K and V, on other SMs at the same time. The producer
//    copies an item's Q into one of two buffers, so the next item's Q and
//    first tiles land while the current one is computed, and the K/V ring
//    (3 stages) runs on from one item into the next.
//  - Q, K and V come by TMA from 3-D tensor maps over [B][S][H] built for
//    every launch (boxes of one head's 64 columns, 128 bytes in SW128, by
//    128 query or 64 key rows; rows past S arrive as zeros, so no row of the
//    next batch row is read); one producer thread issues a stage's copies,
//    its 32 lanes write the tile's bias beside it, and after an item's last
//    tile a stage that holds no tile ends the consumers' walk (they scan
//    nothing themselves).
//  - The two warpgroups take turns (named barriers 3 and 4): one issues a
//    tile's Q K^T and passes the turn. Each thread keeps four partial
//    maxima and sums a row (short dependency chains).
//  - O goes out by TMA: each warpgroup writes its 64 rows as bf16 into a
//    swizzled staging tile and one thread stores the tile (rows past S are
//    not written), instead of 4-byte stores that write half of each 32-byte
//    sector (removing the stores altogether took 0.06 ms off 0.41).
// 96 registers, no spill. At B=256 S=512 it runs 0.376-0.381 ms of device
// time against the parent's 0.531 (kernel_ab.py, NVIDIA H100 80GB HBM3,
// 700.00 W): 47% of the bound, short of the 0.30 aimed at. A clock64 count
// of its phases (before the TMA stores) puts a 64-key tile of a warpgroup
// at ~3,200 cycles: ~1,260 of softmax, ~690 waiting for Q K^T, ~460 for P V,
// ~380 for the turn, ~370 for the tile; the four warpgroups of an SM issue
// at ~0.3 instructions a cycle each sub-partition: latency, which the
// in-warpgroup pipeline below would hide, but two blocks of 288 threads
// leave it 112 registers.
// Tried and dropped (kernel_ab.py device ms at B=256 S=512 against this
// design or its forerunner in the same call, NVIDIA H100 80GB HBM3, 700.00
// W; registers from ptxas -v):
//  - 128-key tiles, one block an SM (168 registers: S, O and P of a 128-key
//    tile): 0.6418-0.6425 against 64-key tiles' 0.4348-0.4351, without
//    turns 0.6148; one block an SM leaves each sub-partition two consumer
//    warps;
//  - no turns: 0.4068-0.4103 against 0.4076-0.4208, the same;
//  - 5 stages (not persistent): 0.4447-0.4503 against 0.4463-0.4629;
//  - the in-warpgroup pipeline (tile t's Q K^T and t-1's P V issued
//    together, t's softmax under that P V): 112 bytes spilled and the
//    wgmmas serialised (C7513), 0.4679-0.4791 against 0.3833-0.4055.
//
// Dead key tiles are skipped, exactly. A key is dead when its bias times
// log2(e) lies more than 2^20 below the batch row's largest (Mb); a tile whose
// keys are all dead or past S is never loaded (in attn_fwd_d64_kernel every
// tile but tile 0, which is always walked). Whenever |q.k| * log2(e) /
// sqrt(D) < 2^18 (any real activation: |q.k| < 2^18 * sqrt(D) / log2(e),
// about 1.03e6 at D = 32 and 1.45e6 at D = 64), every dead score sits more
// than 2^19 below the row's final maximum, which is at least the score of
// the key holding Mb: its ex2 is exactly 0, it never moves the running
// maximum, and alpha is exactly 1 past it, so the output is the same to the
// bit as with every tile walked. A walked tile 0 whose keys are all dead
// leaves its sums behind with the first live tile's alpha, which is
// exactly 0 (2^-(2^19) flushes to 0). The key holding Mb is never dead, so
// a row with no live key (all bias -1e9: every key ties at Mb) walks every
// tile and, its scores rounding to the same f32 value, gets the mean of v
// over the S keys, as the plain version and the TPU kernel give. Keys past
// S get -inf.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTile = 64;                          // query rows per warpgroup, keys per tile
constexpr int kStages = 4;
constexpr float kDeadGap = 1048576.f;              // 2^20, in units of log2

// One head's slice of a row: D bf16 = 2*D bytes in the swizzle of that width
// (hopper.cuh).
template <int D>
using Head = HeadTile<D>;
static_assert(Head<32>::kRows == kTile, "a staged tile is 64 rows");

// A block of NC consumer warpgroups (64 query rows each) and a producer warp.
template <int NC, int D>
struct Block {
  static constexpr int kRows = kTile * NC;
  static constexpr int kThreads = NC * 128 + 32;
  static constexpr int kSmemBytes = (NC + 2 * kStages) * Head<D>::kTileBytes + 1024;  // + alignment
  // blocks an SM holds: by registers at D = 32 (shared memory allows more);
  // by shared memory at D = 64 (73 / 81 KB a block)
  static constexpr int kMinBlocks = D == 32 ? 4 / NC : (NC == 1 ? 3 : 2);
};

// This lane's two keys of key tile kt (kt*64 + lane, +32): bias * log2(e),
// -inf past S.
__device__ __forceinline__ void tile_bias(const float* __restrict__ brow, int kt, int S, int lane,
                                          float& b0, float& b1) {
  const int j = kt * kTile + lane;
  b0 = j < S ? brow[j] * kLog2e : -INFINITY;
  b1 = j + 32 < S ? brow[j + 32] * kLog2e : -INFINITY;
}

// Whether a key of the tile is live (bias within 2^20 of the row's largest).
__device__ __forceinline__ bool tile_live(float b0, float b1, float mb) {
  return __any_sync(0xffffffffu, b0 >= mb - kDeadGap || b1 >= mb - kDeadGap);
}

// The row's largest bias * log2(e), on every lane of the warp.
__device__ __forceinline__ float row_bias_max(const float* __restrict__ brow, int S, int lane) {
  float mb = -INFINITY;
  for (int i = lane; i < S; i += 32) mb = fmaxf(mb, brow[i] * kLog2e);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
  return mb;
}

// Key tile kt of one head's K and V (rows past S zero-filled) into the stage
// at ks (K, then V), by the 32 lanes of one warp.
template <int D>
__device__ __forceinline__ void load_kv(uint32_t ks, const __nv_bfloat16* __restrict__ k,
                                        const __nv_bfloat16* __restrict__ v, size_t base, int kt,
                                        int S, int H, int lane) {
  using Hd = Head<D>;
  const int k0 = kt * kTile;
  for (int e = lane; e < kTile * Hd::kChunks; e += 32) {
    const int r = e >> Hd::kChunkBits, ch = e & (Hd::kChunks - 1);
    const bool ok = k0 + r < S;
    const size_t src = base + (size_t)(ok ? k0 + r : 0) * H + 8 * ch;
    cp_async16(ks + Hd::at(r, ch), k + src, ok);
    cp_async16(ks + Hd::kTileBytes + Hd::at(r, ch), v + src, ok);
  }
}

template <int NC, int D>
__global__ void __launch_bounds__(Block<NC, D>::kThreads, Block<NC, D>::kMinBlocks)
attn_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                __nv_bfloat16* __restrict__ out, int S, int H, float c) {
  using Hd = Head<D>;
  constexpr int kTileBytes = Hd::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ __align__(16) float bias_s[kStages][kTile];  // a tile's key bias * log2(e)
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sRing = sQ + NC * kTileBytes;  // stage st: K, then V

  const int b = blockIdx.z;
  const int q0 = blockIdx.x * Block<NC, D>::kRows;
  const int consumers = min(NC, (S - q0 + kTile - 1) / kTile);  // warpgroups with a row < S
  const size_t base = (size_t)b * S * H + (size_t)blockIdx.y * D;
  const float* brow = bias + (size_t)b * S;
  const int nkt = (S + kTile - 1) / kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool producer = warp == NC * 4;
  const int w = warp >> 2;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 32);                 // every producer lane, once its copies landed
      mbar_init(&empty[st], consumers * 128);   // every consumer thread, once its products ended
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (producer) {
    // tile 0 into stage 0 before the scan; should tile 0 be dead, the first
    // live tile waits for these copies before it takes stage 0
    load_kv<D>(sRing, k, v, base, 0, S, H, lane);
    cp_async_commit();
    const float mb = row_bias_max(brow, S, lane);
    // live tile t into stage t % kStages, published one tile late so that two
    // tiles' copies are in flight, and always before it blocks on a stage that
    // a consumer has yet to release
    int published = 0, t = 0;
    auto publish = [&](auto wait_groups) {
      wait_groups();
      fence_proxy_async();
      mbar_arrive(&full[published % kStages]);
      ++published;
    };
    for (int kt = 0; kt < nkt; ++kt) {
      float b0, b1;
      tile_bias(brow, kt, S, lane, b0, b1);
      if (!tile_live(b0, b1, mb)) continue;
      const int st = t % kStages;
      if (t >= kStages) {
        if (published < t) publish([] { cp_async_wait<0>(); });
        mbar_wait(&empty[st], (t / kStages - 1) & 1);
      }
      if (kt > 0) {  // tile 0's copies were issued before the scan
        if (t == 0) cp_async_wait<0>();
        load_kv<D>(sRing + st * 2 * kTileBytes, k, v, base, kt, S, H, lane);
        cp_async_commit();
      }
      bias_s[st][lane] = b0;
      bias_s[st][lane + 32] = b1;
      if (published < t) publish([] { cp_async_wait<1>(); });
      ++t;
    }
    if (published < t) publish([] { cp_async_wait<0>(); });
    return;
  }
  if (w >= consumers) return;

  // this warpgroup's 64 query rows, zeros past S
  const uint32_t qt = sQ + w * kTileBytes;
  for (int e = threadIdx.x & 127; e < kTile * Hd::kChunks; e += 128) {
    const int r = e >> Hd::kChunkBits, ch = e & (Hd::kChunks - 1), row = q0 + w * kTile + r;
    const bool ok = row < S;
    cp_async16(qt + Hd::at(r, ch), q + base + (size_t)(ok ? row : 0) * H + 8 * ch, ok);
  }
  cp_async_commit();
  // the number of live tiles, counted as the producer counts them, while Q lands
  int n = 0;
  {
    const float mb = row_bias_max(brow, S, lane);
    for (int kt = 0; kt < nkt; ++kt) {
      float b0, b1;
      tile_bias(brow, kt, S, lane, b0, b1);
      n += tile_live(b0, b1, mb);
    }
  }
  cp_async_wait<0>();
  fence_proxy_async();
  named_barrier(1 + w, 128);

  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = q0 + w * kTile + 16 * (warp & 3) + gid;  // this thread's rows: row0, row0+8
  float o[D / 2], s[32];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m: base-2 scores with bias
  for (int t = 0; t < n; ++t) {
    const int st = t % kStages;
    mbar_wait(&full[st], (t / kStages) & 1);
    const uint32_t ks = sRing + st * 2 * kTileBytes, vs = ks + kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, Hd::kmajor(qt, kk), Hd::kmajor(ks, kk), kk > 0);
    wgmma_commit();
    float2 bb[8];  // this thread's 16 key columns: 8*j + 2*tig, +1
#pragma unroll
    for (int j = 0; j < 8; ++j) bb[j] = *reinterpret_cast<const float2*>(&bias_s[st][8 * j + 2 * tig]);
    wgmma_wait<0>();
    fence_acc(s);

    // online softmax in base 2; each row's 64 scores live in the 4 threads of
    // a quad. The visited tile holds a key < S, so m is finite from here on.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = fmaf(s[i], c, (i & 1) ? bb[i >> 2].y : bb[i >> 2].x);
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = ex2(s[i] - m[r]);
      l[r] += s[i];
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(pa[kk], s, kk);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_head<D>(o, pa[kk], Hd::mnmajor(vs, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float inv = 1.f / quad_sum(l[r]);
    if (row >= S) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)row * H + 8 * nt + 2 * tig) =
          pack_bf16(o[4 * nt + 2 * r] * inv, o[4 * nt + 2 * r + 1] * inv);
  }
}

// ---- head_dim 64 above S = 64 (bge-base, gte-base) ------------------------
// Persistent blocks of two consumer warpgroups (64 query rows each) and a
// producer warp; an item is 128 query rows of one (batch row, head). Q by
// TMA into one of two buffers, 64-key tiles of K and V by TMA into a ring
// that runs on from one item into the next, O out by TMA from a staging
// tile of each warpgroup.
struct Wide {
  static constexpr int kKeys = 64;                  // a K/V tile's keys
  static constexpr int kConsumers = 2;
  static constexpr int kRows = kTile * kConsumers;  // an item's query rows
  static constexpr int kThreads = kConsumers * 128 + 32;
  static constexpr int kStages = 3;
  static constexpr int kQBuffers = 2;
  static constexpr int kQBytes = kRows * 128;       // an item's rows, 128 bytes each
  static constexpr int kKvBytes = kKeys * 128;      // one K or V tile
  static constexpr int kStageBytes = 2 * kKvBytes;  // K, then V
  static constexpr int kOutBytes = kRows * 128;     // the warpgroups' O staging tiles
  static constexpr int kSmemBytes = kQBuffers * kQBytes + kStages * kStageBytes + kOutBytes + 1024;  // + alignment
  static constexpr int kMinBlocks = 2;              // blocks an SM: 96 registers a thread
};
constexpr int kTurnBarrier = 3;      // named barriers 3, 4: warpgroup 0's, 1's turn

// This lane's 2 keys of key tile kt (kt*64 + lane + 32*i): bias * log2(e),
// -inf past S; returns whether a key of the tile is live.
__device__ __forceinline__ bool wide_tile_bias(const float* __restrict__ brow, int kt, int S,
                                               int lane, float mb, float (&bk)[Wide::kKeys / 32]) {
  bool live = false;
#pragma unroll
  for (int i = 0; i < Wide::kKeys / 32; ++i) {
    const int j = kt * Wide::kKeys + lane + 32 * i;
    bk[i] = j < S ? brow[j] * kLog2e : -INFINITY;
    live |= bk[i] >= mb - kDeadGap;
  }
  return __any_sync(0xffffffffu, live);
}

// Item i of a launch: query rows 128 * (i % nqb) .., head (i / nqb) % heads,
// batch row i / (nqb * heads); consecutive items share K and V in L2.
struct WideItem {
  int q0, head, b;
  __device__ WideItem(int i, int nqb, int heads)
      : q0((i % nqb) * kTile * 2), head((i / nqb) % heads), b(i / (nqb * heads)) {}
};

__global__ void __launch_bounds__(Wide::kThreads, Wide::kMinBlocks)
attn_fwd_d64_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                    const float* __restrict__ bias, int S, int heads, int items, float c) {
  using W = Wide;
  constexpr int D = 64, kKeys = W::kKeys, kStages = W::kStages, kN = kKeys / 2;  // kN: S registers a thread
  using Hd = Head<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages], q_full[W::kQBuffers], q_empty[W::kQBuffers];
  __shared__ __align__(16) float bias_s[kStages][kKeys];  // a tile's key bias * log2(e)
  __shared__ int last_s[kStages];  // whether the stage ends an item's walk (holds no tile)
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;  // buffer i at sQ + i * kQBytes
  const uint32_t sRing = sQ + W::kQBuffers * W::kQBytes;    // stage st: K, then V
  const uint32_t sOut = sRing + kStages * W::kStageBytes;   // warpgroup w's O at sOut + w * 8 KB

  const int nqb = (S + W::kRows - 1) / W::kRows, nkt = (S + kKeys - 1) / kKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 32);                 // every producer lane (its bias), then the tile's bytes
      mbar_init(&empty[st], W::kConsumers * 4);  // lane 0 of every consumer warp
    }
    for (int i = 0; i < W::kQBuffers; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], W::kConsumers * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == W::kConsumers * 4) {
    // producer: for each item its Q, then its walked tiles, each into stage
    // t % kStages (t counts on over the items) with its bias by the 32 lanes
    // and its K and V by one TMA copy each (rows past S arrive as zeros);
    // after an item's last tile, a stage that holds no tile ends its walk
    int t = 0, it = 0;
    auto publish = [&](const WideItem& x, int kt, const float (&bk)[kKeys / 32]) {
      const int st = t % kStages;
      if (t >= kStages) mbar_wait(&empty[st], (t / kStages - 1) & 1);
#pragma unroll
      for (int i = 0; i < kKeys / 32; ++i) bias_s[st][lane + 32 * i] = bk[i];
      if (lane == 0) last_s[st] = kt < 0;
      if (kt < 0) {
        mbar_arrive(&full[st]);
      } else if (lane == 0) {
        mbar_expect_tx(&full[st], W::kStageBytes);
        const uint32_t ks = sRing + st * W::kStageBytes;
        tma_load_3d(ks, &tm_k, x.head * D, kt * kKeys, x.b, &full[st]);
        tma_load_3d(ks + W::kKvBytes, &tm_v, x.head * D, kt * kKeys, x.b, &full[st]);
      } else {
        mbar_arrive(&full[st]);
      }
      ++t;
    };
    if (lane == 0) {
      prefetch_tensor_map(&tm_q);
      prefetch_tensor_map(&tm_k);
      prefetch_tensor_map(&tm_v);
    }
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
      const WideItem x(item, nqb, heads);
      const float* brow = bias + (size_t)x.b * S;
      const int qb = it % W::kQBuffers;
      if (it >= W::kQBuffers) mbar_wait(&q_empty[qb], (it / W::kQBuffers - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(&q_full[qb], W::kQBytes);
        tma_load_3d(sQ + qb * W::kQBytes, &tm_q, x.head * D, x.q0, x.b, &q_full[qb]);
      }
      // tile 0 is always walked (header), so its copies start before the scan
      float bk[kKeys / 32];
      wide_tile_bias(brow, 0, S, lane, -INFINITY, bk);
      publish(x, 0, bk);
      const float mb = row_bias_max(brow, S, lane);
      for (int kt = 1; kt < nkt; ++kt)
        if (wide_tile_bias(brow, kt, S, lane, mb, bk)) publish(x, kt, bk);
      publish(x, -1, bk);
    }
    return;
  }
  // the warpgroup, broadcast so that the compiler knows it is uniform
  const int w = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int gid = lane >> 2, tig = lane & 3;
  const bool issuer = (threadIdx.x & 127) == 0;  // this warpgroup's O stores
  const uint32_t ot = sOut + w * Hd::kTileBytes;
  if (issuer) prefetch_tensor_map(&tm_o);
  float o[D / 2], s[kN];
  uint32_t p[kKeys / 16][4];
  // the two warpgroups take turns: one issues a tile's S = Q K^T on its
  // turn and passes it, so its softmax runs while the other's products do;
  // warpgroup 0 goes first. Both walk every item's tiles (warpgroup 1 on
  // rows of zeros where the item has no row 64 .. 127 below S).
  if (w == 1) named_barrier_arrive(kTurnBarrier, 2 * 128);
  int t = 0, it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    const WideItem x(item, nqb, heads);
    const int qb = it % W::kQBuffers;
    const uint32_t qt = sQ + qb * W::kQBytes + w * Hd::kTileBytes;
    mbar_wait(&q_full[qb], (it / W::kQBuffers) & 1);
    zero(o);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m: base-2 scores with bias
    for (;; ++t) {
      const int st = t % kStages;
      const uint32_t ks = sRing + st * W::kStageBytes, vs = ks + W::kKvBytes;
      mbar_wait(&full[st], (t / kStages) & 1);
      if (__any_sync(0xffffffffu, last_s[st])) {  // (warp-uniform to the compiler)
        if (lane == 0) mbar_arrive(&empty[st]);
        ++t;
        break;
      }
      named_barrier(kTurnBarrier + w, 2 * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(s, Hd::kmajor(qt, kk), make_desc(ks + 32 * kk, 16, 1024, kSw128), kk > 0);
      wgmma_commit();
      named_barrier_arrive(kTurnBarrier + (w ^ 1), 2 * 128);
      float2 bb[kKeys / 8];  // this thread's key columns: 8*j + 2*tig, +1
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) bb[j] = *reinterpret_cast<const float2*>(&bias_s[st][8 * j + 2 * tig]);
      wgmma_wait<0>();
      fence_acc(s);

      // online softmax in base 2; each row's kKeys scores live in the 4
      // threads of a quad, and a thread keeps four partial maxima and sums a
      // row (short dependency chains). Tile 0 holds key 0 < S, so m is
      // finite from here on.
      float mx[2][4], ls[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) mx[r][g] = -INFINITY, ls[r][g] = 0.f;
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        s[i] = fmaf(s[i], c, (i & 1) ? bb[i >> 2].y : bb[i >> 2].x);
        mx[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(mx[(i >> 1) & 1][(i >> 2) & 3], s[i]);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_tile = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
        const float m_new = fmaxf(m[r], quad_max(m_tile));
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = ex2(s[i] - m[r]);
        ls[r][(i >> 2) & 3] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], (ls[r][0] + ls[r][1]) + (ls[r][2] + ls[r][3]));
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) pack_a(p[kk], s, kk);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      // O += P V (P from registers, V [key][d] MN-major through the transpose bit)
      fence_acc(o);  // the rescaled O and P are written before the fence (else ptxas adds one)
      fence_frag(p);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_rs_n64(o, p[kk], make_desc(vs + kk * 16 * 128, W::kKvBytes, 1024, kSw128));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    if (lane == 0) mbar_arrive(&q_empty[qb]);  // this item's Q is read no more

    // O / l as bf16 into the staging tile once the last item's store has
    // read it, then one TMA store of the tile (rows past S are not written)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / quad_sum(l[r]);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) o[4 * i + 2 * r] *= inv, o[4 * i + 2 * r + 1] *= inv;
    }
    if (issuer) bulk_wait_read<0>();
    named_barrier(1 + w, 128);
    stage_rows_sw128(ot, 16 * (warp & 3) + gid, tig, o, 1.f);
    fence_proxy_async();
    named_barrier(1 + w, 128);
    if (issuer) {
      tma_store_3d(&tm_o, ot, x.head * D, x.q0 + w * kTile, x.b);
      bulk_commit();
    }
  }
  // warpgroup 1's opening arrive is the one turn of warpgroup 0's left over
  if (w == 0) named_barrier(kTurnBarrier, 2 * 128);
  if (issuer) bulk_wait<0>();
}

template <int NC, int D>
int launch(const void* q, const void* k, const void* v, const float* bias, void* out, int B,
           int S, int H, int num_heads, float c, cudaStream_t st) {
  using Blk = Block<NC, D>;
  if constexpr (Blk::kSmemBytes > 48 * 1024) {
    // above 48 KB of dynamic shared memory a kernel must opt in, on each
    // device it runs on (the attribute is the current device's)
    const cudaError_t opt_in = cudaFuncSetAttribute(
        attn_fwd_kernel<NC, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Blk::kSmemBytes);
    if (opt_in != cudaSuccess) return (int)opt_in;
  }
  const dim3 grid((S + Blk::kRows - 1) / Blk::kRows, num_heads, B);
  attn_fwd_kernel<NC, D><<<grid, Blk::kThreads, Blk::kSmemBytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, static_cast<__nv_bfloat16*>(out), S, H, c);
  return (int)cudaGetLastError();
}

template <int D>
int launch_head(const void* q, const void* k, const void* v, const float* bias, void* out, int B,
                int S, int H, int num_heads, cudaStream_t st) {
  const float c = (float)(1.4426950408889634 / sqrt((double)D));
  return S <= kTile ? launch<1, D>(q, k, v, bias, out, B, S, H, num_heads, c, st)
                    : launch<2, D>(q, k, v, bias, out, B, S, H, num_heads, c, st);
}

// head_dim 64: the one-warpgroup block of attn_fwd_kernel at S <= 64, else
// attn_fwd_d64_kernel, two persistent blocks an SM, its Q, K and V read
// through 3-D tensor maps over [B][S][H] (boxes of one head's 64 columns,
// 128 bytes in SW128, by rows: 128 query rows, 64 keys; rows past S
// arrive as zeros)
int launch_d64(const void* q, const void* k, const void* v, const float* bias, void* out, int B,
               int S, int H, int num_heads, cudaStream_t st) {
  const float c = (float)(1.4426950408889634 / sqrt((double)64));
  if (S <= kTile) return launch<1, 64>(q, k, v, bias, out, B, S, H, num_heads, c, st);
  using W = Wide;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  const uint64_t dims[3] = {(uint64_t)H, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)H * 2, (uint64_t)S * H * 2};
  const uint32_t box_q[3] = {64, (uint32_t)W::kRows, 1}, box_kv[3] = {64, (uint32_t)W::kKeys, 1};
  const uint32_t box_o[3] = {64, (uint32_t)kTile, 1};
  if (!tensor_map_3d(&tm_q, q, dims, strides, box_q, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map_3d(&tm_k, k, dims, strides, box_kv, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map_3d(&tm_v, v, dims, strides, box_kv, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map_3d(&tm_o, out, dims, strides, box_o, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  static std::atomic<int> sm_counts[kMaxDevices];
  const int sms = opted_sm_count(attn_fwd_d64_kernel, W::kSmemBytes, sm_counts);
  if (sms < 0) return -sms;
  const int items = (S + W::kRows - 1) / W::kRows * num_heads * B;
  attn_fwd_d64_kernel<<<min(items, W::kMinBlocks * sms), W::kThreads, W::kSmemBytes, st>>>(
      tm_q, tm_k, tm_v, tm_o, bias, S, num_heads, items, c);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v/out [B,S,H] bf16 (H = num_heads * head_dim, head_dim 32 or 64),
// 16-byte aligned; bias [B,S] f32.
FRAG_EXPORT int frag_flash_attention(const void* q, const void* k, const void* v,
                                     const float* bias, void* out, int B, int S, int H,
                                     int num_heads, void* stream) {
  if (num_heads < 1 || H % num_heads || S < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H / num_heads) {
    case 32: return launch_head<32>(q, k, v, bias, out, B, S, H, num_heads, st);
    case 64: return launch_d64(q, k, v, bias, out, B, S, H, num_heads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

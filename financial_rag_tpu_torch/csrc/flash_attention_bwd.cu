// K10: fused bidirectional multi-head self-attention, backward.
//
// Replaces financial_rag_tpu/ops/flash_attention.py:_flash_bwd (line 55;
// the Pallas kernel _attn_bwd_kernel, pallas_call at :124): q, k, v and
// dout are [B,S,H] bf16 with the heads interleaved along H (head g owns
// columns g*D .. g*D+D-1, head_dim D = 32 for bge-small / gte-small /
// MiniLM, 64 for bge-base / gte-base), bias is the additive [B,S] f32 key
// bias of the forward (0 or -1e9), and dq, dk, dv are [B,S,H] bf16. It recomputes the probabilities from q, k and the bias
// (the forward saves neither P nor its output) and applies
//     dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),  D = rowsum(dP o P),
//     dQ = dS K * scale,  dK = dS^T Q * scale
// with the TPU kernel's rounding points: scores, P, dP, dS and D in f32 (D
// from the unrounded P, not from the forward's bf16 output); P^T and dS
// rounded to bf16 before the products that take them; f32 accumulation.
//
// Bound on the H100 at a full mask (per (batch row, head): 7*S*2*D bytes of
// q, k, v, dO, dq, dk, dv; 5 products of 2*S*S*D flops; exps per score), B=256,
// 12 heads (chip_smoke.py's bound counts the live keys of its padded masks,
// about half, where the bytes bind at every S):
//   head_dim 32. S = 32, 64, 128 (the train path): the bytes (S=128: 0.053
//     ms against 0.016 ms of tensor work and 0.024 ms of exps at 2 per
//     score, 16 a clock on each of 132 SMs); S = 512: the exps (3 per score
//     there, 0.58 ms; tensor work 0.26 ms, bytes 0.21 ms).
//   head_dim 64. S = 128: the bytes (352.5 MB, 0.105 ms, against 0.033 ms of
//     tensor work and the same 0.024 ms of exps); S = 512: the exps (0.58
//     ms; tensor work 0.52 ms, bytes 0.42 ms).
//
// Two kernels (sm_90a; head_dim 32, and 64 above S = 128), one template
// over D in {32, 64}: 128 threads (one warpgroup) per block, on a grid of
// (64-row tile, head, batch row); every product is a wgmma m64nNk16 from shared-memory tiles of one
// head's rows in the swizzle of its width (hopper.cuh's HeadTile: 64-byte
// rows in SW64 at D = 32, 128-byte rows in SW128 at D = 64; a tile stored
// [row][head_dim] is K-major for Q K^T, D/16 k-steps, and, with the
// transpose bit, MN-major for dS K and P^T dO, N = D: nothing is transposed
// in memory). Operand tiles arrive by cp.async into a 3-stage ring while
// the previous tile is multiplied. Scores are exp2 with log2(e)*scale
// folded into one FMA; each row multiplies by 1/l once.
//   1. attn_bwd_dq_kernel, per 64-query tile, Q and dO resident. Where the
//      row fits in registers (S <= 128, the whole train path) its key tiles
//      are walked once: S = QK^T and dP = dO V^T stay in registers, the
//      row's max, sum and D follow, then dS and dQ = dS K: 3 products and
//      one exp per score. Longer rows walk twice (max, sum and D online,
//      then dS and dQ): 5 products, 2 exps. It writes each row's
//      log-sum-exp and D to a [2,B,heads,S] f32 scratch.
//   2. attn_bwd_dkdv_kernel, per 64-key tile, K and V resident; a walk over
//      query tiles: S^T = K Q^T, dP^T = V dO^T, P^T from the scratch's
//      log-sum-exp (one exp per score), dS^T, dV += P^T dO, dK += dS^T Q:
//      4 products.
// A thread holds D/2 f32 of each D-wide accumulator (dQ; dK and dV): 16 at
// D = 32, 32 at D = 64, beside the 64-key tiles' 32 of S and of dP (two key
// tiles of each in the dQ kernel's one-walk case). A block's shared memory
// is the two resident tiles and 3 ring stages of two tiles and a query
// tile's statistics: 34.5 KB at D = 32, 66.5 KB at D = 64 (above 48 KB, so
// the launch opts in); by shared memory 6 or 3 blocks fit an SM's 227 KB,
// and the registers (at most 255 a thread, 128 threads) allow at least 2.
// Nothing crosses blocks except the scratch, so there are no atomics and the
// result is bit-identical from run to run. Keys past S get bias -inf;
// queries past S get log-sum-exp +inf and D 0, so they add exact zeros.
// The log-sum-exp is stored relative to the batch row's largest key bias
// M: a fully masked row (every real score rounds to -1e9 * log2(e)) then
// keeps log2(#real keys) instead of losing it to f32 rounding next to 1e9,
// and gets the uniform P over the real keys, as the plain version and the
// TPU do. Any S >= 1; the rounding points, the masked-row rule and the
// scratch do not depend on D. At D = 64 (S > 128: K2's table shape) both
// kernels skip dead key tiles, as K2 does (flash_attention.cu): a key is
// dead when its bias times log2(e) lies more than 2^20 below the batch
// row's largest; the dQ kernel never loads a tile of dead keys (it lists the
// live ones, up to S = 4,096, and walks every tile beyond), and a dK/dV
// block whose 64 keys are all dead writes exact zeros and loads nothing.
// Their probabilities are exactly 0 (2^-(2^19) flushes to 0), so dq is the
// same to the bit and dk, dv of dead keys are the zeros the walk gives. At
// B=256 S=512 on a padded mask that took the pair from 3.28-3.53 ms to
// 2.03 (SDPA's backward: 2.56); on a full mask it stays 3.25-3.45.
//
// attn_bwd_fused_d64_kernel (sm_90a; head_dim 64, S <= 128: every K10
// launch of the train paths, S = 128, 100 and 64, and K11's local shapes).
// The two kernels templated to D = 64 ran 0.2747 ms at B=256 S=128, 2.7x
// its bound: 11 tensor passes (both kernels read Q, K, V and dO; a scratch
// joins them) against the 7 the bound counts, every key tile walked, and
// one warpgroup a block, each product waiting for the one before. This
// kernel is one launch; a block (two warpgroups, 256 threads, one an SM,
// persistent) owns one (batch row, head) at a time:
//  - Q, K, V and dO arrive by TMA, one 64-row box a tile (16 KB a tensor at
//    S = 128; rows past S are zeros), into one of two buffers: thread 0
//    copies the next item's inputs while the current one is worked on, and
//    each lane loads the next item's key bias into registers a step ahead.
//  - Phase 1, warpgroup w for query tile w: S = Q K^T and dP = dO V^T over
//    the key tiles walked (one m64n128 or m64n64 product each), the row's
//    max, sum and D = rowsum(dP o P) in registers (four partial sums a
//    row), P and dS = P o (dP - D) as bf16 into [query][key] tiles in
//    shared memory, and dQ = dS K from registers.
//  - Phase 2, warpgroup w for key tile w (at S <= 64: warpgroup 0 dV,
//    warpgroup 1 dK): dV = P^T dO and dK = dS^T Q, A and B both read from
//    shared memory through their transpose bits: nothing is transposed in
//    device memory.
//  - Key tile 1 is walked only if it holds a live key (tile 0 holds the
//    row's largest bias unless tile 1 does); a dead tile 1's dk and dv are
//    exact zeros, and its probabilities, exactly 0, change no sum.
//  - dq, dk and dv go out by TMA from bf16 staging tiles (dq its own; dk and
//    dv in the K and V tiles, read no more), whole 128-byte rows: 4-byte
//    stores, half of each 32-byte sector, had taken half the kernel's time
//    (removing them took 0.2227 ms to 0.1189).
//  - No scratch, no atomics: each tensor is read and written once, and the
//    bits are the same from run to run. The row's max and sum stay in
//    registers, so a fully masked row (every real score rounding to the same
//    value next to -1e9 * log2(e)) gets the uniform P over the real keys,
//    as the log-sum-exp relative to the largest bias gives the two kernels.
//  - Which products a warpgroup issues is fixed at compile time, the
//    warpgroup index is broadcast with __shfl_sync, and the zeroed
//    accumulators and packed fragments are pinned before the wgmma fence:
//    else ptxas serialises the wgmmas (C7520, a branch it cannot prove
//    uniform; C7519, an arrive it injects).
// 194 registers, no spill; 214,016 bytes of shared memory. Device time
// (kernel_ab.py, NVIDIA H100 80GB HBM3, 700.00 W, against the parent's two
// kernels in the same call): B=256 S=128 0.1385-0.1395 ms (0.2773-0.2776;
// 76% of the 0.1052 bound), S=100 0.1278-0.1311 (0.2443-0.2445), S=64
// 0.0743 (0.1110-0.1116), K11's local 6 and 3 heads 0.0124-0.0127
// (0.0264-0.0265).
// Tried and dropped (device ms at B=256 S=128 unless named):
//  - one block an item (not persistent): 0.2471-0.2473 against
//    0.2547-0.2638, but S=64 0.1433 against 0.1122-0.1131;
//  - ex2.approx for exp2f: the same bits and time;
//  - before the fixes above, a clock64 count per item and warp: ~5,100
//    cycles reading the bias, ~7,200 in phase 1, ~6,000 in phase 2 (its
//    wgmmas serialised); 0.2646-0.2712 ms.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTile = 64;                 // rows per block and per staged tile
constexpr int kThreads = 128;             // one warpgroup
constexpr int kStages = 3;
constexpr int kStatBytes = 2 * kTile * 4;          // a query tile's log-sum-exp and D

// The shared-memory layout at head width D: two resident tiles, then the
// ring's stages of two operand tiles each, then (dK/dV kernel) each stage's
// query statistics.
template <int D>
struct Layout {
  using Hd = HeadTile<D>;
  static_assert(Hd::kRows == kTile, "a staged tile is 64 rows");
  static constexpr int kTileBytes = Hd::kTileBytes;   // 64 rows of 64 or 128 bytes
  static constexpr int kStageBytes = 2 * kTileBytes;  // two operand tiles a stage
  static constexpr int kSmemBytes = 2 * kTileBytes + kStages * (kStageBytes + kStatBytes) + 1024;  // + alignment
  static constexpr int kMaxResident = 2;              // key tiles of a row held in registers
  static_assert(kMaxResident <= kStages - 1, "the ring prologue must fetch every resident tile");
};

// Rows [r0, r0+64) of one head of a [B,S,H] bf16 tensor into a swizzled
// HeadTile<D> at `dst`; rows past S are zeros.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* __restrict__ src,
                                          size_t base, int r0, int S, int H) {
  using Hd = HeadTile<D>;
  for (int e = threadIdx.x; e < kTile * Hd::kChunks; e += kThreads) {
    const int r = e >> Hd::kChunkBits, c = e & (Hd::kChunks - 1);
    const bool ok = r0 + r < S;
    cp_async16(dst + Hd::at(r, c), src + base + (size_t)(ok ? r0 + r : 0) * H + 8 * c, ok);
  }
}

// The largest key bias of the batch row, times log2(e), on every thread.
__device__ __forceinline__ float bias_max(const float* __restrict__ brow, int S) {
  __shared__ float red[kThreads / 32];
  float mx = -INFINITY;
  for (int i = threadIdx.x; i < S; i += kThreads) mx = fmaxf(mx, brow[i] * kLog2e);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) mx = fmaxf(mx, red[w]);
  return mx;
}

// The cp.async ring: tile t of `nloads` goes to stage t % kStages. The
// prologue fetches tiles 0 .. kStages-2; acquire(t) waits for tile t, makes
// it visible to wgmma, and refills the stage of tile t-1, which every
// thread finished reading before the barrier.
template <typename Fetch>
__device__ __forceinline__ void ring_prologue(Fetch fetch, int nloads) {
#pragma unroll
  for (int t = 1; t < kStages - 1; ++t) {
    if (t < nloads) fetch(t);
    cp_async_commit();
  }
}
template <typename Fetch>
__device__ __forceinline__ void ring_acquire(Fetch fetch, int t, int nloads) {
  cp_async_wait<kStages - 2>();
  fence_proxy_async();
  __syncthreads();
  if (t + kStages - 1 < nloads) fetch(t + kStages - 1);
  cp_async_commit();
}

constexpr float kDeadGap = 1048576.f;  // 2^20 in units of log2: a key this far below the row's largest bias is dead
constexpr int kMaxListed = 64;         // key tiles the dQ kernel lists (S <= 4,096); beyond, every tile is walked

// The live key tiles of the batch row (a key of the tile within kDeadGap of
// the row's largest bias * log2(e), mb), in order, into list[0 ..); returns
// their number. Above kMaxListed tiles every tile counts as live and the
// list is not written. Every thread of the block calls it.
__device__ __forceinline__ int live_tiles(const float* __restrict__ brow, int S, float mb, int* list) {
  const int nkt = (S + kTile - 1) / kTile;
  if (nkt > kMaxListed) return nkt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int kt = warp; kt < nkt; kt += kThreads / 32) {
    const int j = kt * kTile + lane;
    const bool live = (j < S && brow[j] * kLog2e >= mb - kDeadGap) ||
                      (j + 32 < S && brow[j + 32] * kLog2e >= mb - kDeadGap);
    const bool any = __any_sync(0xffffffffu, live);
    if (lane == 0) list[kt] = any;
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // compact in place: entry n <= kt is written after flag kt is read
    int n = 0;
    for (int kt = 0; kt < nkt; ++kt)
      if (list[kt]) list[n++] = kt;
    list[kMaxListed] = n;
  }
  __syncthreads();
  return list[kMaxListed];
}

// f32 accumulator [64 x D] * scale -> bf16 rows row0, row0+8 of one head
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out, size_t base, int row0, int S,
                                           int H, int tig, const float (&c)[D / 2], float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)row * H + 8 * nt + 2 * tig) =
          pack_bf16(c[4 * nt + 2 * r] * scale, c[4 * nt + 2 * r + 1] * scale);
  }
}

// kResident > 0: the row's key tiles (at most kResident) are walked once
// and held in registers; kResident == 0: two walks over any number of tiles.
template <int D, int kResident>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                   const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
                   float* __restrict__ stats, int S, int H, float c, float scale) {
  using Hd = HeadTile<D>;
  constexpr int kTileBytes = Layout<D>::kTileBytes, kStageBytes = Layout<D>::kStageBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sO = sQ + kTileBytes, sRing = sQ + 2 * kTileBytes;

  const int b = blockIdx.z, head = blockIdx.y, heads = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * kTile + warp * 16 + gid;  // this thread's rows: row0, row0+8
  const size_t base = (size_t)b * S * H + (size_t)head * D;
  const float* brow = bias + (size_t)b * S;
  const int nkt = (S + kTile - 1) / kTile;

  // the key tiles walked, in order: every tile at D = 32; at D = 64 the live
  // ones (a dead tile is never loaded: header)
  static_assert(D == 32 || kResident == 0, "at D = 64 the fused kernel takes S <= 128");
  int nwalk = nkt;
  const int* live_kt = nullptr;
  float mb;
  if constexpr (D == 64) {
    __shared__ int list[kMaxListed + 1];
    load_tile<D>(sQ, q, base, blockIdx.x * kTile, S, H);
    load_tile<D>(sO, dout, base, blockIdx.x * kTile, S, H);
    mb = bias_max(brow, S);
    nwalk = live_tiles(brow, S, mb, list);
    live_kt = list;
  }
  const int nloads = kResident ? nwalk : 2 * nwalk;
  auto tile_of = [&](int i) { return D == 64 && nkt <= kMaxListed ? live_kt[i] : i; };
  auto fetch = [&](int t) {
    const uint32_t st = sRing + (t % kStages) * kStageBytes;
    const int k0 = tile_of(t % nwalk) * kTile;
    load_tile<D>(st, k, base, k0, S, H);
    load_tile<D>(st + kTileBytes, v, base, k0, S, H);
  };
  if constexpr (D != 64) {
    load_tile<D>(sQ, q, base, blockIdx.x * kTile, S, H);
    load_tile<D>(sO, dout, base, blockIdx.x * kTile, S, H);
  }
  fetch(0);
  cp_async_commit();
  ring_prologue(fetch, nloads);
  if constexpr (D != 64) mb = bias_max(brow, S);

  // S = Q K^T and dP = dO V^T of ring tile t, started, not waited for
  auto products = [&](int t, float (&s)[32], float (&dp)[32]) {
    const uint32_t kt = sRing + (t % kStages) * kStageBytes, vt = kt + kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(s, Hd::kmajor(sQ, kk), Hd::kmajor(kt, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(dp, Hd::kmajor(sO, kk), Hd::kmajor(vt, kk), kk > 0);
    wgmma_commit();
  };
  // this thread's 16 key columns of tile kt: bias * log2(e), -inf past S
  auto key_bias = [&](int kt, float (&bb)[16]) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int key = kt * kTile + 8 * (i >> 1) + 2 * tig + (i & 1);
      bb[i] = key < S ? brow[key] * kLog2e : -INFINITY;
    }
  };
  // dQ += dS K for the K tile of ring slot t; waits for the product
  float acc_dq[D / 2];
  zero(acc_dq);
  auto add_dq = [&](int t, const float (&ds)[32]) {
    const uint32_t kt = sRing + (t % kStages) * kStageBytes;
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(a[kk], ds, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_head<D>(acc_dq, a[kk], Hd::mnmajor(kt, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc_dq);
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[2] = {0.f, 0.f};
  float inv[2], dsum[2];
  if constexpr (kResident > 0) {
    // every key tile of the row was fetched by the prologue: wait for all,
    // then start all of their products behind one wait
    float s[kResident][32], dp[kResident][32], bb[kResident][16];
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kResident; ++t)
      if (t < nkt) products(t, s[t], dp[t]);
#pragma unroll
    for (int t = 0; t < kResident; ++t) key_bias(t, bb[t]);
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < kResident; ++t) {
      if (t < nkt) {
        fence_acc(s[t]);
        fence_acc(dp[t]);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          s[t][i] = fmaf(s[t][i], c, bb[t][2 * (i >> 2) + (i & 1)]);
          m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], s[t][i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[t][i] = -INFINITY, dp[t][i] = 0.f;
      }
    }
    // each row's 64 * kResident scores live in the 4 threads of a quad
#pragma unroll
    for (int r = 0; r < 2; ++r) m[r] = quad_max(m[r]);
#pragma unroll
    for (int t = 0; t < kResident; ++t)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const float e = exp2f(s[t][i] - m[r]);
        s[t][i] = e;
        l[r] += e;
        acc[r] += e * dp[t][i];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      inv[r] = 1.f / l[r];
      dsum[r] = quad_sum(acc[r]) * inv[r];
    }
#pragma unroll
    for (int t = 0; t < kResident; ++t) {
      if (t < nkt) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          dp[t][i] = s[t][i] * inv[r] * (dp[t][i] - dsum[r]);
        }
        add_dq(t, dp[t]);
      }
    }
  } else {
    // walk 1: each row's max m, sum l and acc = sum exp2(u - m) dP, online
    for (int t = 0; t < nwalk; ++t) {
      ring_acquire(fetch, t, nloads);
      float s[32], dp[32], bb[16];
      products(t, s, dp);
      key_bias(tile_of(t), bb);
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = fmaf(s[i], c, bb[2 * (i >> 2) + (i & 1)]);
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the first tile walked holds a key < S, so m is finite from it on
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        const float alpha = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha;
        acc[r] *= alpha;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const float e = exp2f(s[i] - m[r]);
        l[r] += e;
        acc[r] += e * dp[i];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      inv[r] = 1.f / l[r];
      dsum[r] = quad_sum(acc[r]) * inv[r];
    }
    // walk 2: dS = P o (dP - D), dQ += dS(bf16) K
    for (int t = nwalk; t < 2 * nwalk; ++t) {
      ring_acquire(fetch, t, nloads);
      float s[32], dp[32], bb[16];
      products(t, s, dp);
      key_bias(tile_of(t - nwalk), bb);
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const float p = exp2f(fmaf(s[i], c, bb[2 * (i >> 2) + (i & 1)]) - m[r]) * inv[r];
        dp[i] = p * (dp[i] - dsum[r]);
      }
      add_dq(t, dp);
    }
  }

  const size_t plane = (size_t)gridDim.z * heads * S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (tig == 0 && row < S) {
      const size_t at = ((size_t)b * heads + head) * S + row;
      stats[at] = (m[r] - mb) + log2f(l[r]);
      stats[plane + at] = dsum[r];
    }
  }
  store_rows<D>(dq, base, row0, S, H, tig, acc_dq, scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                     const __nv_bfloat16* __restrict__ dout, const float* __restrict__ stats,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int H,
                     float c, float scale) {
  using Hd = HeadTile<D>;
  constexpr int kTileBytes = Layout<D>::kTileBytes, kStageBytes = Layout<D>::kStageBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sV = sK + kTileBytes, sRing = sK + 2 * kTileBytes;
  const uint32_t sStats = sRing + kStages * kStageBytes;  // stage st: lse[64], then D[64]
  const float* stats_s = reinterpret_cast<const float*>(smem_raw + (sStats - smem_u32(smem_raw)));

  const int b = blockIdx.z, head = blockIdx.y, heads = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int key0 = blockIdx.x * kTile + warp * 16 + gid;  // this thread's keys: key0, key0+8
  const size_t base = (size_t)b * S * H + (size_t)head * D;
  const size_t plane = (size_t)gridDim.z * heads * S;
  const float* lse = stats + ((size_t)b * heads + head) * S;
  const float* brow = bias + (size_t)b * S;
  const int nqt = (S + kTile - 1) / kTile;

  // query tile t: Q and dO, and each query's log-sum-exp and D (+inf and 0
  // past S, so that those queries add exact zeros)
  auto fetch = [&](int t) {
    const int st = t % kStages;
    load_tile<D>(sRing + st * kStageBytes, q, base, t * kTile, S, H);
    load_tile<D>(sRing + st * kStageBytes + kTileBytes, dout, base, t * kTile, S, H);
    const int i = threadIdx.x & (kTile - 1), which = threadIdx.x / kTile, qi = t * kTile + i;
    const uint32_t dst = sStats + st * kStatBytes + (which * kTile + i) * 4;
    if (qi < S) cp_async4(dst, lse + which * plane + qi);
    else st_shared_f32(dst, which ? 0.f : INFINITY);
  };
  float mb, kb[2];
  auto key_biases = [&] {
    mb = bias_max(brow, S);
#pragma unroll
    for (int r = 0; r < 2; ++r) kb[r] = key0 + 8 * r < S ? brow[key0 + 8 * r] * kLog2e : -INFINITY;
  };
  float acc_dk[D / 2], acc_dv[D / 2];
  zero(acc_dk);
  zero(acc_dv);
  if constexpr (D == 64) {
    // a tile of dead keys gets exact zeros (header) and loads nothing
    key_biases();
    if (!__syncthreads_or(kb[0] >= mb - kDeadGap || kb[1] >= mb - kDeadGap)) {
      store_rows<D>(dk, base, key0, S, H, tig, acc_dk, 1.f);
      store_rows<D>(dv, base, key0, S, H, tig, acc_dv, 1.f);
      return;
    }
  }
  load_tile<D>(sK, k, base, blockIdx.x * kTile, S, H);
  load_tile<D>(sV, v, base, blockIdx.x * kTile, S, H);
  fetch(0);
  cp_async_commit();
  ring_prologue(fetch, nqt);
  if constexpr (D != 64) key_biases();
  for (int t = 0; t < nqt; ++t) {
    ring_acquire(fetch, t, nqt);
    const uint32_t qt = sRing + (t % kStages) * kStageBytes, ot = qt + kTileBytes;
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(st, Hd::kmajor(sK, kk), Hd::kmajor(qt, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(dpt, Hd::kmajor(sV, kk), Hd::kmajor(ot, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(st);
    fence_acc(dpt);
    const float* ls = stats_s + (t % kStages) * (kStatBytes / 4);
    const float* ds = ls + kTile;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + 2 * tig + (i & 1);
      const float p = exp2f((fmaf(st[i], c, kb[(i >> 1) & 1]) - mb) - ls[col]);
      st[i] = p;
      dpt[i] = p * (dpt[i] - ds[col]);
    }
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pack_a(pa[kk], st, kk);
      pack_a(sa[kk], dpt, kk);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_head<D>(acc_dv, pa[kk], Hd::mnmajor(ot, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_head<D>(acc_dk, sa[kk], Hd::mnmajor(qt, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc_dv);
    fence_acc(acc_dk);
  }
  store_rows<D>(dk, base, key0, S, H, tig, acc_dk, scale);
  store_rows<D>(dv, base, key0, S, H, tig, acc_dv, 1.f);
}

// ---- head_dim 64, S <= 128: one fused kernel -------------------------------
constexpr int kFusedMaxS = 2 * kTile;                 // 128: two 64-row tiles
constexpr int kFusedThreads = 256;                    // two warpgroups
constexpr int kFusedTile = 64 * 128;                  // 64 rows of one head's 64 features (HeadTile<64>)
constexpr int kFusedInputBytes = 4 * 2 * kFusedTile;  // Q, K, V, dO: two tiles each
constexpr int kFusedBuffers = 2;                      // the next (batch row, head)'s inputs land meanwhile
constexpr int kFusedSmemBytes =
    kFusedBuffers * kFusedInputBytes + 2 * 4 * kFusedTile + 2 * kFusedTile + 1024;  // + P, dS, dQ staging; alignment

// Phase 1 of the fused kernel, for warpgroup w and its 64 query rows: S =
// Q K^T and dP = dO V^T over the NK key tiles walked (64 * NK keys, one
// product of N = 64 * NK each), the row's max, sum and D = rowsum(dP o P)
// in registers, P and dS = P o (dP - D) into their bf16 [query][key] tiles
// in shared memory for the transposed products, and dQ = dS K from
// registers into its bf16 staging tile at sDQ.
template <int NK>
__device__ __forceinline__ void fused_rows(uint32_t sQt, uint32_t sKt, uint32_t sVt, uint32_t sOt,
                                           uint32_t sP, uint32_t sDS, uint32_t sDQ,
                                           const float* __restrict__ brow, int S, float c, float scale) {
  using Hd = HeadTile<64>;
  constexpr int kN = 32 * NK;  // accumulator registers a thread of each product
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, w = warp >> 2;
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t qt = sQt + w * kFusedTile, ot = sOt + w * kFusedTile;
  float s[kN], dp[kN];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (NK == 2) wgmma_ss_n128(s, Hd::kmajor(qt, kk), Hd::kmajor(sKt, kk), kk > 0);
    else wgmma_ss_n64(s, Hd::kmajor(qt, kk), Hd::kmajor(sKt, kk), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (NK == 2) wgmma_ss_n128(dp, Hd::kmajor(ot, kk), Hd::kmajor(sVt, kk), kk > 0);
    else wgmma_ss_n64(dp, Hd::kmajor(ot, kk), Hd::kmajor(sVt, kk), kk > 0);
  }
  wgmma_commit();
  float2 bb[8 * NK];  // this thread's key columns 8*j + 2*tig, +1: bias * log2(e), -inf past S
#pragma unroll
  for (int j = 0; j < 8 * NK; ++j) {
    const int key = 8 * j + 2 * tig;
    bb[j].x = key < S ? brow[key] * kLog2e : -INFINITY;
    bb[j].y = key + 1 < S ? brow[key + 1] * kLog2e : -INFINITY;
  }
  wgmma_wait<0>();
  fence_acc(s);
  fence_acc(dp);
  // each row's 64 * NK scores live in the 4 threads of a quad, and a thread
  // keeps four partial maxima and sums a row (short dependency chains)
  float pm[2][4], pl[2][4], pa[2][4], m[2], inv[2], dsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) pm[r][g] = -INFINITY, pl[r][g] = 0.f, pa[r][g] = 0.f;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    s[i] = fmaf(s[i], c, (i & 1) ? bb[i >> 2].y : bb[i >> 2].x);
    pm[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(pm[(i >> 1) & 1][(i >> 2) & 3], s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) m[r] = quad_max(fmaxf(fmaxf(pm[r][0], pm[r][1]), fmaxf(pm[r][2], pm[r][3])));
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int r = (i >> 1) & 1, g = (i >> 2) & 3;
    const float e = exp2f(s[i] - m[r]);
    s[i] = e;
    pl[r][g] += e;
    pa[r][g] = fmaf(e, dp[i], pa[r][g]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum((pl[r][0] + pl[r][1]) + (pl[r][2] + pl[r][3]));
    inv[r] = 1.f / l;
    dsum[r] = quad_sum((pa[r][0] + pa[r][1]) + (pa[r][2] + pa[r][3])) * inv[r];
  }
  const int r0 = 16 * (warp & 3) + gid;  // this thread's rows of the tile: r0, r0 + 8
#pragma unroll
  for (int j = 0; j < 8 * NK; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = 4 * j + 2 * r;
      const float p0 = s[i] * inv[r], p1 = s[i + 1] * inv[r];
      dp[i] = p0 * (dp[i] - dsum[r]);
      dp[i + 1] = p1 * (dp[i + 1] - dsum[r]);
      const uint32_t at = (w * 2 + (j >> 3)) * kFusedTile + swz<3>((r0 + 8 * r) * 128 + (j & 7) * 16) + 4 * tig;
      st_shared_u32(sP + at, pack_bf16(p0, p1));
      st_shared_u32(sDS + at, pack_bf16(dp[i], dp[i + 1]));
    }
  }
  // dQ = dS K: dS from registers as bf16, K [key][d] MN-major
  float acc_dq[32];
  uint32_t a[4 * NK][4];
  zero(acc_dq);
#pragma unroll
  for (int kk = 0; kk < 4 * NK; ++kk) pack_a(a[kk], dp, kk);
  fence_acc(acc_dq);  // the zeros and the fragments are written before the fence (else ptxas adds one: C7519)
  fence_frag(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NK; ++kk) wgmma_rs_n64(acc_dq, a[kk], Hd::mnmajor(sKt + (kk >> 2) * kFusedTile, kk & 3));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc_dq);
  stage_rows_sw128(sDQ + w * kFusedTile, r0, tig, acc_dq, scale);
}

// Phase 2 for key tile kt: dV = P^T dO (kV) and dK = dS^T Q (kK) over the
// NT query tiles, every operand a shared-memory tile read through its
// transpose bit, into their bf16 staging tiles (dK at sKt, dV at sVt: K and
// V are read no more). (Which products a warpgroup issues is fixed at
// compile time: wgmmas under a run-time condition are serialised, C7520.)
template <int NT, bool kV, bool kK>
__device__ __forceinline__ void fused_cols(int kt, uint32_t sQt, uint32_t sKt, uint32_t sVt, uint32_t sOt,
                                           uint32_t sP, uint32_t sDS, float scale) {
  using Hd = HeadTile<64>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * (warp & 3) + (lane >> 2);  // this thread's keys of the tile: r0, r0 + 8
  float acc_dv[32], acc_dk[32];
  zero(acc_dv);
  zero(acc_dk);
  fence_acc(acc_dv);  // the zeros are written before the fence (else ptxas adds one: C7519)
  fence_acc(acc_dk);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const uint32_t pt = (j * 2 + kt) * kFusedTile;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (kV) wgmma_ss_n64_tt(acc_dv, Hd::mnmajor(sP + pt, kk), Hd::mnmajor(sOt + j * kFusedTile, kk));
      if constexpr (kK) wgmma_ss_n64_tt(acc_dk, Hd::mnmajor(sDS + pt, kk), Hd::mnmajor(sQt + j * kFusedTile, kk));
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  if constexpr (kV) {
    fence_acc(acc_dv);
    stage_rows_sw128(sVt + kt * kFusedTile, r0, lane & 3, acc_dv, 1.f);
  }
  if constexpr (kK) {
    fence_acc(acc_dk);
    stage_rows_sw128(sKt + kt * kFusedTile, r0, lane & 3, acc_dk, scale);
  }
}

// One (batch row, head) at a time, S <= 128: Q, K, V and dO by TMA (one
// 64-row box each a tile, rows past S zeros), then phase 1 by query tile and
// phase 2 by key tile; dq, dk and dv go out by TMA from bf16 staging tiles
// (rows past S are not written). Blocks are persistent: a block takes items
// blockIdx.x, + gridDim.x, ..., and thread 0 has the next item's inputs
// copied into the other buffer while the current one is worked on.
__global__ void __launch_bounds__(kFusedThreads, 1)
attn_bwd_fused_d64_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                          const __grid_constant__ CUtensorMap tm_dq, const __grid_constant__ CUtensorMap tm_dk,
                          const __grid_constant__ CUtensorMap tm_dv, const float* __restrict__ bias, int S,
                          int heads, int items, float c, float scale) {
  constexpr int D = 64;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kFusedBuffers];
  const uint32_t sIn = (smem_u32(smem_raw) + 1023) & ~1023u;   // buffer i: Q, K, V, dO at sIn + i * kFusedInputBytes
  const uint32_t sP = sIn + kFusedBuffers * kFusedInputBytes;  // P [query tile][key tile], bf16
  const uint32_t sDS = sP + 4 * kFusedTile;                    // dS, the same
  const uint32_t sDQ = sDS + 4 * kFusedTile;                   // dq's two staging tiles
  const int nt = (S + kTile - 1) / kTile;                      // query tiles = key tiles: 1 or 2
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the warpgroup, broadcast so that the compiler knows it is uniform: a
  // wgmma under a branch it cannot prove uniform is serialised (C7520)
  const int w = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kFusedBuffers; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto fetch = [&](int item, int buf) {  // thread 0
    const int b = item / heads, col = (item % heads) * D;
    const uint32_t dst = sIn + buf * kFusedInputBytes;
    mbar_expect_tx(&full[buf], 4 * nt * kFusedTile);
    for (int r = 0; r < nt; ++r) {
      tma_load_3d(dst + r * kFusedTile, &tm_q, col, r * kTile, b, &full[buf]);
      tma_load_3d(dst + (2 + r) * kFusedTile, &tm_k, col, r * kTile, b, &full[buf]);
      tma_load_3d(dst + (4 + r) * kFusedTile, &tm_v, col, r * kTile, b, &full[buf]);
      tma_load_3d(dst + (6 + r) * kFusedTile, &tm_o, col, r * kTile, b, &full[buf]);
    }
  };
  if (threadIdx.x == 0) {
    prefetch_tensor_map(&tm_q);
    prefetch_tensor_map(&tm_k);
    prefetch_tensor_map(&tm_v);
    prefetch_tensor_map(&tm_o);
    prefetch_tensor_map(&tm_dq);
    prefetch_tensor_map(&tm_dk);
    prefetch_tensor_map(&tm_dv);
    if (blockIdx.x < items) fetch(blockIdx.x, 0);
  }
  // this lane's keys lane + 32 * k of an item's batch row (bias * log2(e),
  // -inf past S), loaded one item ahead so that their latency hides behind
  // the current item's work
  float bnext[4];
  auto bias_of = [&](int item, float (&bk)[4]) {
    const float* brow = bias + (size_t)(item / heads) * S;
#pragma unroll
    for (int k = 0; k < 4; ++k) bk[k] = lane + 32 * k < S ? brow[lane + 32 * k] * kLog2e : -INFINITY;
  };
  if (blockIdx.x < items) bias_of(blockIdx.x, bnext);
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    const int buf = it & 1;
    // the other buffer's last readers: the wgmmas, done before the barrier
    // that ended the previous item, and that item's dk and dv stores
    if (threadIdx.x == 0 && item + gridDim.x < items) {
      bulk_wait_read<0>();
      fetch(item + gridDim.x, buf ^ 1);
    }
    const int b = item / heads, col = (item % heads) * D;
    const float* brow = bias + (size_t)b * S;
    float bk[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) bk[k] = bnext[k];
    if (item + gridDim.x < items) bias_of(item + gridDim.x, bnext);
    // key tile 1 is walked if it holds a live key (tile 0 holds the row's
    // largest bias unless tile 1 does)
    float mb = fmaxf(fmaxf(bk[0], bk[1]), fmaxf(bk[2], bk[3])), mb1 = fmaxf(bk[2], bk[3]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
      mb1 = fmaxf(mb1, __shfl_xor_sync(0xffffffffu, mb1, off));
    }
    // (an __any_sync, so that the compiler knows the branch on it is uniform: C7520)
    const bool walk1 = __any_sync(0xffffffffu, nt == 2 && mb1 >= mb - kDeadGap);
    const uint32_t in = sIn + buf * kFusedInputBytes;
    const uint32_t sQt = in, sKt = in + 2 * kFusedTile, sVt = in + 4 * kFusedTile, sOt = in + 6 * kFusedTile;
    mbar_wait(&full[buf], (it >> 1) & 1);
    if (w < nt) {
      if (walk1) fused_rows<2>(sQt, sKt, sVt, sOt, sP, sDS, sDQ, brow, S, c, scale);
      else fused_rows<1>(sQt, sKt, sVt, sOt, sP, sDS, sDQ, brow, S, c, scale);
    }
    fence_proxy_async();  // the P, dS and dq tiles, stored by this thread, before the async proxy reads them
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int r = 0; r < nt; ++r) tma_store_3d(&tm_dq, sDQ + r * kFusedTile, col, r * kTile, b);
      bulk_commit();
    }
    if (nt == 1) {  // one key tile: warpgroup 0 takes dV, warpgroup 1 dK
      if (w == 0) fused_cols<1, true, false>(0, sQt, sKt, sVt, sOt, sP, sDS, scale);
      else fused_cols<1, false, true>(0, sQt, sKt, sVt, sOt, sP, sDS, scale);
    } else if (w == 0 || walk1) {  // warpgroup w: key tile w, both
      fused_cols<2, true, true>(w, sQt, sKt, sVt, sOt, sP, sDS, scale);
    } else {  // key tile 1 dead: exact zeros
      float zeros[32];
      zero(zeros);
      const int r0 = 16 * (warp & 3) + (lane >> 2);
      stage_rows_sw128(sKt + kFusedTile, r0, lane & 3, zeros, 1.f);
      stage_rows_sw128(sVt + kFusedTile, r0, lane & 3, zeros, 1.f);
    }
    fence_proxy_async();
    if (threadIdx.x == 0) bulk_wait_read<0>();  // dq's staging tiles are free for the next item
    __syncthreads();  // the buffer and the P and dS tiles are taken again
    if (threadIdx.x == 0) {
      for (int r = 0; r < nt; ++r) {
        tma_store_3d(&tm_dk, sKt + r * kFusedTile, col, r * kTile, b);
        tma_store_3d(&tm_dv, sVt + r * kFusedTile, col, r * kTile, b);
      }
      bulk_commit();
    }
  }
  if (threadIdx.x == 0) bulk_wait<0>();
}

int launch_fused(const void* q, const void* k, const void* v, const float* bias, const void* dout,
                 void* dq, void* dk, void* dv, int B, int S, int H, int num_heads, cudaStream_t st) {
  CUtensorMap maps[7];
  const void* src[7] = {q, k, v, dout, dq, dk, dv};
  const uint64_t dims[3] = {(uint64_t)H, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)H * 2, (uint64_t)S * H * 2};
  const uint32_t box[3] = {64, (uint32_t)kTile, 1};
  for (int i = 0; i < 7; ++i)
    if (!tensor_map_3d(&maps[i], src[i], dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
  static std::atomic<int> sm_counts[kMaxDevices];
  const int sms = opted_sm_count(attn_bwd_fused_d64_kernel, kFusedSmemBytes, sm_counts);
  if (sms < 0) return -sms;
  const int items = B * num_heads;
  const float scale = 0.125f, c = (float)(1.4426950408889634 / 8.0);  // 1 / sqrt(64)
  attn_bwd_fused_d64_kernel<<<min(items, sms), kFusedThreads, kFusedSmemBytes, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], bias, S, num_heads, items, c, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, const float* bias, const void* dout, void* dq,
           void* dk, void* dv, float* stats, int B, int S, int H, int num_heads, cudaStream_t st) {
  using L = Layout<D>;
  constexpr int kMaxResident = L::kMaxResident;
  auto dq_kernel = attn_bwd_dq_kernel<D, 0>;
  if constexpr (D == 64) {
    if (S <= kFusedMaxS) return launch_fused(q, k, v, bias, dout, dq, dk, dv, B, S, H, num_heads, st);
  } else {
    if (S <= kTile) dq_kernel = attn_bwd_dq_kernel<D, 1>;
    else if (S <= kMaxResident * kTile) dq_kernel = attn_bwd_dq_kernel<D, kMaxResident>;
  }
  if constexpr (L::kSmemBytes > 48 * 1024) {
    // above 48 KB of dynamic shared memory a kernel must opt in, on each
    // device it runs on (the attribute is the current device's)
    for (const void* fn : {reinterpret_cast<const void*>(dq_kernel),
                           reinterpret_cast<const void*>(&attn_bwd_dkdv_kernel<D>)}) {
      const cudaError_t opt_in =
          cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
      if (opt_in != cudaSuccess) return (int)opt_in;
    }
  }
  const dim3 grid((S + kTile - 1) / kTile, num_heads, B);
  const float scale = (float)(1.0 / sqrt((double)D));
  const float c = (float)(1.4426950408889634 / sqrt((double)D));
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* ob = static_cast<const __nv_bfloat16*>(dout);
  dq_kernel<<<grid, kThreads, L::kSmemBytes, st>>>(qb, kb, vb, bias, ob, static_cast<__nv_bfloat16*>(dq),
                                                   stats, S, H, c, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv_kernel<D><<<grid, kThreads, L::kSmemBytes, st>>>(qb, kb, vb, bias, ob, stats,
                                                                 static_cast<__nv_bfloat16*>(dk),
                                                                 static_cast<__nv_bfloat16*>(dv), S, H, c,
                                                                 scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v/dout/dq/dk/dv [B,S,H] bf16 (H = num_heads * head_dim, head_dim 32 or
// 64), 16-byte aligned; bias [B,S] f32; stats: scratch of 2*B*num_heads*S
// f32 (each query row's log-sum-exp relative to its batch row's largest key
// bias, and D), written by the first kernel and read by the second.
FRAG_EXPORT int frag_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const float* bias, const void* dout, void* dq, void* dk,
                                         void* dv, float* stats, int B, int S, int H, int num_heads,
                                         void* stream) {
  if (num_heads < 1 || H % num_heads || S < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H / num_heads) {
    case 32: return launch<32>(q, k, v, bias, dout, dq, dk, dv, stats, B, S, H, num_heads, st);
    case 64: return launch<64>(q, k, v, bias, dout, dq, dk, dv, stats, B, S, H, num_heads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K10: fused bidirectional multi-head self-attention, backward.
//
// Replaces financial_rag_tpu/ops/flash_attention.py:_flash_bwd (the Pallas
// kernel _attn_bwd_kernel): q, k, v and dout are [B,S,H] bf16 with the heads
// interleaved along H (head g owns columns g*D .. g*D+D-1, head_dim D = 32
// for bge-small / gte-small / MiniLM, 64 for bge-base / gte-base), bias is
// the additive [B,S] f32 key bias of the forward (0 or -1e9), and dq, dk, dv
// are [B,S,H] bf16. It recomputes the probabilities from q, k and the bias
// (the forward saves neither P nor its output) and applies
//     dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),  D = rowsum(dP o P),
//     dQ = dS K * scale,  dK = dS^T Q * scale
// with the TPU kernel's rounding points: scores, P, dP, dS and D in f32 (D
// from the unrounded P, not from the forward's bf16 output); P^T and dS
// rounded to bf16 before the products that take them; f32 accumulation.
//
// Bound on the H100 (per (batch row, head): 7*S*2*D bytes of q, k, v, dO,
// dq, dk, dv; 5 products of 2*S*S*D flops; exps per score), B=256, 12 heads:
//   head_dim 32. S = 32, 64, 128 (the train path): the bytes (S=128: 0.053
//     ms against 0.016 ms of tensor work and 0.024 ms of exps at 2 per
//     score, 16 a clock on each of 132 SMs); S = 512: the exps (3 per score
//     there, 0.58 ms; tensor work 0.26 ms, bytes 0.21 ms).
//   head_dim 64. S = 128: the bytes (352.5 MB, 0.105 ms, against 0.033 ms of
//     tensor work and the same 0.024 ms of exps); S = 512: the exps (0.58
//     ms; tensor work 0.52 ms, bytes 0.42 ms).
//
// Design (sm_90a), one template over D in {32, 64}: two kernels, 128
// threads (one warpgroup) per block, on a grid of (64-row tile, head, batch
// row); every product is a wgmma m64nNk16 from shared-memory tiles of one
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
// scratch do not depend on D.
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
  const int nloads = kResident ? nkt : 2 * nkt;

  auto fetch = [&](int t) {
    const uint32_t st = sRing + (t % kStages) * kStageBytes;
    const int k0 = (t % nkt) * kTile;
    load_tile<D>(st, k, base, k0, S, H);
    load_tile<D>(st + kTileBytes, v, base, k0, S, H);
  };
  load_tile<D>(sQ, q, base, blockIdx.x * kTile, S, H);
  load_tile<D>(sO, dout, base, blockIdx.x * kTile, S, H);
  fetch(0);
  cp_async_commit();
  ring_prologue(fetch, nloads);
  const float mb = bias_max(brow, S);

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
    for (int t = 0; t < nkt; ++t) {
      ring_acquire(fetch, t, nloads);
      float s[32], dp[32], bb[16];
      products(t, s, dp);
      key_bias(t, bb);
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
      for (int r = 0; r < 2; ++r) {  // tile 0 holds key 0, so m is finite from the first tile on
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
    for (int t = nkt; t < 2 * nkt; ++t) {
      ring_acquire(fetch, t, nloads);
      float s[32], dp[32], bb[16];
      products(t, s, dp);
      key_bias(t - nkt, bb);
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
  load_tile<D>(sK, k, base, blockIdx.x * kTile, S, H);
  load_tile<D>(sV, v, base, blockIdx.x * kTile, S, H);
  fetch(0);
  cp_async_commit();
  ring_prologue(fetch, nqt);
  const float mb = bias_max(brow, S);
  float kb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kb[r] = key0 + 8 * r < S ? brow[key0 + 8 * r] * kLog2e : -INFINITY;

  float acc_dk[D / 2], acc_dv[D / 2];
  zero(acc_dk);
  zero(acc_dv);
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

template <int D>
int launch(const void* q, const void* k, const void* v, const float* bias, const void* dout, void* dq,
           void* dk, void* dv, float* stats, int B, int S, int H, int num_heads, cudaStream_t st) {
  using L = Layout<D>;
  constexpr int kMaxResident = L::kMaxResident;
  const auto dq_kernel = S <= kTile                  ? attn_bwd_dq_kernel<D, 1>
                         : S <= kMaxResident * kTile ? attn_bwd_dq_kernel<D, kMaxResident>
                                                     : attn_bwd_dq_kernel<D, 0>;
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

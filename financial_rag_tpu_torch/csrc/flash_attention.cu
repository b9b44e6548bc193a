// K2: fused bidirectional multi-head self-attention, forward.
//
// Replaces financial_rag_tpu/ops/flash_attention.py:flash_attention (the
// Pallas kernel _attn_kernel via _fwd_call): q, k, v are [B,S,H] bf16 with the
// heads interleaved along H (head g owns columns g*D .. g*D+D-1, head_dim D =
// 32 for bge-small / gte-small / MiniLM, 64 for bge-base / gte-base), bias is
// an additive [B,S] f32 key bias (0 or -1e9), the output is [B,S,H] bf16.
// Scores, bias and softmax stay f32; P is rounded to bf16 (v's dtype) before
// P@V, as the TPU kernel does.
//
// Bound on the H100: per (batch row, head) the products are 4*S*L*D flops
// over its L live keys against 2*D bytes a row of q and out and of k and v,
// ~L/2 flop/byte at any D, so the bytes bound it below L ~ 600; and one
// exponential per score on the SFUs (16 a clock on each of 132 SMs) is a
// floor of about the same size at D = 32 and half the products' time at D =
// 64. The softmax arithmetic, not the tensor cores, sets the pace.
//
// Design (sm_90a), one template over D in {32, 64}: a block takes 128 query
// rows of one (batch row, head): two consumer warpgroups of 64 rows and one
// producer warp (at S <= 64 one consumer warpgroup, so that more blocks
// share an SM). The producer streams 64-key tiles of K and V by cp.async
// into a ring of 4 stages, one head's 2*D-byte slice of each row in the
// swizzle of that width (64-byte rows at D = 32, 128-byte rows at D = 64;
// a K + V stage is 8 or 16 KB), with each tile's bias times log2(e) beside
// it, and publishes each stage through an mbarrier; the consumers release
// it through a second one. Per tile a consumer warpgroup runs S = Q K^T
// (wgmma m64n64k16, D/16 k-steps, Q and K K-major from shared memory), the
// online softmax in base 2 (log2(e)/sqrt(D) folded into one FMA with the
// bias, one ex2 per score), then O += P V (wgmma m64nDk16, P from registers
// as bf16, V [key][d] read MN-major through the transpose bit: nothing is
// transposed in memory; O is D/2 registers a thread). The two warpgroups
// are not in lock step, so one's softmax runs while the other's products
// do, and two blocks share an SM (three at D = 64 and S <= 64, four at D =
// 32 and S <= 64). Every warp scans the row's bias itself (which tiles are
// live), so no block-wide barrier waits for the scan, and the producer
// starts the first tile's copies before it: at S <= 64, where a block's
// whole work is one tile, the scan, the Q copy and the K/V copy overlap.
//
// Dead key tiles are skipped, exactly. A key is dead when its bias times
// log2(e) lies more than 2^20 below the batch row's largest (Mb); a tile whose
// keys are all dead or past S is never loaded. Whenever |q.k| * log2(e) /
// sqrt(D) < 2^18 (any real activation: |q.k| < 2^18 * sqrt(D) / log2(e),
// about 1.03e6 at D = 32 and 1.45e6 at D = 64), every dead score sits more
// than 2^19 below the row's final maximum, which is at least the score of
// the key holding Mb: its ex2 is exactly 0, it never moves the running
// maximum, and alpha is exactly 1 past it, so the output is the same to the
// bit as with every tile walked. The key holding Mb is never dead, so a row
// with no live key (all bias -1e9: every key ties at Mb) walks every tile
// and, its scores rounding to the same f32 value, gets the mean of v over
// the S keys, as the plain version and the TPU kernel give. Keys past S get
// -inf.
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
    case 64: return launch_head<64>(q, k, v, bias, out, B, S, H, num_heads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

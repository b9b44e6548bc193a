// K2: fused bidirectional multi-head self-attention, forward.
//
// Replaces financial_rag_tpu/ops/flash_attention.py:flash_attention (the
// Pallas kernel _attn_kernel via _fwd_call): q, k, v are [B,S,H] bf16 with the
// heads interleaved along H (head g owns columns g*32 .. g*32+31), bias is an
// additive [B,S] f32 key bias (0 or -1e9), the output is [B,S,H] bf16. Scores,
// bias and softmax stay f32; P is rounded to bf16 (v's dtype) before P@V, as
// the TPU kernel does.
//
// Bound on the H100 at head_dim 32: per (batch row, head) the products are
// 4*S*L*32 flops over its L live keys against 64 bytes a row of q and out and
// of k and v, ~L/2 flop/byte, so the bytes bound it below L ~ 600; and one
// exponential per score on the SFUs (16 a clock on each of 132 SMs) is a
// floor of about the same size. The softmax arithmetic, not the tensor
// cores, sets the pace.
//
// Design (sm_90a): a block takes 128 query rows of one (batch row, head):
// two consumer warpgroups of 64 rows and one producer warp (at S <= 64 one
// consumer warpgroup, so that four blocks, not two, share an SM). The
// producer streams 64-key tiles of K and V by cp.async into a ring of 4
// stages in the 64-byte swizzle (one head's 64-byte slice of each row), with
// each tile's bias times log2(e) beside it, and publishes each stage through
// an mbarrier; the consumers release it through a second one. Per tile a
// consumer warpgroup runs S = Q K^T (wgmma m64n64k16, Q and K K-major from
// shared memory), the online softmax in base 2 (log2(e)/sqrt(32) folded into
// one FMA with the bias, one ex2 per score), then O += P V (wgmma m64n32k16,
// P from registers as bf16, V [key][d] read MN-major through the transpose
// bit: nothing is transposed in memory). The two warpgroups are not in lock
// step, so one's softmax runs while the other's products do, and two blocks
// share an SM. Every warp scans the row's bias itself (which tiles are live),
// so no block-wide barrier waits for the scan, and the producer starts the
// first tile's copies before it: at S <= 64, where a block's whole work is
// one tile, the scan, the Q copy and the K/V copy overlap.
//
// Dead key tiles are skipped, exactly. A key is dead when its bias times
// log2(e) lies more than 2^20 below the batch row's largest (Mb); a tile whose
// keys are all dead or past S is never loaded. Whenever |q.k| * log2(e) /
// sqrt(32) < 2^18 (any real activation), every dead score sits more than 2^19
// below the row's final maximum, which is at least the score of the key
// holding Mb: its ex2 is exactly 0, it never moves the running maximum, and
// alpha is exactly 1 past it, so the output is the same to the bit as with
// every tile walked. The key holding Mb is never dead, so a row with no live
// key (all bias -1e9: every key ties at Mb) walks every tile and, its scores
// rounding to the same f32 value, gets the mean of v over the S keys, as the
// plain version and the TPU kernel give. Keys past S get -inf.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kHeadDim = 32;
constexpr int kTile = 64;                          // query rows per warpgroup, keys per tile
constexpr int kTileBytes = kTile * kHeadDim * 2;   // 64 rows of 64 bytes
constexpr int kStages = 4;
constexpr float kDeadGap = 1048576.f;              // 2^20, in units of log2

// A block of NC consumer warpgroups (64 query rows each) and a producer warp.
template <int NC>
struct Block {
  static constexpr int kRows = kTile * NC;
  static constexpr int kThreads = NC * 128 + 32;
  static constexpr int kSmemBytes = (NC + 2 * kStages) * kTileBytes + 1024;  // + alignment
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
__device__ __forceinline__ void load_kv(uint32_t ks, const __nv_bfloat16* __restrict__ k,
                                        const __nv_bfloat16* __restrict__ v, size_t base, int kt,
                                        int S, int H, int lane) {
  const int k0 = kt * kTile;
  for (int e = lane; e < kTile * 4; e += 32) {
    const int r = e >> 2, ch = e & 3;
    const bool ok = k0 + r < S;
    const size_t src = base + (size_t)(ok ? k0 + r : 0) * H + 8 * ch;
    cp_async16(ks + swz<2>(r * 64 + ch * 16), k + src, ok);
    cp_async16(ks + kTileBytes + swz<2>(r * 64 + ch * 16), v + src, ok);
  }
}

template <int NC>
__global__ void __launch_bounds__(Block<NC>::kThreads, 4 / NC)
attn_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                __nv_bfloat16* __restrict__ out, int S, int H, float c) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ __align__(16) float bias_s[kStages][kTile];  // a tile's key bias * log2(e)
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sRing = sQ + NC * kTileBytes;  // stage st: K, then V

  const int b = blockIdx.z;
  const int q0 = blockIdx.x * Block<NC>::kRows;
  const int consumers = min(NC, (S - q0 + kTile - 1) / kTile);  // warpgroups with a row < S
  const size_t base = (size_t)b * S * H + (size_t)blockIdx.y * kHeadDim;
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
    load_kv(sRing, k, v, base, 0, S, H, lane);
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
        load_kv(sRing + st * 2 * kTileBytes, k, v, base, kt, S, H, lane);
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
  for (int e = threadIdx.x & 127; e < kTile * 4; e += 128) {
    const int r = e >> 2, ch = e & 3, row = q0 + w * kTile + r;
    const bool ok = row < S;
    cp_async16(qt + swz<2>(r * 64 + ch * 16), q + base + (size_t)(ok ? row : 0) * H + 8 * ch, ok);
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
  float o[16], s[32];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m: base-2 scores with bias
  for (int t = 0; t < n; ++t) {
    const int st = t % kStages;
    mbar_wait(&full[st], (t / kStages) & 1);
    const uint32_t ks = sRing + st * 2 * kTileBytes, vs = ks + kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk)
      wgmma_ss_n64(s, sw64_kmajor(qt, kk), sw64_kmajor(ks, kk), kk > 0);
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
    for (int i = 0; i < 16; ++i) o[i] *= alpha[(i >> 1) & 1];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n32(o, pa[kk], sw64_mnmajor(vs, kk));
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
    for (int nt = 0; nt < kHeadDim / 8; ++nt)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)row * H + 8 * nt + 2 * tig) =
          pack_bf16(o[4 * nt + 2 * r] * inv, o[4 * nt + 2 * r + 1] * inv);
  }
}

template <int NC>
int launch(const void* q, const void* k, const void* v, const float* bias, void* out, int B,
           int S, int H, int num_heads, float c, cudaStream_t st) {
  const dim3 grid((S + Block<NC>::kRows - 1) / Block<NC>::kRows, num_heads, B);
  attn_fwd_kernel<NC><<<grid, Block<NC>::kThreads, Block<NC>::kSmemBytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, static_cast<__nv_bfloat16*>(out), S, H, c);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v/out [B,S,H] bf16 (H = num_heads * 32), 16-byte aligned; bias [B,S] f32.
FRAG_EXPORT int frag_flash_attention(const void* q, const void* k, const void* v,
                                     const float* bias, void* out, int B, int S, int H,
                                     int num_heads, void* stream) {
  if (H != num_heads * kHeadDim || S < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float c = (float)(1.4426950408889634 / sqrt((double)kHeadDim));
  return S <= kTile ? launch<1>(q, k, v, bias, out, B, S, H, num_heads, c, st)
                    : launch<2>(q, k, v, bias, out, B, S, H, num_heads, c, st);
}

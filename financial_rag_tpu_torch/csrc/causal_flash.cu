// K9: causal grouped-query self-attention forward for decoder prefill, with
// left padding.
//
// Replaces financial_rag_tpu/ops/causal_flash.py:causal_flash_prefill (the
// Pallas kernel _causal_kernel): q is [B,S,Hq*D], k and v are [B,S,Hkv*D]
// with the heads interleaved along the last axis, pad_len is an int32 [B]
// device array (row b's first pad_len positions are left padding), the
// output is [B,S,Hq*D] in q's dtype. Query head h reads kv head
// h / (Hq/Hkv). Query position i attends key j iff pad_len <= j <= i. Scores
// and the softmax are f32; the unnormalised P is rounded to v's dtype before
// P@V, as the TPU kernel does. Rows inside the padding (i < pad_len) are
// written as zeros. (The TPU kernel writes the mean of v over the key tiles
// it visited there; no caller reads those rows.)
//
// Bound on the H100: at B=1, S=4096, 14 query heads of 64 (the Qwen2-0.5B
// answer prompt) the causal QK^T and PV are ~30 GFLOP at pad 0, ~0.030 ms at
// 989 TFLOP/s bf16 (~0.016 ms at the prompt's pad of 1,100), against ~16.8
// MB of q/k/v/out, ~0.005 ms at 3.35 TB/s: the
// operations bound it, and the exps (one per causal score, 16 a clock on
// each of 132 SMs) give about the same floor at head_dim 64, so the softmax
// has to run beside the products, not after them.
//
// Design of the bf16 path at head_dim 64 (sm_90a): a block serves one
// kv head of one batch row and 128 consecutive (position, query head) rows
// of that kv head's GQA group, packed position-major (row r: position
// r / group, head r % group), so every K/V tile it loads is used by all
// query heads of the group (7 for Qwen2-0.5B). One producer warp streams
// 64-key K and V tiles by cp.async into a ring of 3 shared-memory stages
// and publishes each through an mbarrier; two consumer warpgroups, 64 rows
// each, take every tile: S = Q K^T (wgmma, Q and K K-major in the 128-byte
// swizzle), the online softmax in registers with exp2 and log2(e)/sqrt(D)
// folded into one FMA (the mask only on tiles that cross pad_len or the
// diagonal), then O += P V (P from registers as bf16, V through the
// transpose bit), and release the stage through a second mbarrier. The two
// warpgroups are not in lock step, so one's softmax runs while the other's
// products do. (Overlapping a warpgroup's own softmax with its next Q K^T
// measured slower on the H100 at head_dim 64: ptxas serialises the wgmmas
// of that loop.) A block walks the key tiles from the one holding key
// pad_len to the one holding its last row's position (the causal skip);
// blocks launch heaviest first; a block whose rows are all padding loads
// nothing and writes zeros. The f32 instantiation (LLM_DTYPE=float32 only)
// is a plain CUDA-core loop: four threads per query row, 32-key tiles in
// shared memory.
//
// Head_dim 128 (Qwen2-1.5B / -7B, Llama-3-8B) has its own bf16 kernel,
// causal_fwd_bf16_d128_kernel. Bound: at B=1, S=4,096, pad 0, 32 query / 8
// kv heads (Llama-3-8B) the causal products are 137 GFLOP, 0.139 ms at 989
// TFLOP/s, and the exps 0.064 ms (one per causal score, 16 a clock on each
// of 132 SMs): the tensor cores bind, and the softmax has to hide behind
// the products. The head-64 design templated to 128 took 0.557 ms there
// (2.2x SDPA): its 129 KB of shared memory left one block of two consumer
// warpgroups an SM, its producer warp spent 64 cp.async a lane on every
// 64-key stage, and each 64 keys paid two mbarrier waits and a rescale of
// 64 O registers a thread. This kernel keeps the block (one kv head, 128
// packed rows, two consumer warpgroups of 64 rows, the causal skip, the
// mask on crossing tiles only) and changes the rest:
//  - K and V come by TMA: one producer thread copies each tile as two
//    boxes of one kv head's 64 columns (128 bytes, the 128-byte swizzle the
//    wgmmas read) x 128 keys from a 3-D tensor map over [B, S, Hkv*128]
//    built on the host for every launch; keys past S arrive as zeros (and
//    are masked), so no row of the next batch row is read. K and V have
//    their own full and empty mbarriers, so a K stage is refilled once
//    both warpgroups' S = Q K^T of it ended, before their P V does.
//  - 128-key tiles, 2 stages: Q (32 KB) + 2 x (K + V) of 32 KB each = 161
//    KB, one block an SM; S is wgmma m64n128k16, P V m64n128k16 with P from
//    registers; half the waits, fences and O rescales a key of 64-key tiles.
//  - The two consumer warpgroups take turns (named barriers 3 and 4): a
//    warpgroup issues a tile's S = Q K^T on its turn and passes it, so its
//    softmax runs while the other warpgroup's products occupy the tensor
//    cores. Q stays on cp.async (a block's packed rows are no rectangular
//    box when the group does not divide 128: 6 for Qwen2-1.5B, 7 for
//    Qwen2-7B).
//  - 288 threads: ptxas budgets 168 registers a thread for more than 8
//    warps (three warps share a sub-partition's 16,384), and the consumers'
//    S (64), O (64) and P (32) fit in 168 without a spill.
// At the Llama-3-8B shape it runs 0.251-0.269 ms of device time (0.557
// before; through the wrapper 0.276 against SDPA's 0.253, both by CUDA
// events): 52-55% of the tensor cores' rate. Per 128-key tile a warpgroup's
// products take 1,024 tensor-core cycles and its softmax at least 512
// cycles of exps on each sub-partition; at the full rate the two
// warpgroups' products and the TMA's writes would move 224 KB of shared
// memory a tile in 2,048 cycles, 85% of its 128 bytes a cycle (counted,
// not measured); ptxas's 168-register cap rules out the in-warpgroup
// pipeline that would hide more of the softmax (below).
// Tried on the H100 and dropped (kernel_ab.py device ms against copies of
// this source with one thing changed, NVIDIA H100 80GB HBM3, 700.00 W,
// Llama-3-8B B=1 S=4,096 pad 0; this kernel 0.268-0.286 in the same calls;
// registers from ptxas -v):
//  - issuing tile t+1's S = Q K^T with tile t's P V and running its
//    softmax under that P V (the in-warpgroup pipeline: S, O and P of two
//    tiles live at once, ~193 registers): at 288 threads ptxas spilled 208
//    bytes and serialised the wgmmas (C7512), 0.347-0.356; with a producer
//    warpgroup that gives its registers away (384 threads, setmaxnreg
//    40 / 232) ptxas still allocated 168 and spilled, 0.355; with 256
//    threads and thread 128 issuing the copies (193 registers, no spill),
//    0.306-0.313; at 64-key tiles with 4 stages (146 registers),
//    0.304-0.309;
//  - no turns (the warpgroups run free): 0.270-0.285, the same within the
//    calls' spread; 3 stages (225 KB): 0.271-0.275, the same;
//  - skipping the O rescale of a tile that raised no row maximum (a warp
//    vote): 0.284-0.287;
//  - persistent blocks (one an SM, items in snake order, the next item's Q
//    loaded while the current one runs; 20 bytes spilled): 0.274-0.278,
//    and 0.1123 against 0.1063-0.1079 at Qwen2-1.5B's 12 / 2 heads.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kQTile = 64;           // query rows per f32 block
constexpr int kKTile = 64;           // keys per K/V tile
constexpr int kWgRows = 64;          // (position, head) rows per consumer warpgroup
constexpr int kConsumers = 2;        // consumer warpgroups per block
constexpr int kBlockRows = kWgRows * kConsumers;
constexpr int kBf16Threads = kConsumers * 128 + 32;   // + the producer warp

template <int D>
struct CausalTiles {
  static constexpr int kRegionBytes = 64 * 128;          // 64 rows x 64 features (128 bytes)
  static constexpr int kTileBytes = kRegionBytes * (D / 64);
  static constexpr int kStages = 3;
  static constexpr int kSmemBytes = (kConsumers + 2 * kStages) * kTileBytes + 1024;
};

template <int D>
__global__ void __launch_bounds__(kBf16Threads)
causal_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const int* __restrict__ pad_len,
                       __nv_bfloat16* __restrict__ out, int S, int Hq, int group, float scale2) {
  static_assert(D == 64, "head_dim 128 runs causal_fwd_bf16_d128_kernel");
  using T = CausalTiles<D>;
  constexpr int kStages = T::kStages, kChunks = D / 8;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sRing = sQ + kConsumers * T::kTileBytes;  // stage st: K, then V

  const int b = blockIdx.z, g = blockIdx.y;
  const int r_begin = (gridDim.x - 1 - blockIdx.x) * kBlockRows;  // heaviest rows launch first
  const int rows = S * group;
  const int last_pos = (min(r_begin + kBlockRows, rows) - 1) / group;
  const int pad = min(max(pad_len[b], 0), S);
  const int k_begin = (pad / kKTile) * kKTile;
  // keys [k_begin, last_pos] in 64-key tiles; none when every row is padding
  const int ntiles = last_pos >= pad ? (last_pos - k_begin) / kKTile + 1 : 0;
  const int hq_w = Hq * D, hkv_w = (Hq / group) * D;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 32);              // every producer lane, once its copies landed
      mbar_init(&empty[st], kConsumers * 128);  // every consumer thread, once its products ended
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == kConsumers * 4) {
    // producer: K and V tile t into stage t % kStages, published one tile
    // late so that two tiles' copies are in flight, and always before it
    // blocks on a stage that a consumer has yet to release
    const size_t kbase = (size_t)b * S * hkv_w + (size_t)g * D;
    int published = 0;  // tiles 0 .. published-1 are visible to the consumers
    auto publish = [&](auto wait_groups) {
      wait_groups();
      fence_proxy_async();
      mbar_arrive(&full[published % kStages]);
      ++published;
    };
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % kStages;
      if (t >= kStages) {
        if (published < t) publish([] { cp_async_wait<0>(); });
        mbar_wait(&empty[st], (t / kStages - 1) & 1);
      }
      const uint32_t kt = sRing + st * 2 * T::kTileBytes, vt = kt + T::kTileBytes;
      const int k0 = k_begin + t * kKTile;
      for (int e = lane; e < kKTile * kChunks; e += 32) {
        const int r = e / kChunks, ch = e % kChunks;
        const bool ok = k0 + r < S;
        const size_t src = kbase + (size_t)(ok ? k0 + r : 0) * hkv_w + 8 * ch;
        cp_async16(kt + sw128_chunk(r, ch), k + src, ok);
        cp_async16(vt + sw128_chunk(r, ch), v + src, ok);
      }
      cp_async_commit();
      if (published < t) publish([] { cp_async_wait<1>(); });
    }
    if (published < ntiles) publish([] { cp_async_wait<0>(); });
    return;
  }

  // consumer warpgroup w: rows r_begin + 64w .. +63
  const int w = warp >> 2, wt = threadIdx.x & 127;
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t qt = sQ + w * T::kTileBytes;
  for (int e = wt; e < kWgRows * kChunks; e += 128) {
    const int lr = e / kChunks, ch = e % kChunks;
    const int r = r_begin + w * kWgRows + lr, pos = r / group;
    const bool ok = r < rows;
    const size_t src = ok ? ((size_t)b * S + pos) * hq_w + (size_t)(g * group + r - pos * group) * D + 8 * ch : 0;
    cp_async16(qt + sw128_chunk(lr, ch), q + src, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  named_barrier(1 + w, 128);

  // this thread's rows (lr = 16 * warp-in-group + gid, +8): position, or -1 past the end
  int pos[2];
  size_t obase[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_begin + w * kWgRows + 16 * (wt >> 5) + gid + 8 * i;
    pos[i] = r < rows ? r / group : -1;
    obase[i] = r < rows ? ((size_t)b * S + pos[i]) * hq_w + (size_t)(g * group + r - pos[i] * group) * D : 0;
  }

  const int pos_lo = min(pos[0], pos[1]);
  float o[D / 2], s[32];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m: raw (unscaled) scores
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % kStages;
    mbar_wait(&full[st], (t / kStages) & 1);
    fence_proxy_async();
    const uint32_t kt = sRing + st * 2 * T::kTileBytes, vt = kt + T::kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * T::kRegionBytes + (kk & 3) * 32;
      wgmma_ss_n64(s, make_desc(qt + off, 16, 1024, kSw128), make_desc(kt + off, 16, 1024, kSw128),
                      kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    const int k0 = k_begin + t * kKTile;

    // mask only where a key of the tile can be dead for one of the rows:
    // before pad_len, or past the lower of this thread's two positions
    if (k0 < pad || k0 + kKTile - 1 > pos_lo) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * tig + (i & 1);
        if (key < pad || key > pos[(i >> 1) & 1]) s[i] = -INFINITY;
      }
    }
    // online softmax; each row's 64 scores live in the 4 threads of a quad.
    // A row with no live key so far keeps m = -inf and adds zeros.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float nm[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      nm[r] = m_new == -INFINITY ? 0.f : -m_new * scale2;
      alpha[r] = exp2f(fmaf(m[r], scale2, nm[r]));
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = exp2f(fmaf(s[i], scale2, nm[r]));
      l[r] += s[i];
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(pa[kk], s, kk);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = make_desc(vt + kk * 16 * 128, T::kRegionBytes, 1024, kSw128);
      wgmma_rs_n64(o, pa[kk], db);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (pos[r] < 0) continue;
    const float inv = pos[r] < pad ? 0.f : 1.f / l[r];  // padding rows: zeros
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(out + obase[r] + 8 * nt + 2 * tig) =
          pack_bf16(o[4 * nt + 2 * r] * inv, o[4 * nt + 2 * r + 1] * inv);
  }
}

// ---- head_dim 128, bf16 ---------------------------------------------------
constexpr int kWideKeys = 128;                 // keys per K/V tile
constexpr int kWideStages = 2;                 // K/V tiles in flight
constexpr int kQRegion = 64 * 128;             // 64 rows x 64 features (128 bytes), SW128
constexpr int kQBytes = 2 * kQRegion;          // one warpgroup's 64 rows x 128 features
constexpr int kKvRegion = kWideKeys * 128;     // 128 keys x 64 features, SW128
constexpr int kKvBytes = 2 * kKvRegion;        // one K or V tile: 128 keys x 128 features
constexpr int kWideSmemBytes = kConsumers * kQBytes + 2 * kWideStages * kKvBytes + 1024;
constexpr int kWideThreads = kConsumers * 128 + 32;  // + the producer warp
constexpr int kTurnBarrier = 3;                // named barriers 3, 4: warpgroup 0's, 1's turn

__global__ void __launch_bounds__(kWideThreads, 1)
causal_fwd_bf16_d128_kernel(const __nv_bfloat16* __restrict__ q, const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ pad_len,
                            __nv_bfloat16* __restrict__ out, int S, int Hq, int group, float scale2) {
  constexpr int D = 128, kChunks = D / 8;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_k[kWideStages], full_v[kWideStages];
  __shared__ __align__(8) uint64_t empty_k[kWideStages], empty_v[kWideStages];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + kConsumers * kQBytes;      // stage st: K at sK + st * kKvBytes
  const uint32_t sV = sK + kWideStages * kKvBytes;    //           V at sV + st * kKvBytes

  const int g = blockIdx.x, b = blockIdx.z;
  const int r_begin = (gridDim.y - 1 - blockIdx.y) * kBlockRows;  // heaviest rows launch first
  const int rows = S * group;
  const int last_pos = (min(r_begin + kBlockRows, rows) - 1) / group;
  const int pad = min(max(pad_len[b], 0), S);
  const int k_begin = (pad / kWideKeys) * kWideKeys;
  // keys [k_begin, last_pos] in 128-key tiles; none when every row is padding
  const int ntiles = last_pos >= pad ? (last_pos - k_begin) / kWideKeys + 1 : 0;
  const int hq_w = Hq * D;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kWideStages; ++st) {
      mbar_init(&full_k[st], 1);                  // the producer's expect_tx; then the tile's bytes
      mbar_init(&full_v[st], 1);
      mbar_init(&empty_k[st], kConsumers * 4);    // lane 0 of every consumer warp
      mbar_init(&empty_v[st], kConsumers * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == kConsumers * 4) {
    // producer: one thread has the TMA copy K tile t, then V tile t, into
    // stage t % kWideStages once both warpgroups released what it held
    // (the two 64-column halves of one kv head, 16 KB each)
    if (lane == 0) {
      prefetch_tensor_map(&tm_k);
      prefetch_tensor_map(&tm_v);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % kWideStages, k0 = k_begin + t * kWideKeys;
        const uint32_t parity = (t / kWideStages - 1) & 1;
        if (t >= kWideStages) mbar_wait(&empty_k[st], parity);
        mbar_expect_tx(&full_k[st], kKvBytes);
        tma_load_3d(sK + st * kKvBytes, &tm_k, g * D, k0, b, &full_k[st]);
        tma_load_3d(sK + st * kKvBytes + kKvRegion, &tm_k, g * D + 64, k0, b, &full_k[st]);
        if (t >= kWideStages) mbar_wait(&empty_v[st], parity);
        mbar_expect_tx(&full_v[st], kKvBytes);
        tma_load_3d(sV + st * kKvBytes, &tm_v, g * D, k0, b, &full_v[st]);
        tma_load_3d(sV + st * kKvBytes + kKvRegion, &tm_v, g * D + 64, k0, b, &full_v[st]);
      }
    }
    return;
  }

  // consumer warpgroup w: rows r_begin + 64w .. +63
  const int w = warp >> 2, wt = threadIdx.x & 127;
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t qt = sQ + w * kQBytes;
  for (int e = wt; e < kWgRows * kChunks; e += 128) {
    const int lr = e / kChunks, ch = e % kChunks;
    const int r = r_begin + w * kWgRows + lr, pos = r / group;
    const bool ok = r < rows;
    const size_t src = ok ? ((size_t)b * S + pos) * hq_w + (size_t)(g * group + r - pos * group) * D + 8 * ch : 0;
    cp_async16(qt + sw128_chunk(lr, ch), q + src, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  named_barrier(1 + w, 128);

  // this thread's rows (lr = 16 * warp-in-group + gid, +8): position, or -1 past the end
  int pos[2];
  size_t obase[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_begin + w * kWgRows + 16 * (wt >> 5) + gid + 8 * i;
    pos[i] = r < rows ? r / group : -1;
    obase[i] = r < rows ? ((size_t)b * S + pos[i]) * hq_w + (size_t)(g * group + r - pos[i] * group) * D : 0;
  }
  const int pos_lo = min(pos[0], pos[1]);

  float o[D / 2], s[kWideKeys / 2];
  uint32_t p[kWideKeys / 16][4];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m: raw (unscaled) scores
  // ping-pong: a warpgroup issues a tile's S = Q K^T on its turn and then
  // passes the turn (128 threads wait, the other warpgroup's 128 arrive),
  // so one warpgroup's softmax runs while the other's products do;
  // warpgroup 0 goes first
  if (w == 1) named_barrier_arrive(kTurnBarrier, 2 * 128);
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % kWideStages, k0 = k_begin + t * kWideKeys;
    const uint32_t parity = (t / kWideStages) & 1;
    const uint32_t kt = sK + st * kKvBytes, vt = sV + st * kKvBytes;
    mbar_wait(&full_k[st], parity);
    named_barrier(kTurnBarrier + w, 2 * 128);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(s, make_desc(qt + (kk >> 2) * kQRegion + (kk & 3) * 32, 16, 1024, kSw128),
                    make_desc(kt + (kk >> 2) * kKvRegion + (kk & 3) * 32, 16, 1024, kSw128), kk > 0);
    wgmma_commit();
    named_barrier_arrive(kTurnBarrier + (w ^ 1), 2 * 128);
    wgmma_wait<0>();
    fence_acc(s);
    if (lane == 0) mbar_arrive(&empty_k[st]);

    // mask only where a key of the tile can be dead for one of the rows:
    // before pad_len, or past the lower of this thread's two positions
    if (k0 < pad || k0 + kWideKeys - 1 > pos_lo) {
#pragma unroll
      for (int i = 0; i < kWideKeys / 2; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * tig + (i & 1);
        if (key < pad || key > pos[(i >> 1) & 1]) s[i] = -INFINITY;
      }
    }
    // online softmax; each row's 128 scores live in the 4 threads of a
    // quad. A row with no live key so far keeps m = -inf and adds zeros.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kWideKeys / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float nm[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      nm[r] = m_new == -INFINITY ? 0.f : -m_new * scale2;
      alpha[r] = ex2(fmaf(m[r], scale2, nm[r]));
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < kWideKeys / 2; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = ex2(fmaf(s[i], scale2, nm[r]));
      l[r] += s[i];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < kWideKeys / 16; ++kk) pack_a(p[kk], s, kk);

    // O += P V (P from registers, V MN-major through the transpose bit)
    mbar_wait(&full_v[st], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWideKeys / 16; ++kk)
      wgmma_rs_n128(o, p[kk], make_desc(vt + kk * 16 * 128, kKvRegion, 1024, kSw128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o);
    if (lane == 0) mbar_arrive(&empty_v[st]);
  }
  // warpgroup 1's opening arrive is the one turn of warpgroup 0's left over
  if (w == 0) named_barrier(kTurnBarrier, 2 * 128);

#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (pos[r] < 0) continue;
    const float inv = pos[r] < pad ? 0.f : 1.f / l[r];  // padding rows: zeros
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<uint32_t*>(out + obase[r] + 8 * nt + 2 * tig) =
          pack_bf16(o[4 * nt + 2 * r] * inv, o[4 * nt + 2 * r + 1] * inv);
  }
}

constexpr int kF32Parts = 4;                  // threads per query row
constexpr int kF32Threads = kQTile * kF32Parts;
constexpr int kF32KTile = 32;

// f32: thread (row, part) owns head dims part, part+4, ... of one query row,
// so the four parts of a row read neighbouring shared-memory banks.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
causal_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int* __restrict__ pad_len,
                      float* __restrict__ out, int S, int Hq, int group, float scale) {
  constexpr int kPer = D / kF32Parts;
  __shared__ __align__(16) float ks[kF32KTile * D];
  __shared__ __align__(16) float vs[kF32KTile * D];

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQTile;
  const int part = threadIdx.x % kF32Parts;
  const int row = q0 + threadIdx.x / kF32Parts;
  const int hq_w = Hq * D, hkv_w = (Hq / group) * D;
  const size_t qbase = (size_t)b * S * hq_w + (size_t)h * D;
  const size_t kbase = (size_t)b * S * hkv_w + (size_t)(h / group) * D;
  const int pad = min(max(pad_len[b], 0), S);

  float qr[kPer], o[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    qr[i] = row < S ? q[qbase + (size_t)row * hq_w + kF32Parts * i + part] : 0.f;
    o[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const int key_end = min(q0 + kQTile, S);
  if (q0 + kQTile > pad) {
    for (int k0 = (pad / kF32KTile) * kF32KTile; k0 < key_end; k0 += kF32KTile) {
      __syncthreads();
      for (int e = threadIdx.x; e < kF32KTile * (D / 4); e += kF32Threads) {
        const int r = e / (D / 4), c = 4 * (e % (D / 4));
        float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
        if (k0 + r < S) {
          const size_t src = kbase + (size_t)(k0 + r) * hkv_w + c;
          kv = *reinterpret_cast<const float4*>(k + src);
          vv = *reinterpret_cast<const float4*>(v + src);
        }
        *reinterpret_cast<float4*>(&ks[r * D + c]) = kv;
        *reinterpret_cast<float4*>(&vs[r * D + c]) = vv;
      }
      __syncthreads();

      float s[kF32KTile];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kF32KTile; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc = fmaf(qr[i], ks[j * D + kF32Parts * i + part], acc);
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        const int key = k0 + j;
        s[j] = (key >= pad && key <= row && key < S) ? acc * scale : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m - m_use);
      m = m_new;
      l *= alpha;
#pragma unroll
      for (int i = 0; i < kPer; ++i) o[i] *= alpha;
#pragma unroll
      for (int j = 0; j < kF32KTile; ++j) {
        const float p = expf(s[j] - m_use);
        l += p;
#pragma unroll
        for (int i = 0; i < kPer; ++i) o[i] = fmaf(p, vs[j * D + kF32Parts * i + part], o[i]);
      }
    }
  }
  if (row >= S) return;
  const float inv = row < pad ? 0.f : 1.f / l;
#pragma unroll
  for (int i = 0; i < kPer; ++i) out[qbase + (size_t)row * hq_w + kF32Parts * i + part] = o[i] * inv;
}

}  // namespace

// q/out [B,S,Hq*D], k/v [B,S,Hkv*D], all bf16 or all f32 (dtype code), 16-byte
// aligned; pad_len int32 [B] on the device; D = 64 or 128; Hq % Hkv == 0.
// head_dim is the heads' true width, whose 1 / sqrt scales the scores: D, or
// less where the caller zero-padded each head of q, k and v to D (zero
// columns add nothing to q.k, and the output's padded columns come out zero).
FRAG_EXPORT int frag_causal_flash(const void* q, const void* k, const void* v, const int* pad_len,
                                  void* out, int B, int S, int Hq, int Hkv, int D, int dtype,
                                  int head_dim, void* stream) {
  if (S < 1 || B < 1 || Hkv < 1 || Hq % Hkv || (D != 64 && D != 128) || head_dim < 1 || head_dim > D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int group = Hq / Hkv;
  if (dtype == FRAG_BF16) {
    const dim3 grid((S * group + kBlockRows - 1) / kBlockRows, Hkv, B);
    const float scale2 = (float)(1.4426950408889634 / sqrt((double)head_dim));
    const auto* qb = static_cast<const __nv_bfloat16*>(q);
    const auto* kb = static_cast<const __nv_bfloat16*>(k);
    const auto* vb = static_cast<const __nv_bfloat16*>(v);
    auto* ob = static_cast<__nv_bfloat16*>(out);
    if (D == 128) {
      // K and V by TMA: [B][S][Hkv*128] as 3-D maps, boxes of one kv head's
      // 64 columns (128 bytes, SW128) x 128 keys; rows past S read as zeros
      CUtensorMap tm_k, tm_v;
      const uint64_t dims[3] = {(uint64_t)Hkv * 128, (uint64_t)S, (uint64_t)B};
      const uint64_t strides[2] = {(uint64_t)Hkv * 128 * 2, (uint64_t)S * Hkv * 128 * 2};
      const uint32_t box[3] = {64, (uint32_t)kWideKeys, 1};
      if (!tensor_map_3d(&tm_k, kb, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B) ||
          !tensor_map_3d(&tm_v, vb, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B))
        return (int)cudaErrorInvalidValue;
      const cudaError_t opt_in = cudaFuncSetAttribute(
          causal_fwd_bf16_d128_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmemBytes);
      if (opt_in != cudaSuccess) return (int)opt_in;
      const dim3 grid128(Hkv, (S * group + kBlockRows - 1) / kBlockRows, B);
      causal_fwd_bf16_d128_kernel<<<grid128, kWideThreads, kWideSmemBytes, st>>>(
          qb, tm_k, tm_v, pad_len, ob, S, Hq, group, scale2);
      return (int)cudaGetLastError();
    }
    // above 48 KB of dynamic shared memory a kernel must opt in, on each
    // device it runs on (the attribute is the current device's)
    const cudaError_t opt_in = cudaFuncSetAttribute(causal_fwd_bf16_kernel<64>,
                                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                    CausalTiles<64>::kSmemBytes);
    if (opt_in != cudaSuccess) return (int)opt_in;
    causal_fwd_bf16_kernel<64><<<grid, kBf16Threads, CausalTiles<64>::kSmemBytes, st>>>(
        qb, kb, vb, pad_len, ob, S, Hq, group, scale2);
  } else if (dtype == FRAG_F32) {
    const dim3 grid((S + kQTile - 1) / kQTile, Hq, B);
    const float scale = (float)(1.0 / sqrt((double)head_dim));
    const auto* qf = static_cast<const float*>(q);
    const auto* kf = static_cast<const float*>(k);
    const auto* vf = static_cast<const float*>(v);
    auto* of = static_cast<float*>(out);
    if (D == 64)
      causal_fwd_f32_kernel<64><<<grid, kF32Threads, 0, st>>>(qf, kf, vf, pad_len, of, S, Hq, group, scale);
    else
      causal_fwd_f32_kernel<128><<<grid, kF32Threads, 0, st>>>(qf, kf, vf, pad_len, of, S, Hq, group, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

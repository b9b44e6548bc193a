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
//
// Narrower heads (open_llama_3b_v2's 100, 80, 96; any even head_dim up to
// 128) are read where they lie, at the built width that holds them (64 or
// 128), as the TPU kernel slices each head out of whole rows: head h's dh
// columns start at h*dh. At 128 a padded copy would have cost the copies'
// traffic (~0.1 of 0.386 ms at 32 / 32 heads of 100, B=1 S=4,096) and
// products 128 wide of which 22-37.5% met zero columns. Instead:
//  - K and V come by TMA as two boxes of 64 columns a tile: from a 4-D map
//    over [B][S][Hkv][dh] where dh is a multiple of 8 (the columns past dh
//    arrive as zeros and are never fetched), else from a 3-D map over
//    [B][S][Hkv*dh] at the head's first column rounded down to a multiple
//    of 8 (the TMA faults on a box that starts off a 16-byte column): a
//    window with the head at columns off .. off+dh-1 (off = h*dh mod 8, 0
//    or 4 at 100) and its neighbours' columns around it. Warpgroup 0, which
//    goes first on every tile, zeroes the window's K columns that are not
//    the head's in shared memory before its turn, so a neighbour's k, an
//    inf included, never meets a zero of Q's; warpgroup 1 takes the tile
//    after warpgroup 0's turn. At 32 / 32 heads of 100, B=1 S=4,096 pad
//    1,100 (kernel_ab.py, NVIDIA H100 80GB HBM3, 700.00 W) this ran
//    0.2013-0.2023 ms, and the producer warp zeroing them (publishing each K
//    tile one tile late) 0.2830; the padded kernel alone 0.1765-0.1774.
//  - Q stays on cp.async, from the same 16-byte column: whole chunks by
//    16-byte copies, a chunk the head fills in part by 4-byte copies of
//    its pieces and zeros (cp_async_cols), so only the head's columns are
//    read. A query head's window offset must be its kv head's for Q's
//    columns to meet K's: windows take one kv head a query head.
//  - The products are N wide, the head's columns and its offset rounded up
//    to 80, 96, 104 or 128 (a template argument): Q K^T over N / 16 k-steps
//    (rounded up; 5, 6, 7 or 8), P V at wgmma n = N over V's first N columns
//    (the second 64-column block read in part), O N / 2 registers a thread
//    (147, 150, 156 registers at 80, 96, 104; 167 at 128; no spill).
//  - The epilogue stores the head's own columns from its offset.
// The f32 kernel reads and writes a head's own columns at any even dh
// (8-byte pairs; the other columns of its tiles zeros). A bf16 head
// narrower than 64, one whose window does not fit 128 columns (more than 8
// - the lowest set bit of dh columns before it), whose rows are not whole
// 16-byte chunks, or that shares its kv head with other query heads, and
// an odd dh, is padded in a copy by the caller.
#include "hopper.cuh"

#include <type_traits>

namespace {

using namespace hopper;

constexpr int kQTile = 64;           // query rows per f32 block
constexpr int kKTile = 64;           // keys per K/V tile
constexpr int kWgRows = 64;          // (position, head) rows per consumer warpgroup
constexpr int kConsumers = 2;        // consumer warpgroups per block
constexpr int kBlockRows = kWgRows * kConsumers;
constexpr int kBf16Threads = kConsumers * 128 + 32;   // + the producer warp

// Where head g of rows of heads dh columns wide is read from: the 16-byte
// column c0 at or below its first column g*dh, and the head's offset off
// from there (0 where dh is a multiple of 8: every head starts on one).
struct HeadCols {
  int c0, off;
  __device__ HeadCols(int g, int dh) : c0(g * dh - g * dh % 8), off(g * dh % 8) {}
};

// 64 packed (position, query head) rows r0 .. r0+63 of q (rows of hq_w
// columns, heads of dh) into a tile of 64-column SW128 regions at qt, by
// threads tid, tid + 128, ...: each row's head as its kChunks 16-byte chunks
// from its c0, only the head's own columns read (cp_async_cols), the rest
// and rows past `rows` zeros.
template <int kChunks>
__device__ __forceinline__ void load_q_rows(uint32_t qt, const __nv_bfloat16* __restrict__ q, int b, int S,
                                            int hq_w, int g, int group, int r0, int rows, int dh,
                                            int tid) {
  for (int e = tid; e < kWgRows * kChunks; e += 128) {
    const int lr = e / kChunks, ch = e % kChunks;
    const int r = r0 + lr, pos = r / group;
    const bool ok = r < rows;
    const HeadCols hc(g * group + r - pos * group, dh);
    const size_t src = ok ? ((size_t)b * S + pos) * hq_w + hc.c0 + 8 * ch : 0;
    const int lo = hc.off - 8 * ch, hi = ok ? hc.off + dh - 8 * ch : lo;
    cp_async_cols(qt + sw128_chunk(lr, ch), q + src, lo, hi);
  }
}

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

// Columns lo .. hi-1 (even) of each of the 128 key rows of a K tile (two
// 64-column SW128 regions) as zeros, by threads tid, tid + count, ...: the
// columns of a head's window that are not the head's, so that a neighbour's
// k (an inf included) meets none of Q's zeros.
__device__ __forceinline__ void zero_kv_cols(uint32_t tile, int lo, int hi, int tid, int count) {
  const int pieces = (hi - lo) >> 1;   // 4-byte pieces
  for (int e = tid; e < kWideKeys * pieces; e += count) {
    const int r = e / pieces, col = lo + 2 * (e % pieces);
    st_shared_u32(tile + (col >> 6) * kKvRegion + swz<3>(r * 128 + (col & 63) / 8 * 16) + (col & 7) * 2, 0u);
  }
}

// N: the products' width, a head's columns with their window's offset
// rounded up (80, 96, 104 or 128; wgmma_rs_cols): Q K^T runs over N / 16
// k-steps (rounded up), P V at n = N, and O is N / 2 registers a thread.
// K and V come as two 64-column boxes a tile, from a 4-D map over
// [B][S][Hkv][dh] (by_head: dh a multiple of 8; columns past dh read as
// zeros) or from a 3-D map over [B][S][Hkv*dh] at the head's 16-byte column
// c0 (a window: the head at columns off .. off+dh-1, its neighbours' around
// it, whose K columns warpgroup 0 zeroes before its turn on the tile; at
// dh = 128 the window is the head).
template <int N>
__global__ void __launch_bounds__(kWideThreads, 1)
causal_fwd_bf16_d128_kernel(const __nv_bfloat16* __restrict__ q, const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ pad_len,
                            __nv_bfloat16* __restrict__ out, int S, int Hq, int group, float scale2, int dh,
                            bool by_head) {
  constexpr int kSteps = (N + 15) / 16, kChunks = 2 * kSteps;  // Q K^T's k-steps; Q's 16-byte chunks a row
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
  const int hq_w = Hq * dh;
  const HeadCols kc(g, dh);
  // K's window columns below and past the head that Q K^T reads (none by head)
  const bool zero_k = !by_head && (kc.off > 0 || kc.off + dh < 16 * kSteps);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kWideStages; ++st) {
      mbar_init(&full_k[st], 1);   // the producer's expect_tx, then the tile's bytes
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
    // (two 64-column boxes of one kv head, 16 KB each)
    if (lane != 0) return;
    prefetch_tensor_map(&tm_k);
    prefetch_tensor_map(&tm_v);
    auto boxes = [&](uint32_t dst, const CUtensorMap* map, int k0, uint64_t* bar) {
      for (int i = 0; i < 2; ++i) {
        if (by_head) tma_load_4d(dst + i * kKvRegion, map, 64 * i, g, k0, b, bar);
        else tma_load_3d(dst + i * kKvRegion, map, kc.c0 + 64 * i, k0, b, bar);
      }
    };
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % kWideStages, k0 = k_begin + t * kWideKeys;
      const uint32_t parity = (t / kWideStages - 1) & 1;
      if (t >= kWideStages) mbar_wait(&empty_k[st], parity);
      mbar_expect_tx(&full_k[st], kKvBytes);
      boxes(sK + st * kKvBytes, &tm_k, k0, &full_k[st]);
      if (t >= kWideStages) mbar_wait(&empty_v[st], parity);
      mbar_expect_tx(&full_v[st], kKvBytes);
      boxes(sV + st * kKvBytes, &tm_v, k0, &full_v[st]);
    }
    return;
  }

  // consumer warpgroup w: rows r_begin + 64w .. +63 (Q K^T's k-steps' chunks)
  const int w = warp >> 2, wt = threadIdx.x & 127;
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t qt = sQ + w * kQBytes;
  load_q_rows<kChunks>(qt, q, b, S, hq_w, g, group, r_begin + w * kWgRows, rows, dh, wt);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  named_barrier(1 + w, 128);

  // this thread's rows (lr = 16 * warp-in-group + gid, +8): position, or -1
  // past the end; where the row's head starts in out, and its window offset
  int pos[2], off[2];
  size_t obase[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_begin + w * kWgRows + 16 * (wt >> 5) + gid + 8 * i;
    pos[i] = r < rows ? r / group : -1;
    const int hq = g * group + r - max(pos[i], 0) * group;
    off[i] = HeadCols(hq, dh).off;
    obase[i] = r < rows ? ((size_t)b * S + pos[i]) * hq_w + (size_t)hq * dh : 0;
  }
  const int pos_lo = min(pos[0], pos[1]);

  float o[N / 2], s[kWideKeys / 2];
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
    if (zero_k && w == 0) {   // before the turn that passes the tile to warpgroup 1
      zero_kv_cols(kt, 0, kc.off, wt, 128);
      zero_kv_cols(kt, kc.off + dh, 16 * kSteps, wt, 128);
      fence_proxy_async();    // this thread's zeros, before the wgmmas read the tile
    }
    named_barrier(kTurnBarrier + w, 2 * 128);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk)
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
    for (int i = 0; i < N / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < kWideKeys / 16; ++kk) pack_a(p[kk], s, kk);

    // O += P V (P from registers, V MN-major through the transpose bit; its
    // first N columns)
    mbar_wait(&full_v[st], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWideKeys / 16; ++kk)
      wgmma_rs_cols<N>(o, p[kk], make_desc(vt + kk * 16 * 128, kKvRegion, 1024, kSw128));
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
    for (int nt = 0; nt < N / 8; ++nt) {   // the head's dh columns only (dh even: whole pairs)
      const int col = 8 * nt + 2 * tig - off[r];
      if (col >= 0 && col < dh)
        *reinterpret_cast<uint32_t*>(out + obase[r] + col) =
            pack_bf16(o[4 * nt + 2 * r] * inv, o[4 * nt + 2 * r + 1] * inv);
    }
  }
}

constexpr int kF32Parts = 4;                  // threads per query row
constexpr int kF32Threads = kQTile * kF32Parts;
constexpr int kF32KTile = 32;

// f32: thread (row, part) owns head dims part, part+4, ... of one query row,
// so the four parts of a row read neighbouring shared-memory banks. A head of
// dh <= D columns is read where it lies, its other columns of the tiles
// zeros, and only its own columns are written. K and V are copied kVec
// floats at a time: 4 (16 bytes, as at the built widths) where dh is a
// multiple of 4, else 2 (dh even: a head of 98 or 102 starts 8-byte aligned).
template <int D, int kVec>
__global__ void __launch_bounds__(kF32Threads)
causal_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int* __restrict__ pad_len,
                      float* __restrict__ out, int S, int Hq, int group, float scale, int dh) {
  constexpr int kPer = D / kF32Parts;
  __shared__ __align__(16) float ks[kF32KTile * D];
  __shared__ __align__(16) float vs[kF32KTile * D];

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQTile;
  const int part = threadIdx.x % kF32Parts;
  const int row = q0 + threadIdx.x / kF32Parts;
  const int hq_w = Hq * dh, hkv_w = (Hq / group) * dh;
  const size_t qbase = (size_t)b * S * hq_w + (size_t)h * dh;
  const size_t kbase = (size_t)b * S * hkv_w + (size_t)(h / group) * dh;
  const int pad = min(max(pad_len[b], 0), S);

  float qr[kPer], o[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int col = kF32Parts * i + part;
    qr[i] = row < S && col < dh ? q[qbase + (size_t)row * hq_w + col] : 0.f;
    o[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const int key_end = min(q0 + kQTile, S);
  if (q0 + kQTile > pad) {
    for (int k0 = (pad / kF32KTile) * kF32KTile; k0 < key_end; k0 += kF32KTile) {
      __syncthreads();
      using Vec = std::conditional_t<kVec == 4, float4, float2>;
      for (int e = threadIdx.x; e < kF32KTile * (D / kVec); e += kF32Threads) {
        const int r = e / (D / kVec), c = kVec * (e % (D / kVec));
        Vec kv{}, vv{};
        if (k0 + r < S && c < dh) {
          const size_t src = kbase + (size_t)(k0 + r) * hkv_w + c;
          kv = *reinterpret_cast<const Vec*>(k + src);
          vv = *reinterpret_cast<const Vec*>(v + src);
        }
        *reinterpret_cast<Vec*>(&ks[r * D + c]) = kv;
        *reinterpret_cast<Vec*>(&vs[r * D + c]) = vv;
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
  for (int i = 0; i < kPer; ++i)
    if (kF32Parts * i + part < dh) out[qbase + (size_t)row * hq_w + kF32Parts * i + part] = o[i] * inv;
}

// The K and V maps of the head-128 kernel at heads of dh: 4-D over
// [B][S][Hkv][dh] where dh is a multiple of 8 other than 128 (by_head), else
// 3-D over [B][S][Hkv*dh] (at 128, as before the narrower heads); boxes of 64
// columns (128 bytes, SW128) x 128 keys; rows past S read as zeros.
bool wide_maps(CUtensorMap& tm_k, CUtensorMap& tm_v, const void* k, const void* v, int B, int S, int Hkv,
               int dh, bool by_head) {
  const uint64_t w = (uint64_t)Hkv * dh;
  if (by_head) {
    const uint64_t dims[4] = {(uint64_t)dh, (uint64_t)Hkv, (uint64_t)S, (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)dh * 2, w * 2, (uint64_t)S * w * 2};
    const uint32_t box[4] = {64, 1, (uint32_t)kWideKeys, 1};
    return tensor_map_4d(&tm_k, k, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B) &&
           tensor_map_4d(&tm_v, v, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  const uint64_t dims[3] = {w, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[2] = {w * 2, (uint64_t)S * w * 2};
  const uint32_t box[3] = {64, (uint32_t)kWideKeys, 1};
  return tensor_map_3d(&tm_k, k, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B) &&
         tensor_map_3d(&tm_v, v, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int N>
int launch_wide(const __nv_bfloat16* q, const void* k, const void* v, const int* pad_len, __nv_bfloat16* out,
                int B, int S, int Hq, int Hkv, int dh, float scale2, cudaStream_t st) {
  const bool by_head = dh % 8 == 0 && dh != 128;
  CUtensorMap tm_k, tm_v;
  if (!wide_maps(tm_k, tm_v, k, v, B, S, Hkv, dh, by_head)) return (int)cudaErrorInvalidValue;
  const cudaError_t opt_in = cudaFuncSetAttribute(
      causal_fwd_bf16_d128_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmemBytes);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const int group = Hq / Hkv;
  const dim3 grid(Hkv, (S * group + kBlockRows - 1) / kBlockRows, B);
  causal_fwd_bf16_d128_kernel<N><<<grid, kWideThreads, kWideSmemBytes, st>>>(
      q, tm_k, tm_v, pad_len, out, S, Hq, group, scale2, dh, by_head);
  return (int)cudaGetLastError();
}

}  // namespace

// Whether the kernels read heads of dh columns where they lie (dh the
// heads' width in memory, Hq / Hkv heads of q / k and v; ops/causal_flash.py's
// causal_reads_in_place mirrors it): in f32 an even dh up to 128; in bf16
// 64, and a dh above 64 at the head-128 kernel: a multiple of 8, or one
// read as a 16-byte aligned window of 128 columns from the head's first
// column rounded down to a multiple of 8, which must fit (at most 8 - the
// lowest set bit of dh columns before the head), over rows of whole chunks
// (Hkv * dh a multiple of 8), with every query head at its kv head's offset
// in the window: one kv head a query head (Hq == Hkv). (The head-64 kernel's
// producer warp issues every K/V copy itself: column-predicated copies there
// measured 1.8x slower at 64.)
static bool reads_in_place(int dh, int Hq, int Hkv, int dtype) {
  if (dh < 2 || dh > 128 || dh % 2) return false;
  if (dtype != FRAG_BF16) return true;
  if (dh <= 64) return dh == 64;
  return dh % 8 == 0 || (dh + 8 - (dh & -dh) <= 128 && Hq == Hkv && (Hkv * dh) % 8 == 0);
}

// q/out [B,S,Hq*D], k/v [B,S,Hkv*D], all bf16 or all f32 (dtype code), 16-byte
// aligned; pad_len int32 [B] on the device; Hq % Hkv == 0. D is a head's
// columns in memory and head_dim its true width, whose 1 / sqrt scales the
// scores: D == head_dim where the heads are read where they lie
// (reads_in_place), else D = 64 or 128 > head_dim, each head zero-padded to
// it by the caller (zero columns add nothing to q.k, and the output's padded
// columns come out zero). Only a head's own columns of `out` are written.
// bf16 heads run at the built width 64 (causal_fwd_bf16_kernel) up to 64
// columns, else at 128 (causal_fwd_bf16_d128_kernel, its products N wide:
// the head's columns and window offset rounded up to 80, 96, 104 or 128).
FRAG_EXPORT int frag_causal_flash(const void* q, const void* k, const void* v, const int* pad_len,
                                  void* out, int B, int S, int Hq, int Hkv, int D, int dtype,
                                  int head_dim, void* stream) {
  if (S < 1 || B < 1 || Hkv < 1 || Hq % Hkv || head_dim < 1 || head_dim > D ||
      !(D == head_dim ? reads_in_place(D, Hq, Hkv, dtype) : D == 64 || D == 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int group = Hq / Hkv;
  if (dtype == FRAG_BF16) {
    const float scale2 = (float)(1.4426950408889634 / sqrt((double)head_dim));
    const auto* qb = static_cast<const __nv_bfloat16*>(q);
    const auto* kb = static_cast<const __nv_bfloat16*>(k);
    const auto* vb = static_cast<const __nv_bfloat16*>(v);
    auto* ob = static_cast<__nv_bfloat16*>(out);
    if (D > 64) {
      // the products' width: the head's columns past the 16-byte column at
      // or below its first (at most 8 - the lowest set bit of D before it)
      const int span = D + (D % 8 ? 8 - (D & -D) : 0);
      if (span <= 80) return launch_wide<80>(qb, kb, vb, pad_len, ob, B, S, Hq, Hkv, D, scale2, st);
      if (span <= 96) return launch_wide<96>(qb, kb, vb, pad_len, ob, B, S, Hq, Hkv, D, scale2, st);
      if (span <= 104) return launch_wide<104>(qb, kb, vb, pad_len, ob, B, S, Hq, Hkv, D, scale2, st);
      return launch_wide<128>(qb, kb, vb, pad_len, ob, B, S, Hq, Hkv, D, scale2, st);
    }
    // above 48 KB of dynamic shared memory a kernel must opt in, on each
    // device it runs on (the attribute is the current device's)
    const cudaError_t opt_in = cudaFuncSetAttribute(causal_fwd_bf16_kernel<64>,
                                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                    CausalTiles<64>::kSmemBytes);
    if (opt_in != cudaSuccess) return (int)opt_in;
    const dim3 grid((S * group + kBlockRows - 1) / kBlockRows, Hkv, B);
    causal_fwd_bf16_kernel<64><<<grid, kBf16Threads, CausalTiles<64>::kSmemBytes, st>>>(
        qb, kb, vb, pad_len, ob, S, Hq, group, scale2);
  } else if (dtype == FRAG_F32) {
    const dim3 grid((S + kQTile - 1) / kQTile, Hq, B);
    const float scale = (float)(1.0 / sqrt((double)head_dim));
    const auto* qf = static_cast<const float*>(q);
    const auto* kf = static_cast<const float*>(k);
    const auto* vf = static_cast<const float*>(v);
    auto* of = static_cast<float*>(out);
    auto f32_kernel = D <= 64 ? (D % 4 ? &causal_fwd_f32_kernel<64, 2> : &causal_fwd_f32_kernel<64, 4>)
                              : (D % 4 ? &causal_fwd_f32_kernel<128, 2> : &causal_fwd_f32_kernel<128, 4>);
    f32_kernel<<<grid, kF32Threads, 0, st>>>(qf, kf, vf, pad_len, of, S, Hq, group, scale, D);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K3: fused BERT feed-forward, forward: y = gelu(x @ W1 + b1) @ W2 + b2.
//
// Replaces financial_rag_tpu/ops/fused_ffn.py:fused_ffn (the Pallas kernel
// _ffn_kernel via _ffn_forward) on [N,H] bf16 tokens with W1 [H,I], W2 [I,H]
// (H = 384, I = 1536 for bge/gte/MiniLM). The [N,I] intermediate never reaches
// device memory: that is the point of the kernel. GELU is the exact erf form
// used by the checkpoints and by the JAX package's own XLA path; the TPU
// kernel's tanh form existed only because Mosaic has no erf. The intermediate
// is cast to x's dtype before the second product, as on the TPU.
//
// Bound on the H100: tensor-core flops. 4*H*I flops per token against
// 4*H bytes of x and y per token: ~1500 flop/byte, far above the ridge. The
// weights (2.36 MB) come from L2 once per token tile, so the tile has to be
// tall enough that this stream stays under the tensor time.
//
// Design (sm_90a): a block takes 128 tokens, one block per SM (197 KB of
// shared memory): two warpgroups of 64 rows, each holding its 64 x 384 f32
// slice of y in registers (192 a thread) across the whole I axis, with no
// block-wide barrier per chunk. Each loads its x rows once (cp.async, zeros
// past N, the 128-byte swizzle). The I axis is walked in 32-wide chunks
// through a ring of 2 stages: thread 0 has the TMA copy the chunk's W1
// columns [384][32] (64-byte swizzle, 2 boxes) and W2 rows [32][384]
// (128-byte swizzle, 6 boxes), the same layouts the products read, and
// publishes them through the stage's full mbarrier (transaction bytes); it
// issues chunk t+1 right after its warpgroup issued chunk t's first
// product, once every thread released the stage through the empty
// mbarrier. Per chunk a warpgroup runs h = x W1c (wgmma m64n32k16, x
// K-major, W1c [k][n] read MN-major through the transpose bit), adds b1,
// applies erf GELU and rounds to bf16 in registers, then y += h W2c with h
// as the register A operand (the accumulator's layout is the A-fragment
// layout: pack_a) and W2c [k][n] read MN-major (3 x wgmma m64n128k16).
// Neither weight is transposed in memory, and h never touches shared
// memory. The two warpgroups run free, so one's GELU overlaps the other's
// products.
//
// Tried on the H100 and dropped, each slower: a producer warp or warpgroup
// (ptxas caps a block of more than 256 threads at 168 registers a thread,
// and allocated a setmaxnreg split at that cap as well, so the
// 192-register accumulator spilled and its wgmmas were serialised, C7512;
// at 256 threads the kernel takes up to 255 registers and does not spill);
// cp.async by every thread (each one's 12 copies a chunk and their
// addresses sat on the products' issue path); strict turn-taking between
// the warpgroups; issuing a chunk's second product together with the next
// chunk's first (serialised, C7520); and a 2-block cluster sharing each
// chunk by TMA multicast (half the L2 stream, but each block then waits for
// the other's release of every stage).
//
// What still holds it back: the first product is m64n32k16 with x read
// from shared memory for every 32 columns of the chunk, and each
// warpgroup's chain of first product, GELU and second product is serial,
// with two warpgroups an SM to overlap. Wider chunks need more shared
// memory than the x tile leaves.
//
// At hidden 768 (bge-base / gte-base, I = 3,072) that design does not fit:
// a warpgroup's 64 x 768 f32 slice of y would take 384 registers a thread,
// and a 128 x 768 bf16 x tile alone is 192 KB. ffn_wide_kernel takes 64
// tokens a block (x: 96 KB, loaded once by cp.async), and each warpgroup
// owns half of y's columns (192 accumulator registers a thread). The I
// axis is walked in 64-wide chunks. Per chunk each warpgroup computes its
// 32 columns of h = x W1c (48 x wgmma m64n32k16; W1c [k][n] in 128-byte
// rows, read MN-major from its 64-byte half), adds b1, applies erf GELU,
// rounds to bf16 and stores them into a 64 x 64 h tile in shared memory
// (128-byte swizzle; two tiles, for even and odd chunks). After a barrier
// of the two warpgroups, each adds h W2c to its half of y (4 k16 steps x 3
// wgmma m64n128k16, h the shared-memory A operand, W2c MN-major). So h is
// computed once (1.0x the flops of one pass), x is read from shared
// memory once per 32 columns of h, not per 16, and h never touches device
// memory. The weights stream through a ring of 4 stages of 24 KB, one TMA
// copy a slab, the 8 warps issuing in turn (prefetch.tensormap first): a
// chunk is 4 W1 slabs (192 rows of its 64 columns) and 4 W2 slabs (16 rows
// of 768 columns, a 3-D box of 12 column blocks), in the order of the
// products: W1 of chunk t, then W2 of chunk t-1, so chunk t's GELU runs
// while chunk t-1's last W2 slab is in the tensor cores. Lane 0 of each
// warp releases a slab through the stage's empty mbarrier once its
// products ended, and the stage is refilled 3 slabs ahead. A query-time
// call has few tokens (8 x 64 = 512: 8 tiles for 132 SMs), so the I axis
// is also split over `splits` blocks per tile (grid.y), as many as fit the
// SMs in one wave (16 of 3 chunks at 512: 128 blocks); each writes its f32
// partial of y to scratch, and a second kernel sums them in split order,
// adds b2 and rounds, so two calls give the same bits.
//
// What bounds it on the H100 (kernel_ab.py against copies of this source
// with one thing changed, NVIDIA H100 80GB HBM3, 700 W, N = 131,072): the
// ring's cost per slab, not its bytes. Every 64-token block receives all
// of W1 and W2, 9.4 MB (each byte feeds only 64 flops), and the ring lands
// about one 24 KB slab per 0.5 us on each SM: without its products (the
// pipeline alone) the kernel took 3.02 ms beside its 3.71, and 2.94-2.98
// with W2's slabs at half their bytes. One TMA issue costs its thread
// hundreds of cycles (an instrumented copy), and a stage is refilled only
// once all 8 warps released it. With 3 stages the pipeline alone took 3.23 against
// 3.02 with 4, and with 2 stages 5.37; with its products on stale slabs
// and no refills the kernel took 2.95 beside 4.35.
//
// Tried on the H100 and dropped (device ms at N = 131,072 unless said):
// clusters of 2 and 4 blocks on adjacent tiles, each issuing its share of
// every slab by TMA multicast (half or a quarter of the L2 stream): 4.05
// and 4.57 against 3.90-4.00 without (each block still receives every
// byte; at N=512 a cluster of 4 leaves blocks for a second wave, 0.0559
// against 0.0352), and a cluster-scope release on every remote arrive
// took 8.2 (5.07 without it, in the next call); 2 slabs' products in
// flight (wgmma.wait_group 1): ptxas serialised the wgmmas (C7517, C7518)
// and it ran 6.10 against 4.90;
// a producer warp (288 threads) or warpgroup (384 threads, setmaxnreg 24 /
// 240): ptxas allocated 168 registers and spilled, 18.7-20.4; a W1 slab as
// two 32-column boxes in the 64-byte swizzle: 3.98 against 3.85 as one;
// thread 128 issuing the W2 slabs beside thread 0 the W1 ones: 4.51
// against 4.32 (thread 0 issuing all of them then; the 8 warps in turn:
// 3.73-3.81 against 3.84-3.96); mbar_wait reading the timer only after a
// failed try: 3.83-3.85 against 3.69-4.07.
//
// At hidden 1,024 (bge-large / gte-large, I = 4,096) the 768 design cannot
// be widened: half of y's columns would be 64 x 512 f32, 256 accumulator
// registers a thread (ptxas allows 255, before h and any address), and the
// x tile alone is 64 x 1,024 bf16 = 128 KB of the 227 KB. ffn_wide_kernel<
// 1024> keeps the 768 design's block (64 tokens, two warpgroups, 64-wide
// I chunks, two 8 KB h tiles, the ring and the I-axis split) and walks the
// I axis twice: pass p accumulates y's columns 512p .. 512p + 511, 256 a
// warpgroup (128 registers a thread), and recomputes h, so the block does
// 1.5x the function's flops. x is loaded once for both passes. A ring
// slab is 16 KB (128 rows of W1's 64-column chunk, or 16 rows of W2's 512
// columns of the pass), 5 stages: 128 + 16 + 80 + 1 KB = 225 KB. The ring
// runs on from one pass into the next; a barrier of the two warpgroups at
// the start of the second pass keeps its h stores behind the first pass's
// last reads. Still no [N, I] intermediate: the only scratch is the f32
// partials of y when the I axis is split.
//
// What bounds it on the H100 (kernel_ab.py, NVIDIA H100 80GB HBM3, 700 W):
// the ring's cost per slab, as at 768. 14.63 ms at N = 131,072 against a
// 2.22 ms bound (3.34 ms for the 1.5x flops): 2,048 blocks of 1,536 slabs
// on 132 SMs land one slab per ~0.61 us on each SM, about the 768
// design's rate for its 24 KB slabs. 24 KB slabs do not divide W1's 1,024
// rows into whole k16 steps, and 32 KB ones leave 2 stages beside the x
// tile (2 stages ran 1.8x slower than 4 at 768).
//
// Considered and not built: a cluster of 2 blocks that each own 512 of y's
// columns and compute half of each h chunk, exchanged through distributed
// shared memory (1.0x the flops; x 128 KB and two h tiles a block leave
// about 80 KB for a ring of 24 KB slabs). It waits on a remote h tile
// every chunk, and the 768 design's clusters measured slower than none.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kH = 384;                  // hidden width of ffn_fwd_kernel
constexpr int kRows = 64;                // token rows per consumer warpgroup
constexpr int kConsumers = 2;
constexpr int kTokens = kRows * kConsumers;  // tokens per block
constexpr int kChunk = 32;               // width of one I chunk
constexpr int kStages = 2;
constexpr int kThreads = kConsumers * 128;
constexpr int kXRegion = kRows * 128;    // 64 rows x 64 features (128 bytes), SW128
constexpr int kXBytes = kRows * kH * 2;  // one warpgroup's x rows: 6 regions
constexpr int kW1Bytes = kH * kChunk * 2;     // W1 chunk [384][32], SW64
constexpr int kW2Region = kChunk * 128;       // 32 rows x 64 columns (128 bytes), SW128
constexpr int kW2Bytes = kChunk * kH * 2;     // W2 chunk [32][384]: 6 regions
constexpr int kStageBytes = kW1Bytes + kW2Bytes;
constexpr int kSmemBytes = kConsumers * kXBytes + kStages * kStageBytes + 1024;  // + alignment
constexpr int kReduceThreads = 256;

// erf by Abramowitz & Stegun 7.1.26, |error| <= 1.5e-7 (the rounding of h to
// bf16 is 2^-9 relative): one reciprocal, one ex2 and 6 FMAs, about a third
// of erff's instructions; GELU sits between the two products of every chunk
__device__ __forceinline__ float erf_as(float x) {
  const float a = fabsf(x);
  float t;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(fmaf(0.3275911f, a, 1.f)));
  float p = fmaf(1.061405429f, t, -1.453152027f);
  p = fmaf(p, t, 1.421413741f);
  p = fmaf(p, t, -0.284496736f);
  p = fmaf(p, t, 0.254829592f);
  return copysignf(fmaf(-p * t, ex2(-a * a * kLog2e), 1.f), x);
}
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erf_as(v * 0.70710678118654752440f));
}


__global__ void __launch_bounds__(kThreads, 1)
ffn_fwd_kernel(const __nv_bfloat16* __restrict__ x, const __grid_constant__ CUtensorMap tm_w1,
               const __nv_bfloat16* __restrict__ b1, const __grid_constant__ CUtensorMap tm_w2,
               const __nv_bfloat16* __restrict__ b2, __nv_bfloat16* __restrict__ y,
               float* __restrict__ partial, int N, int I, int splits) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const uint32_t sX = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sRing = sX + kConsumers * kXBytes;  // stage st: W1 chunk, then W2 chunk

  const int span = I / splits;  // this block's range of the I axis
  const int c_begin = blockIdx.y * span, nchunks = span / kChunk;
  const int m0 = blockIdx.x * kTokens;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = warp >> 2;      // warpgroup

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);          // thread 0's expect_tx; then the chunk's bytes
      mbar_init(&empty[st], kThreads);  // every thread, once its products of the chunk ended
    }
    mbar_init_fence();
  }
  __syncthreads();

  // thread 0: chunk t's W1 columns (2 boxes of 192 x 32) and W2 rows (6
  // boxes of 32 x 64) into stage t % kStages by TMA
  auto fetch = [&](int t) {
    const int st = t % kStages, c0 = c_begin + t * kChunk;
    const uint32_t w1t = sRing + st * kStageBytes, w2t = w1t + kW1Bytes;
    mbar_expect_tx(&full[st], kStageBytes);
    tma_load_2d(w1t, &tm_w1, c0, 0, &full[st]);
    tma_load_2d(w1t + kW1Bytes / 2, &tm_w1, c0, kH / 2, &full[st]);
#pragma unroll
    for (int j = 0; j < kH / 64; ++j) tma_load_2d(w2t + j * kW2Region, &tm_w2, 64 * j, c0, &full[st]);
  };
  if (threadIdx.x == 0) fetch(0);
  // this warpgroup's 64 token rows, zeros past N
  const uint32_t xt = sX + w * kXBytes;
  for (int e = threadIdx.x & 127; e < kRows * (kH / 8); e += 128) {
    const int r = e / (kH / 8), ch = e % (kH / 8), row = m0 + w * kRows + r;
    const bool ok = row < N;
    cp_async16(xt + sw128_chunk(r, ch), x + (size_t)(ok ? row : 0) * kH + 8 * ch, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  named_barrier(1 + w, 128);

  const int gid = lane >> 2, tig = lane & 3;
  // operand descriptors, built once and advanced by each k step's offset
  const uint64_t x_desc = make_desc(xt, 16, 1024, kSw128);
  float acc[3][64];  // y columns 128*nb .. +127
#pragma unroll
  for (int nb = 0; nb < 3; ++nb) zero(acc[nb]);
  for (int t = 0; t < nchunks; ++t) {
    const int st = t % kStages;
    const int c0 = c_begin + t * kChunk;
    // b1 at this thread's 8 columns of the chunk, 8*(q/2) + 2*tig + q%2: h[i]
    // is column 8*(i/4) + 2*tig + i%2, so its bias is bb[2*(i/4) + i%2]
    __nv_bfloat16 bb[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) bb[q] = b1[c0 + 8 * (q >> 1) + 2 * tig + (q & 1)];
    mbar_wait(&full[st], (t / kStages) & 1);  // chunk t landed
    const uint32_t w1t = sRing + st * kStageBytes, w2t = w1t + kW1Bytes;
    const uint64_t w1_desc = sw64_mnmajor(w1t, 0), w2_desc = make_desc(w2t, kW2Region, 1024, kSw128);

    // h = x @ W1[:, c0:c0+32]
    float h[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kH / 16; ++kk)
      wgmma_ss_n32_tb(h, desc_add(x_desc, (kk >> 2) * kXRegion + (kk & 3) * 32),
                      desc_add(w1_desc, 1024 * kk), kk > 0);
    wgmma_commit();
    // meanwhile chunk t+1 into the stage chunk t-1 used, once both
    // warpgroups released it
    if (threadIdx.x == 0 && t + 1 < nchunks) {
      if (t + 1 >= kStages) mbar_wait(&empty[(t + 1) % kStages], ((t + 1) / kStages - 1) & 1);
      fetch(t + 1);
    }
    wgmma_wait<0>();
    fence_acc(h);

    // + b1, erf GELU, bf16: the A operand of the second product
#pragma unroll
    for (int i = 0; i < 16; ++i) h[i] = gelu_erf(h[i] + __bfloat162float(bb[2 * (i >> 2) + (i & 1)]));
    uint32_t a[2][4];
    pack_a(a[0], h, 0);
    pack_a(a[1], h, 1);

    // y += h @ W2[c0:c0+32, :]
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < 3; ++nb)
        wgmma_rs_n128(acc[nb], a[kk], desc_add(w2_desc, nb * 2 * kW2Region + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < 3; ++nb) fence_acc(acc[nb]);
    mbar_arrive(&empty[st]);
  }

  // acc[nb][4*j + e]: row 16*(warp%4) + gid + 8*(e/2), column 128*nb + 8*j + 2*tig + e%2
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + w * kRows + 16 * (warp & 3) + gid + 8 * r;
    if (row >= N) continue;
#pragma unroll
    for (int nb = 0; nb < 3; ++nb)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 128 * nb + 8 * j + 2 * tig;
        const float v0 = acc[nb][4 * j + 2 * r], v1 = acc[nb][4 * j + 2 * r + 1];
        if (splits == 1) {
          *reinterpret_cast<uint32_t*>(y + (size_t)row * kH + col) =
              pack_bf16(v0 + __bfloat162float(b2[col]), v1 + __bfloat162float(b2[col + 1]));
        } else {
          *reinterpret_cast<float2*>(partial + ((size_t)blockIdx.y * N + row) * kH + col) =
              make_float2(v0, v1);
        }
      }
  }
}

// hidden 768 and 1,024: 64 tokens a block; per I chunk each warpgroup
// computes half of h's columns, both halves meet in shared memory, and each
// warpgroup adds h W2 to its half of the pass's y columns. At 768 one pass
// covers all of y; at 1,024 two passes of 512 columns each walk the whole
// I axis (h computed again in the second), since 512 columns a warpgroup
// would take 256 accumulator registers a thread.
constexpr int kWH = 768;
constexpr int kWRows = 64;                        // tokens per block
constexpr int kWHalf = kWH / kConsumers;          // y columns a warpgroup owns
constexpr int kWChunk = 64;                       // width of one I chunk
constexpr int kWHCols = kWChunk / kConsumers;     // h columns a warpgroup computes
constexpr int kWXBytes = kWRows * kWH * 2;        // x rows: 12 regions of 64 x 128 bytes, SW128
constexpr int kWHBytes = kWRows * kWChunk * 2;    // one h tile: 64 rows x 128 bytes, SW128
constexpr int kWSlabBytes = kWH * 16 * 2;         // one ring stage: a W1 or a W2 slab, 24 KB
constexpr int kWW1Rows = kWSlabBytes / (kWChunk * 2);  // W1 rows (k) a W1 slab holds: 192 x 128 bytes, SW128
constexpr int kWW1Slabs = kWH / kWW1Rows;         // W1 slabs a chunk
constexpr int kWW2Rows = 16;                      // W2 rows (k) a W2 slab holds: one k16 step
constexpr int kWW2Region = kWW2Rows * 128;        // 16 rows x 64 columns (128 bytes), SW128
constexpr int kWW2Slabs = kWChunk / kWW2Rows;     // W2 slabs a chunk
constexpr int kWSlabs = kWW1Slabs + kWW2Slabs;    // slabs a chunk
constexpr int kWStages = 4;
constexpr int kWSmemBytes = kWXBytes + 2 * kWHBytes + kWStages * kWSlabBytes + 1024;  // + alignment
// hidden 1,024: the same 64 tokens, chunks and h tiles, y in two passes
constexpr int kLH = 1024;
constexpr int kLPasses = 2;
constexpr int kLPassCols = kLH / kLPasses;        // y columns a pass: 512
constexpr int kLHalf = kLPassCols / kConsumers;   // of them a warpgroup owns: 256 (128 registers)
constexpr int kLXBytes = kWRows * kLH * 2;        // x rows: 16 regions, 128 KB
constexpr int kLSlabBytes = kLPassCols * 16 * 2;  // one ring stage: 16 KB
constexpr int kLW1Rows = kLSlabBytes / (kWChunk * 2);  // W1 rows a W1 slab holds: 128
constexpr int kLW1Slabs = kLH / kLW1Rows;         // W1 slabs a chunk and pass: 8
constexpr int kLSlabs = kLW1Slabs + kWW2Slabs;    // slabs a chunk and pass: 12
constexpr int kLStages = 5;
constexpr int kLSmemBytes = kLXBytes + 2 * kWHBytes + kLStages * kLSlabBytes + 1024;  // + alignment

template <int H>
struct Wide {
  static_assert(H == kWH || H == kLH, "the wide designs take hidden 768 or 1,024");
  static constexpr bool kLarge = H == kLH;
  static constexpr int kPasses = kLarge ? kLPasses : 1;
  static constexpr int kPassCols = H / kPasses;         // y columns a pass: 768 or 512
  static constexpr int kHalf = kPassCols / kConsumers;  // of them a warpgroup owns: 384 or 256
  static constexpr int kNB = kHalf / 128;               // its n128 accumulators: 3 or 2
  static constexpr int kRows = kWRows, kChunk = kWChunk, kHCols = kWHCols, kHBytes = kWHBytes;
  static constexpr int kXBytes = kLarge ? kLXBytes : kWXBytes;
  static constexpr int kSlabBytes = kLarge ? kLSlabBytes : kWSlabBytes;
  static constexpr int kW1Rows = kLarge ? kLW1Rows : kWW1Rows;
  static constexpr int kW1Slabs = kLarge ? kLW1Slabs : kWW1Slabs;
  static constexpr int kW2Rows = kWW2Rows, kW2Region = kWW2Region, kW2Slabs = kWW2Slabs;
  static constexpr int kSlabs = kLarge ? kLSlabs : kWSlabs;
  static constexpr int kStages = kLarge ? kLStages : kWStages;
  static constexpr int kSmemBytes = kLarge ? kLSmemBytes : kWSmemBytes;
  static_assert(kSlabBytes == kPassCols * kW2Rows * 2 && kSlabBytes == kW1Rows * kChunk * 2 &&
                H % kW1Rows == 0, "a slab is whole k16 steps of W1's chunk or of W2's pass");
};

// The ring's slab s of a block that walks T chunks a pass: W1 slab j of
// chunk t (rows kW1Rows*j ..), or W2 slab j of chunk t (rows kW2Rows*j
// ..) in pass `pass`. A pass's order is the order of its products: W1 of
// chunk 0, then per chunk t > 0 W1 of t and W2 of t - 1, then W2 of the
// last chunk (kSlabs * T slabs); the passes follow each other.
template <int H>
__device__ __forceinline__ void wide_slab(int s, int T, int& pass, bool& w2, int& t, int& j) {
  using W = Wide<H>;
  pass = 0;
  if constexpr (W::kPasses > 1) {
    pass = s / (W::kSlabs * T);
    s -= pass * W::kSlabs * T;
  }
  if (s < W::kW1Slabs) {
    w2 = false, t = 0, j = s;
    return;
  }
  const int r = s - W::kW1Slabs, it = r / W::kSlabs + 1, q = r % W::kSlabs;
  if (it < T && q < W::kW1Slabs)
    w2 = false, t = it, j = q;
  else
    w2 = true, t = it - 1, j = it < T ? q - W::kW1Slabs : q;
}

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
ffn_wide_kernel(const __nv_bfloat16* __restrict__ x, const __grid_constant__ CUtensorMap tm_w1,
                const __nv_bfloat16* __restrict__ b1, const __grid_constant__ CUtensorMap tm_w2,
                const __nv_bfloat16* __restrict__ b2, __nv_bfloat16* __restrict__ y,
                float* __restrict__ partial, int N, int I, int splits) {
  using W = Wide<H>;
  constexpr int kStages = W::kStages, kSlabBytes = W::kSlabBytes, kNB = W::kNB;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const uint32_t sX = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sH = sX + W::kXBytes;         // h tiles of even and odd chunks
  const uint32_t sRing = sH + 2 * W::kHBytes;

  const int span = I / splits;  // this block's range of the I axis
  const int c_begin = blockIdx.y * span, T = span / W::kChunk;
  const int total = W::kPasses * W::kSlabs * T;
  const int m0 = blockIdx.x * W::kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;     // warpgroup: h columns kHCols*wg .., y columns kHalf*wg .. of a pass

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);                // the filling thread's expect_tx; then the slab's bytes
      mbar_init(&empty[st], kThreads / 32);  // lane 0 of every warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // slab s into stage s % kStages by TMA, one copy each: a W1 slab's
  // kW1Rows rows of the chunk's 64 columns, a W2 slab's 16 rows as the
  // pass's kPassCols / 64 blocks of 64 columns
  auto fill = [&](int s) {
    int pass, t, j;
    bool w2;
    wide_slab<H>(s, T, pass, w2, t, j);
    const int st = s % kStages, c0 = c_begin + t * W::kChunk;
    const uint32_t dst = sRing + st * kSlabBytes;
    mbar_expect_tx(&full[st], kSlabBytes);
    if (w2)
      tma_load_3d(dst, &tm_w2, 0, c0 + W::kW2Rows * j, pass * (W::kPassCols / 64), &full[st]);
    else
      tma_load_2d(dst, &tm_w1, c0, W::kW1Rows * j, &full[st]);
  };
  if (lane == 0) {
    prefetch_tensor_map(&tm_w1);
    prefetch_tensor_map(&tm_w2);
  }
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages && s < total; ++s) fill(s);
  // the block's 64 token rows, zeros past N, by all 256 threads, once for
  // every pass
  for (int e = threadIdx.x; e < W::kRows * (H / 8); e += kThreads) {
    const int r = e / (H / 8), ch = e % (H / 8), row = m0 + r;
    const bool ok = row < N;
    cp_async16(sX + sw128_chunk(r, ch), x + (size_t)(ok ? row : 0) * H + 8 * ch, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  // Before slab s's products: the warpgroup's products of slab s - 1 have
  // ended, and this warp releases it; then wait for slab s. After them,
  // lane 0 of warp f % 8 refills the stage released with slab f = s - 1 +
  // kStages once every warp released it (the warps take turns: one TMA
  // issue costs its warp hundreds of cycles).
  auto begin_slab = [&](int s) {
    wgmma_wait<0>();
    if (s > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(s - 1) % kStages]);
    }
    mbar_wait(&full[s % kStages], (s / kStages) & 1);
    wgmma_fence();
  };
  auto end_slab = [&](int s) {
    wgmma_commit();
    const int f = s - 1 + kStages;
    if (lane == 0 && warp == f % (kThreads / 32) && s > 0 && f < total) {
      mbar_wait(&empty[f % kStages], (f / kStages - 1) & 1);
      fill(f);
    }
    __syncwarp();
  };

  const int gid = lane >> 2, tig = lane & 3;
  const uint64_t x_desc = make_desc(sX, 16, 1024, kSw128);
  int s = 0;         // the next slab
  for (int pass = 0; pass < W::kPasses; ++pass) {
    // the other warpgroup's products of the last pass no longer read the h tiles
    if (pass > 0) named_barrier(1, kThreads);
    float acc[kNB][64];  // y columns kPassCols*pass + kHalf*wg + 128*nb .. +127
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) zero(acc[nb]);
    // the zeros here, not sunk into the first second product's issue (ptxas
    // then serialises the wgmmas, C7515)
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) fence_acc(acc[nb]);
    float h[16];       // h columns kHCols*wg .. of the chunk
    for (int t = 0; t <= T; ++t) {
      if (t < T) {
        // h = x @ W1[:, this warpgroup's 32 columns of chunk t], slab by slab:
        // W1 [k][n] in 128-byte rows read MN-major, this half 64 bytes in
#pragma unroll
        for (int j = 0; j < W::kW1Slabs; ++j, ++s) {
          begin_slab(s);
          const uint64_t w1_desc =
              make_desc(sRing + (s % kStages) * kSlabBytes + wg * W::kHCols * 2, 8192, 1024, kSw128);
#pragma unroll
          for (int kk = 0; kk < W::kW1Rows / 16; ++kk) {
            const int k = j * (W::kW1Rows / 16) + kk;
            wgmma_ss_n32_tb(h, desc_add(x_desc, (k >> 2) * kXRegion + (k & 3) * 32),
                            desc_add(w1_desc, 16 * 128 * kk), j > 0 || kk > 0);
          }
          end_slab(s);
        }
      }
      if (t > 0) {
        // y[:, this pass's half] += h(t-1) @ W2[chunk t-1, this half], once
        // both warpgroups stored their halves of h(t-1)
        named_barrier(1, kThreads);
        const uint64_t h_desc = make_desc(sH + ((t - 1) & 1) * W::kHBytes, 16, 1024, kSw128);
#pragma unroll
        for (int j = 0; j < W::kW2Slabs; ++j, ++s) {
          begin_slab(s);
          const uint64_t w2_desc = make_desc(
              sRing + (s % kStages) * kSlabBytes + wg * (W::kHalf / 64) * W::kW2Region,
              W::kW2Region, 1024, kSw128);
#pragma unroll
          for (int nb = 0; nb < kNB; ++nb)
            wgmma_ss_n128_tb(acc[nb], desc_add(h_desc, 32 * j),
                             desc_add(w2_desc, nb * 2 * W::kW2Region));
          end_slab(s);
        }
      } else {
        wgmma_wait<0>();
      }
      if (t < T) {
        // chunk t's first product has ended (the waits before the second
        // product's slabs, or the one above at t = 0): + b1, erf GELU, bf16,
        // into h tile t % 2 while the last slab of the second product runs.
        // b1 at this thread's 8 columns, 8*(q/2) + 2*tig + q%2: h[i] is
        // column 8*(i/4) + 2*tig + i%2, so its bias is bb[2*(i/4) + i%2]
        const int c0 = c_begin + t * W::kChunk + W::kHCols * wg;
        __nv_bfloat16 bb[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) bb[q] = b1[c0 + 8 * (q >> 1) + 2 * tig + (q & 1)];
        fence_acc(h);
        const uint32_t ht = sH + (t & 1) * W::kHBytes;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int i = 4 * jj + 2 * hf, row = 16 * (warp & 3) + gid + 8 * hf;
            const float v0 = gelu_erf(h[i] + __bfloat162float(bb[2 * jj]));
            const float v1 = gelu_erf(h[i + 1] + __bfloat162float(bb[2 * jj + 1]));
            st_shared_u32(ht + swz<3>(row * 128 + (W::kHCols / 8 * wg + jj) * 16) + 4 * tig,
                          pack_bf16(v0, v1));
          }
        fence_proxy_async();   // the stores, before the second product reads them
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) fence_acc(acc[nb]);

    // acc[nb][4*j + e]: row 16*(warp%4) + gid + 8*(e/2), column
    // kPassCols*pass + kHalf*wg + 128*nb + 8*j + 2*tig + e%2
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 16 * (warp & 3) + gid + 8 * r;
      if (row >= N) continue;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = W::kPassCols * pass + W::kHalf * wg + 128 * nb + 8 * j + 2 * tig;
          const float v0 = acc[nb][4 * j + 2 * r], v1 = acc[nb][4 * j + 2 * r + 1];
          if (splits == 1) {
            *reinterpret_cast<uint32_t*>(y + (size_t)row * H + col) =
                pack_bf16(v0 + __bfloat162float(b2[col]), v1 + __bfloat162float(b2[col + 1]));
          } else {
            *reinterpret_cast<float2*>(partial + ((size_t)blockIdx.y * N + row) * H + col) =
                make_float2(v0, v1);
          }
        }
    }
  }
}

// y[n, c] = bf16(sum over s of partial[s, n, c], in s order, + b2[c])
template <int H>
__global__ void __launch_bounds__(kReduceThreads)
ffn_reduce_kernel(const float* __restrict__ partial, const __nv_bfloat16* __restrict__ b2,
                  __nv_bfloat16* __restrict__ y, int N, int splits) {
  const size_t total = (size_t)N * H;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += partial[(size_t)s * total + e];
    y[e] = __float2bfloat16(v + __bfloat162float(b2[e % H]));
  }
}

// The first kernel (one of the designs above), then, when the I axis is
// split, the reduce.
template <int H>
int launch_ffn(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               void* y, float* partial, int N, int I, int splits, cudaStream_t st) {
  constexpr bool wide = H != kH;
  using W = Wide<wide ? H : 768>;
  constexpr int chunk = wide ? W::kChunk : kChunk, tokens = wide ? W::kRows : kTokens;
  constexpr int smem = wide ? W::kSmemBytes : kSmemBytes;
  if (N < 1 || splits < 1 || I % splits || (I / splits) % chunk || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory a kernel must opt in, on each
  // device it runs on (the attribute is the current device's)
  const cudaError_t opt_in =
      wide ? cudaFuncSetAttribute(ffn_wide_kernel<wide ? H : 768>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
           : cudaFuncSetAttribute(ffn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  // 384: W1 [H][I] in boxes of 192 x 32, W2 [I][H] in boxes of 32 x 64;
  // 768 / 1,024: W1 in boxes of kW1Rows x 64 (a slab), W2 as [64-column
  // block][I][64] in boxes of a pass's kPassCols / 64 blocks of 16 x 64 (a
  // slab)
  CUtensorMap tm_w1, tm_w2;
  const uint64_t w2_dims[3] = {64, (uint64_t)I, H / 64}, w2_strides[2] = {H * 2, 128};
  const uint32_t w2_box[3] = {64, W::kW2Rows, W::kPassCols / 64};
  const bool mapped =
      wide ? hopper::tensor_map_2d(&tm_w1, w1, H, I, W::kW1Rows, W::kChunk, CU_TENSOR_MAP_SWIZZLE_128B) &&
                 hopper::tensor_map_3d(&tm_w2, w2, w2_dims, w2_strides, w2_box, CU_TENSOR_MAP_SWIZZLE_128B)
           : hopper::tensor_map_2d(&tm_w1, w1, H, I, H / 2, kChunk, CU_TENSOR_MAP_SWIZZLE_64B) &&
                 hopper::tensor_map_2d(&tm_w2, w2, I, H, kChunk, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!mapped) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + tokens - 1) / tokens, splits);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* b1b = static_cast<const __nv_bfloat16*>(b1);
  const auto* b2b = static_cast<const __nv_bfloat16*>(b2);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if constexpr (wide)
    ffn_wide_kernel<H><<<grid, kThreads, smem, st>>>(xb, tm_w1, b1b, tm_w2, b2b, yb, partial, N, I, splits);
  else
    ffn_fwd_kernel<<<grid, kThreads, smem, st>>>(xb, tm_w1, b1b, tm_w2, b2b, yb, partial, N, I, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int blocks = (int)(((size_t)N * H + kReduceThreads - 1) / kReduceThreads);
  ffn_reduce_kernel<H><<<blocks, kReduceThreads, 0, st>>>(
      partial, static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(y), N, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes: x/y [N,H], w1 [H,I], b1 [I], w2 [I,H], b2 [H], all bf16, row-major,
// x, w1 and w2 16-byte aligned; partial [splits,N,H] f32 scratch (unused when
// splits is 1). Any N >= 1; H == 384 with (I / splits) % 32 == 0, or H ==
// 768 or 1,024 with (I / splits) % 64 == 0.
FRAG_EXPORT int frag_fused_ffn(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* y, float* partial,
                               int N, int H, int I, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case kH: return launch_ffn<kH>(x, w1, b1, w2, b2, y, partial, N, I, splits, st);
    case kWH: return launch_ffn<kWH>(x, w1, b1, w2, b2, y, partial, N, I, splits, st);
    case kLH: return launch_ffn<kLH>(x, w1, b1, w2, b2, y, partial, N, I, splits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

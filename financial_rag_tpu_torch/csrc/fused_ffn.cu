// K3: fused BERT feed-forward, forward: y = gelu(x @ W1 + b1) @ W2 + b2.
//
// Replaces financial_rag_tpu/ops/fused_ffn.py:fused_ffn (the Pallas kernel
// _ffn_kernel via _ffn_forward) on [N,H] bf16 tokens with W1 [H,I], W2 [I,H]
// (H = 384, I = 1536 for bge/gte/MiniLM). At hidden 384 and 768 the [N,I]
// intermediate never reaches device memory, as on the TPU; at 1,024 it does
// (the last section says why). GELU is the exact erf form
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
// At hidden 1,024 (bge-large / gte-large, I = 4,096) a design that keeps h
// on chip does not fit the block: half of y's columns over 64 tokens would
// be 256 f32 registers a thread (ptxas grants 168 above 256 threads, 255
// below, before h and any address), and the 64-token x tile alone is 128 KB
// of the 227 KB. The first design at 1,024 (the 768 block walking the I
// axis twice, 512 y columns a pass, h recomputed: 1.5x the flops) ran at
// its ring's ~0.61 us a 16 KB slab an SM: 14.6-14.9 ms at N = 131,072
// against a 2.22 ms bound (kernel_ab.py device ms, NVIDIA H100 80GB HBM3,
// 700.00 W). So at 1,024 h goes through device memory. The TPU kernel keeps
// it out because there the [N, I] round trip was ~40% of a layer
// (financial_rag_tpu/ops/fused_ffn.py:3-8); on the H100 writing and reading
// h is 2 x I x 2 = 16 KB a token against 4 x H x I = 16.8 MFLOP, ~1,000 flop
// a byte, 3.5x the bf16 ridge (~295): 2.15 GB at N = 131,072 is 0.64 ms at
// 3.35 TB/s beside the 2.22 ms of the products, and it streams under them.
// The rounding points stay the TPU kernel's: h = bf16(gelu(x W1 + b1)) with
// the f32 bias and GELU, y = bf16(h W2 + b2).
//
// Design (ffn_large_kernel below, launched twice and, at a query's sizes,
// with ffn_reduce_kernel<1024>): a GEMM with its epilogue fused, on tiles
// of 128 tokens by 256 output columns (128 where 256-column tiles would
// leave SMs idle), K walked 64 deep. 384 threads: two consumer warpgroups
// of 64 rows, each holding 64 x 256 f32 (128 accumulator registers a
// thread, under the 168 cap; the producer designs tried at 768 and in K9
// spilled with 192-256), and a producer warpgroup whose thread 256 issues
// the TMA copies into a ring of 4 stages of 48 KB (6 of 32 KB). A
// persistent grid of one block an SM walks the units, columns fastest, so
// the blocks at work share A rows and all of B in L2. The epilogue adds
// the bias (and GELU) in registers, stages 128 columns at a time as bf16
// in shared memory and writes them by TMA store, which runs on under the
// next unit's products; the second product, split along K at a query's few
// tiles, writes f32 partials instead, summed in split order.
//
// What bounds it (kernel_ab.py device ms, NVIDIA H100 80GB HBM3, 700.00 W,
// I = 4,096): at N = 131,072 the two products take 2.21 and 1.47-1.49 ms
// (3.69-3.70 in all, 1.66x the 2.22 bound, 0.92x the three calls' cuBLAS,
// GELU, cuBLAS 4.03; the first design 14.6-14.8). Their main loops alone
// (a copy without epilogues) take 1.39-1.46 ms each, ~78% of the bf16
// peak for their 1.11 ms of products. The rest is the first product's
// epilogue, ~0.9 ms, which the tensor cores wait for: at K = 1,024 each of
// its outputs carries 2,048 flops (8,192 in the second), and its erf GELU
// alone is ~0.65 ms (a copy without it: 1.73-1.76 against 2.38-2.41). At
// N = 34,816 (a bge-large ingest batch) 0.91-0.97 ms against 1.03, at
// N = 512 (a query) 0.0272 against 0.0239 (the first design 0.0804).
//
// Tried and dropped (kernel_ab.py device ms at N = 131,072 / 34,816 / 512,
// the same card): the epilogue stored straight from the registers (4-byte
// stores, no staging tile): 4.36 / 1.15 against the three calls' 4.04 /
// 1.005 in its own call; 2-CTA clusters on two row tiles of one column
// tile, each CTA loading half of every B tile by TMA multicast (half the
// L2 reads of B): 3.77-4.10 / 0.97-1.03 / 0.0306-0.0313 against
// 3.83-3.88 / 1.00-1.01 / 0.0271-0.0277 without; tiles of 128 x 128 with
// the warpgroups on alternate tiles taking turns to multiply (one's
// epilogue under the other's products): 4.16-4.36 / 0.98-1.08 / 0.0294
// against 3.80-3.86 / 1.04-1.09 / 0.0273, since one warpgroup's GELU
// epilogue outlasts the other's 128 x 128 main loop and the second
// product's smaller tiles ran slower (1.83-1.95 against 1.51-1.53).
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

// hidden 768: 64 tokens a block; per I chunk each warpgroup computes half
// of h's columns, both halves meet in shared memory, and each warpgroup
// adds h W2 to its half of y's columns.
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

static_assert(kWSlabBytes == kWH * kWW2Rows * 2 && kWSlabBytes == kWW1Rows * kWChunk * 2 &&
                  kWH % kWW1Rows == 0, "a slab is whole k16 steps of W1's chunk or of W2's");
constexpr int kWNB = kWHalf / 128;                // a warpgroup's n128 accumulators of y: 3

// The ring's slab s of a block that walks T chunks: W1 slab j of chunk t
// (rows kWW1Rows*j ..), or W2 slab j of chunk t (rows kWW2Rows*j ..), in
// the order of the products: W1 of chunk 0, then per chunk t > 0 W1 of t
// and W2 of t - 1, then W2 of the last chunk (kWSlabs * T slabs).
__device__ __forceinline__ void wide_slab(int s, int T, bool& w2, int& t, int& j) {
  if (s < kWW1Slabs) {
    w2 = false, t = 0, j = s;
    return;
  }
  const int r = s - kWW1Slabs, it = r / kWSlabs + 1, q = r % kWSlabs;
  if (it < T && q < kWW1Slabs)
    w2 = false, t = it, j = q;
  else
    w2 = true, t = it - 1, j = it < T ? q - kWW1Slabs : q;
}

__global__ void __launch_bounds__(kThreads, 1)
ffn_wide_kernel(const __nv_bfloat16* __restrict__ x, const __grid_constant__ CUtensorMap tm_w1,
                const __nv_bfloat16* __restrict__ b1, const __grid_constant__ CUtensorMap tm_w2,
                const __nv_bfloat16* __restrict__ b2, __nv_bfloat16* __restrict__ y,
                float* __restrict__ partial, int N, int I, int splits) {
  constexpr int H = kWH, kStages = kWStages, kSlabBytes = kWSlabBytes, kNB = kWNB;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const uint32_t sX = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sH = sX + kWXBytes;           // h tiles of even and odd chunks
  const uint32_t sRing = sH + 2 * kWHBytes;

  const int span = I / splits;  // this block's range of the I axis
  const int c_begin = blockIdx.y * span, T = span / kWChunk;
  const int total = kWSlabs * T;
  const int m0 = blockIdx.x * kWRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;     // warpgroup: h columns kWHCols*wg .., y columns kWHalf*wg ..

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);                // the filling thread's expect_tx; then the slab's bytes
      mbar_init(&empty[st], kThreads / 32);  // lane 0 of every warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // slab s into stage s % kStages by TMA, one copy each: a W1 slab's
  // kWW1Rows rows of the chunk's 64 columns, a W2 slab's 16 rows as y's
  // 12 blocks of 64 columns
  auto fill = [&](int s) {
    int t, j;
    bool w2;
    wide_slab(s, T, w2, t, j);
    const int st = s % kStages, c0 = c_begin + t * kWChunk;
    const uint32_t dst = sRing + st * kSlabBytes;
    mbar_expect_tx(&full[st], kSlabBytes);
    if (w2)
      tma_load_3d(dst, &tm_w2, 0, c0 + kWW2Rows * j, 0, &full[st]);
    else
      tma_load_2d(dst, &tm_w1, c0, kWW1Rows * j, &full[st]);
  };
  if (lane == 0) {
    prefetch_tensor_map(&tm_w1);
    prefetch_tensor_map(&tm_w2);
  }
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages && s < total; ++s) fill(s);
  // the block's 64 token rows, zeros past N, by all 256 threads
  for (int e = threadIdx.x; e < kWRows * (H / 8); e += kThreads) {
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
  float acc[kNB][64];  // y columns kWHalf*wg + 128*nb .. +127
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) zero(acc[nb]);
  // the zeros here, not sunk into the first second product's issue (ptxas
  // then serialises the wgmmas, C7515)
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) fence_acc(acc[nb]);
  float h[16];       // h columns kWHCols*wg .. of the chunk
  for (int t = 0; t <= T; ++t) {
    if (t < T) {
      // h = x @ W1[:, this warpgroup's 32 columns of chunk t], slab by slab:
      // W1 [k][n] in 128-byte rows read MN-major, this half 64 bytes in
#pragma unroll
      for (int j = 0; j < kWW1Slabs; ++j, ++s) {
        begin_slab(s);
        const uint64_t w1_desc =
            make_desc(sRing + (s % kStages) * kSlabBytes + wg * kWHCols * 2, 8192, 1024, kSw128);
#pragma unroll
        for (int kk = 0; kk < kWW1Rows / 16; ++kk) {
          const int k = j * (kWW1Rows / 16) + kk;
          wgmma_ss_n32_tb(h, desc_add(x_desc, (k >> 2) * kXRegion + (k & 3) * 32),
                          desc_add(w1_desc, 16 * 128 * kk), j > 0 || kk > 0);
        }
        end_slab(s);
      }
    }
    if (t > 0) {
      // y[:, this half] += h(t-1) @ W2[chunk t-1, this half], once both
      // warpgroups stored their halves of h(t-1)
      named_barrier(1, kThreads);
      const uint64_t h_desc = make_desc(sH + ((t - 1) & 1) * kWHBytes, 16, 1024, kSw128);
#pragma unroll
      for (int j = 0; j < kWW2Slabs; ++j, ++s) {
        begin_slab(s);
        const uint64_t w2_desc = make_desc(
            sRing + (s % kStages) * kSlabBytes + wg * (kWHalf / 64) * kWW2Region,
            kWW2Region, 1024, kSw128);
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb)
          wgmma_ss_n128_tb(acc[nb], desc_add(h_desc, 32 * j),
                           desc_add(w2_desc, nb * 2 * kWW2Region));
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
      const int c0 = c_begin + t * kWChunk + kWHCols * wg;
      __nv_bfloat16 bb[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) bb[q] = b1[c0 + 8 * (q >> 1) + 2 * tig + (q & 1)];
      fence_acc(h);
      const uint32_t ht = sH + (t & 1) * kWHBytes;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 4 * jj + 2 * hf, row = 16 * (warp & 3) + gid + 8 * hf;
          const float v0 = gelu_erf(h[i] + __bfloat162float(bb[2 * jj]));
          const float v1 = gelu_erf(h[i + 1] + __bfloat162float(bb[2 * jj + 1]));
          st_shared_u32(ht + swz<3>(row * 128 + (kWHCols / 8 * wg + jj) * 16) + 4 * tig,
                        pack_bf16(v0, v1));
        }
      fence_proxy_async();   // the stores, before the second product reads them
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) fence_acc(acc[nb]);

  // acc[nb][4*j + e]: row 16*(warp%4) + gid + 8*(e/2), column
  // kWHalf*wg + 128*nb + 8*j + 2*tig + e%2
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + 16 * (warp & 3) + gid + 8 * r;
    if (row >= N) continue;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = kWHalf * wg + 128 * nb + 8 * j + 2 * tig;
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

// y[n, c] = bf16(sum over s of partial[s, n, c], in s order, + b2[c]) over
// rows of H columns: the compile-time H of a tuned width, else (H = 0) the
// run-time h
template <int H>
__global__ void __launch_bounds__(kReduceThreads)
ffn_reduce_kernel(const float* __restrict__ partial, const __nv_bfloat16* __restrict__ b2,
                  __nv_bfloat16* __restrict__ y, int N, int splits, int h) {
  const int width = H > 0 ? H : h;
  const size_t total = (size_t)N * width;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += partial[(size_t)s * total + e];
    y[e] = __float2bfloat16(v + __bfloat162float(b2[e % width]));
  }
}

// The first kernel (one of the designs above), then, when the I axis is
// split, the reduce.
template <int H>
int launch_ffn(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
               void* y, float* partial, int N, int I, int splits, cudaStream_t st) {
  constexpr bool wide = H == kWH;
  constexpr int chunk = wide ? kWChunk : kChunk, tokens = wide ? kWRows : kTokens;
  constexpr int smem = wide ? kWSmemBytes : kSmemBytes;
  if (N < 1 || splits < 1 || I % splits || (I / splits) % chunk || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory a kernel must opt in, on each
  // device it runs on (the attribute is the current device's)
  const cudaError_t opt_in =
      wide ? cudaFuncSetAttribute(ffn_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
           : cudaFuncSetAttribute(ffn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  // 384: W1 [H][I] in boxes of 192 x 32, W2 [I][H] in boxes of 32 x 64;
  // 768: W1 in boxes of kWW1Rows x 64 (a slab), W2 as [64-column
  // block][I][64] in boxes of all 12 blocks of 16 x 64 (a slab)
  CUtensorMap tm_w1, tm_w2;
  const uint64_t w2_dims[3] = {64, (uint64_t)I, H / 64}, w2_strides[2] = {H * 2, 128};
  const uint32_t w2_box[3] = {64, kWW2Rows, H / 64};
  const bool mapped =
      wide ? hopper::tensor_map_2d(&tm_w1, w1, H, I, kWW1Rows, kWChunk, CU_TENSOR_MAP_SWIZZLE_128B) &&
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
    ffn_wide_kernel<<<grid, kThreads, smem, st>>>(xb, tm_w1, b1b, tm_w2, b2b, yb, partial, N, I, splits);
  else
    ffn_fwd_kernel<<<grid, kThreads, smem, st>>>(xb, tm_w1, b1b, tm_w2, b2b, yb, partial, N, I, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int blocks = (int)(((size_t)N * H + kReduceThreads - 1) / kReduceThreads);
  ffn_reduce_kernel<H><<<blocks, kReduceThreads, 0, st>>>(
      partial, static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(y), N, splits, H);
  return (int)cudaGetLastError();
}

// hidden 1,024: two products through h in device memory. One kernel,
// ffn_large_kernel<BN, kGelu>, computes out = A B (+ bias) on tiles of 128
// token rows by BN output columns: the first product A = x [N][1,024], B =
// W1, out = h = bf16(gelu(. + b1)) [N][I]; the second A = h, B = W2, out =
// y = bf16(. + b2), or, with its K axis split, f32 partials that
// ffn_reduce_kernel<1024> sums in split order.
//
// Every other width (the generic route: TinyBERT's 312 / 1,200, the BERT
// miniatures' 128 to 512, 2,048, or 1,024 with I not whole 64-wide steps)
// runs the same two products with run-time extents: any H and I that are
// multiples of 8 (rows of whole 16-byte chunks, as the TMA needs). The k
// steps are rounded up, and a last stage's k past K reads as the TMA's
// zeros in both operands (the stage still counts its whole box of bytes).
// Where the output columns are whole 64-column blocks (1,024, 512, 2,048)
// B and out are the 3-D maps below; otherwise a 64-column block would run
// into the next row, so they are 2-D maps over [K][ncols] and [M][ncols],
// read and written one 64-column box at a time, with the columns past the
// matrix read as zeros and not written. The bias loads stop at ncols. At a
// query's few token tiles the generic route's plan (ops/fused_ffn.py,
// large_launch_plan) spreads both products over the card: 64-column tiles
// (kGSlimCols) where their grid fits the SMs in one wave, and the second
// product's k steps split in ranges that need not divide them.
constexpr int kGH = 1024;                 // hidden width of the large design (its reduce is built for it)
constexpr int kGGranule = 8;              // the generic route's H and I: multiples of 8 (16-byte rows)
constexpr int kGTokens = 128;             // token rows of a tile: 64 a consumer warpgroup
constexpr int kGDepth = 64;               // k a ring stage holds: 128-byte rows, SW128
constexpr int kGWideCols = 256;           // output columns of a wide tile (128 accumulators a thread)
constexpr int kGNarrowCols = 128;         // of a narrow one (64), for calls of few tiles
constexpr int kGSlimCols = 64;            // of a slim one (32), the generic route's at a query's tokens
constexpr int kGMinSteps = 4;             // k steps a split unit of the second product walks at least
constexpr int kGABytes = kGTokens * kGDepth * 2;   // a stage's A tile: 16 KB, K-major
constexpr int kGWideStages = 4;
constexpr int kGNarrowStages = 6;
constexpr int kGOutCols = 128;            // output columns a warpgroup stages for one TMA store
constexpr int kGStagingBytes = 64 * kGOutCols * 2;  // its staging tile: 2 blocks of 64 x 128 bytes, SW128
constexpr int kGWideStageBytes = kGABytes + kGDepth * kGWideCols * 2;      // 48 KB
constexpr int kGNarrowStageBytes = kGABytes + kGDepth * kGNarrowCols * 2;  // 32 KB
constexpr int kGWideSmemBytes = kGWideStages * kGWideStageBytes + 2 * kGStagingBytes + 1024;  // + alignment
constexpr int kGNarrowSmemBytes = kGNarrowStages * kGNarrowStageBytes + 2 * kGStagingBytes + 1024;
// A tile of BN columns: its ring (6 stages below 256 columns) and shared memory.
template <int BN>
struct GTile {
  static constexpr int kStages = BN == kGWideCols ? kGWideStages : kGNarrowStages;
  static constexpr int kStageBytes = kGABytes + kGDepth * BN * 2;
  static constexpr int kOutCols = BN < kGOutCols ? BN : kGOutCols;   // a TMA store's columns
  static constexpr int kSmemBytes = kStages * kStageBytes + 2 * kGStagingBytes + 1024;
};
static_assert(GTile<kGWideCols>::kSmemBytes == kGWideSmemBytes &&
              GTile<kGNarrowCols>::kSmemBytes == kGNarrowSmemBytes, "the tile widths' rings");
constexpr int kGConsumerWarps = 8;        // two warpgroups; a third one's thread 256 issues the copies
constexpr int kGThreads = kGConsumerWarps * 32 + 128;
constexpr int kGProducerRegs = 40;        // setmaxnreg: the producer warpgroup's registers a thread
constexpr int kGConsumerRegs = 232;       // and the consumers'

// A block walks the work units u = blockIdx.x, + gridDim.x, ..., each a
// tile of 128 rows by BN columns and one of `splits` ranges of K (split s:
// k steps s * steps / splits .. (s + 1) * steps / splits - 1, which the
// producer and the consumers both compute from the unit): columns
// fastest, then the split, then the rows, so the blocks at work at one time
// share their A rows and all of B through L2. Thread 256 (the producer)
// keeps the ring full: a stage is the A tile [128][64] (TMA, 128-byte
// swizzle, K-major; rows past M read as zeros) and the B tile [64][BN] as
// BN / 64 blocks of [64 k][64 columns] (a 3-D TMA box, 128-byte swizzle,
// read MN-major through the transpose bit; columns past the matrix read as
// zeros; one 2-D box a block where `blocked` is false); its bytes complete
// the stage's full mbarrier. Each consumer
// warpgroup multiplies its 64 rows of the stage (4 x wgmma m64nBNk16), keeps
// one stage's products in flight (wgmma.wait_group 1) and releases the stage
// before through its empty mbarrier (lane 0 of each warp). After the last
// stage of a unit: + bias, GELU and bf16 (first product) or + bias and bf16
// (second), 128 columns at a time into the warpgroup's staging tile, each
// written to device memory by one TMA store (rows and columns past the
// matrix are not written) that runs on under the next unit's products;
// the second product's f32 partials, when its K axis is split, are stored
// from the registers. Meanwhile the producer fills the next unit's stages.
template <int BN, bool kGelu>
__global__ void __launch_bounds__(kGThreads, 1)
ffn_large_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_out, const __nv_bfloat16* __restrict__ bias,
                 float* __restrict__ partial, int M, int ncols, int K, int splits, bool blocked) {
  constexpr int kStages = GTile<BN>::kStages, kStageBytes = GTile<BN>::kStageBytes;
  constexpr int kOut = GTile<BN>::kOutCols;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const uint32_t sRing = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sStaging = sRing + kStages * kStageBytes;
  const int ntiles = (ncols + BN - 1) / BN;
  const int units = (M + kGTokens - 1) / kGTokens * ntiles * splits;
  const int ksteps = (K + kGDepth - 1) / kGDepth;   // split s walks [s*ksteps/splits, (s+1)*ksteps/splits)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);                      // the producer's expect_tx; then the stage's bytes
      mbar_init(&empty[st], kGConsumerWarps);   // lane 0 of every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kGConsumerWarps) {
    setmaxnreg_dec<kGProducerRegs>();
    if (threadIdx.x == kGConsumerWarps * 32) {
      prefetch_tensor_map(&tm_a);
      prefetch_tensor_map(&tm_b);
      int it = 0;   // the stages this block has filled
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int n = u % ntiles, r = u / ntiles, split = r % splits, m = r / splits;
        const int first = split * ksteps / splits, steps = (split + 1) * ksteps / splits - first;
        for (int ks = 0; ks < steps; ++ks, ++it) {
          const int st = it % kStages, k0 = (first + ks) * kGDepth;
          if (it >= kStages) mbar_wait(&empty[st], (it / kStages - 1) & 1);
          const uint32_t a = sRing + st * kStageBytes;
          if (blocked) {
            mbar_expect_tx(&full[st], kStageBytes);
            tma_load_2d(a, &tm_a, k0, m * kGTokens, &full[st]);
            tma_load_3d(a + kGABytes, &tm_b, 0, k0, n * (BN / 64), &full[st]);
          } else {
            // the 64-column blocks that hold a column of B; a block wholly
            // past ncols is not loaded, and only the output columns it feeds
            // (never stored) read its stale bytes
            const int live = min(BN / 64, (ncols - n * BN + 63) / 64);
            mbar_expect_tx(&full[st], kGABytes + live * kGDepth * 128);
            tma_load_2d(a, &tm_a, k0, m * kGTokens, &full[st]);
            for (int j = 0; j < live; ++j)
              tma_load_2d(a + kGABytes + j * kGDepth * 128, &tm_b, n * BN + 64 * j, k0, &full[st]);
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kGConsumerRegs>();
  const int wg = warp >> 2, gid = lane >> 2, tig = lane & 3;
  const bool issuer = (threadIdx.x & 127) == 0;   // of its warpgroup's TMA stores
  const uint32_t staging = sStaging + wg * kGStagingBytes;
  float acc[BN / 2];   // 64 rows x BN columns of this warpgroup
  int it = 0;          // the stages this block has consumed
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&empty[i % kStages]);
    }
  };
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int n = u % ntiles, r = u / ntiles, split = r % splits, m = r / splits;
    const int steps = (split + 1) * ksteps / splits - split * ksteps / splits;   // as the producer's
    for (int ks = 0; ks < steps; ++ks, ++it) {
      const int st = it % kStages;
      mbar_wait(&full[st], (it / kStages) & 1);
      const uint32_t a = sRing + st * kStageBytes;
      const uint64_t a_desc = make_desc(a + wg * (kGABytes / 2), 16, 1024, kSw128);
      const uint64_t b_desc = make_desc(a + kGABytes, kGDepth * 128, 1024, kSw128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGDepth / 16; ++kk) {
        if constexpr (BN == kGWideCols)
          wgmma_ss_n256_tb(acc, desc_add(a_desc, 32 * kk), desc_add(b_desc, 16 * 128 * kk),
                           ks > 0 || kk > 0);
        else if constexpr (BN == kGNarrowCols)
          wgmma_ss_n128_tb(acc, desc_add(a_desc, 32 * kk), desc_add(b_desc, 16 * 128 * kk),
                           ks > 0 || kk > 0);
        else
          wgmma_ss_n64_tb(acc, desc_add(a_desc, 32 * kk), desc_add(b_desc, 16 * 128 * kk),
                          ks > 0 || kk > 0);
      }
      wgmma_commit();
      if (ks > 0) {
        wgmma_wait<1>();   // the stage before has been read
        release(it - 1);
      }
    }
    wgmma_wait<0>();
    release(it - 1);
    fence_acc(acc);

    // acc[4*j + e]: row 16*(warp%4) + gid + 8*(e/2) of the warpgroup's 64,
    // column 8*j + 2*tig + e%2 of the tile; in the staging tile (64 x 128
    // bytes a 64-column block, 128-byte swizzle) the 16-byte chunk c of row
    // r is at chunk c ^ (r % 8), and r % 8 is gid for both of a thread's rows
    const int row = 16 * (warp & 3) + gid;
    const uint32_t st_row = staging + row * 128 + 4 * tig;
    if (kGelu || splits == 1) {
#pragma unroll
      for (int half = 0; half < BN / kOut; ++half) {
        // + bias (and GELU) in place, while the last store reads the staging tile
#pragma unroll
        for (int jj = 0; jj < kOut / 8; ++jj) {
          const int j = half * (kOut / 8) + jj, col = n * BN + 8 * j + 2 * tig;
          const bool in = col < ncols;   // ncols is even (whole 16-byte chunks): col + 1 too
          const float b0 = in ? __bfloat162float(bias[col]) : 0.f;
          const float b1 = in ? __bfloat162float(bias[col + 1]) : 0.f;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v0 = acc[4 * j + 2 * e];
            float& v1 = acc[4 * j + 2 * e + 1];
            v0 += b0, v1 += b1;
            if constexpr (kGelu) v0 = gelu_erf(v0), v1 = gelu_erf(v1);
          }
        }
        // the staging tile is free once the last store has read it
        if (issuer) bulk_wait_read<0>();
        named_barrier(1 + wg, 128);
#pragma unroll
        for (int jj = 0; jj < kOut / 8; ++jj) {
          const int j = half * (kOut / 8) + jj;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            st_shared_u32(st_row + (jj >> 3) * (64 * 128) + e * (8 * 128) + (((jj & 7) ^ gid) << 4),
                          pack_bf16(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]));
        }
        fence_proxy_async();   // the stores, before the TMA reads them
        named_barrier(1 + wg, 128);
        if (issuer) {
          const int row0 = m * kGTokens + 64 * wg, col0 = n * BN + half * kOut;
          if (blocked) {
            tma_store_3d(&tm_out, staging, 0, row0, col0 / 64);
          } else {
            for (int j = 0; j < kOut / 64 && col0 + 64 * j < ncols; ++j)
              tma_store_2d(&tm_out, staging + j * 64 * 128, col0 + 64 * j, row0);
          }
          bulk_commit();
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n * BN + 8 * j + 2 * tig;
        if (col >= ncols) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int token = m * kGTokens + 64 * wg + row + 8 * e;
          if (token < M)
            *reinterpret_cast<float2*>(partial + ((size_t)split * M + token) * ncols + col) =
                make_float2(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
        }
      }
    }
  }
  if (issuer) bulk_wait<0>();   // the last stores, before the block's shared memory goes
}

// One product of the large design: A [M][K] (x or h), B [K][ncols] (W1 or
// W2), BN columns a tile, a persistent grid of one block an SM (or one a
// unit, if fewer). K and ncols are multiples of 8.
template <int BN, bool kGelu>
int launch_large_product(const void* a, const void* b, const void* bias, void* out, float* partial,
                         int M, int ncols, int K, int splits, cudaStream_t st) {
  constexpr int smem = GTile<BN>::kSmemBytes;
  static std::atomic<int> sm_cache[kMaxDevices];
  const int sms = opted_sm_count(ffn_large_kernel<BN, kGelu>, smem, sm_cache);
  if (sms < 0) return -sms;
  // A [M][K] in boxes of 128 x 64. Whole 64-column blocks: B [K][ncols] as
  // [64-column block][K][64] in boxes of BN / 64 blocks of 64 x 64, out
  // [M][ncols] the same way in boxes of 2 blocks of 64 x 64 (a warpgroup's
  // staging tile); else both 2-D in boxes of 64 x 64
  CUtensorMap tm_a, tm_b, tm_out;
  const bool blocked = ncols % 64 == 0;
  const uint64_t b_dims[3] = {64, (uint64_t)K, (uint64_t)ncols / 64}, b_strides[2] = {(uint64_t)ncols * 2, 128};
  const uint64_t out_dims[3] = {64, (uint64_t)M, (uint64_t)ncols / 64};
  const uint32_t b_box[3] = {64, kGDepth, BN / 64}, out_box[3] = {64, 64, GTile<BN>::kOutCols / 64};
  const bool mapped =
      blocked ? hopper::tensor_map_3d(&tm_b, b, b_dims, b_strides, b_box, CU_TENSOR_MAP_SWIZZLE_128B) &&
                    hopper::tensor_map_3d(&tm_out, out, out_dims, b_strides, out_box, CU_TENSOR_MAP_SWIZZLE_128B)
              : hopper::tensor_map_2d(&tm_b, b, K, ncols, kGDepth, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
                    hopper::tensor_map_2d(&tm_out, out, M, ncols, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!mapped || !hopper::tensor_map_2d(&tm_a, a, M, K, kGTokens, kGDepth, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const long units = (long)((M + kGTokens - 1) / kGTokens) * ((ncols + BN - 1) / BN) * splits;
  const int grid = (int)(units < sms ? units : sms);
  ffn_large_kernel<BN, kGelu><<<grid, kGThreads, smem, st>>>(
      tm_a, tm_b, tm_out, static_cast<const __nv_bfloat16*>(bias), partial, M, ncols, K, splits, blocked);
  return (int)cudaGetLastError();
}

// One product at up to `cols` (256, 128 or 64) output columns a tile.
template <bool kGelu>
int launch_product(int cols, const void* a, const void* b, const void* bias, void* out,
                   float* partial, int M, int ncols, int K, int splits, cudaStream_t st) {
  switch (cols) {
    case kGWideCols:
      return launch_large_product<kGWideCols, kGelu>(a, b, bias, out, partial, M, ncols, K, splits, st);
    case kGNarrowCols:
      return launch_large_product<kGNarrowCols, kGelu>(a, b, bias, out, partial, M, ncols, K, splits, st);
    default:
      return launch_large_product<kGSlimCols, kGelu>(a, b, bias, out, partial, M, ncols, K, splits, st);
  }
}

}  // namespace

// Shapes: x/y [N,H], w1 [H,I], b1 [I], w2 [I,H], b2 [H], all bf16, row-major,
// x, w1 and w2 16-byte aligned; partial [splits,N,H] f32 scratch (unused when
// splits is 1). Any N >= 1; H == 384 with (I / splits) % 32 == 0, or H ==
// 768 with (I / splits) % 64 == 0 (hidden 1,024: frag_fused_ffn_large).
FRAG_EXPORT int frag_fused_ffn(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* y, float* partial,
                               int N, int H, int I, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H) {
    case kH: return launch_ffn<kH>(x, w1, b1, w2, b2, y, partial, N, I, splits, st);
    case kWH: return launch_ffn<kWH>(x, w1, b1, w2, b2, y, partial, N, I, splits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Hidden 1,024 and the generic route. Shapes as frag_fused_ffn's with H and
// I multiples of 8 (H = 1,024 with I a multiple of 64 is the tuned width);
// h [N,I] bf16 scratch (16-byte aligned), partial [splits,N,H] f32 scratch
// (unused when splits is 1). up_cols and down_cols (256, 128 or 64) are the
// two products' tile widths; the second product's ceil(I / 64) k steps are
// split `splits` ways, split s walking steps [s * steps / splits, (s + 1) *
// steps / splits), at least kGMinSteps of them.
FRAG_EXPORT int frag_fused_ffn_large(const void* x, const void* w1, const void* b1,
                                     const void* w2, const void* b2, void* y, void* h,
                                     float* partial, int N, int H, int I, int up_cols,
                                     int down_cols, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto cols_ok = [](int c) { return c == kGWideCols || c == kGNarrowCols || c == kGSlimCols; };
  const int steps = (I + kGDepth - 1) / kGDepth;
  if (N < 1 || H < kGGranule || H % kGGranule || I < kGGranule || I % kGGranule || splits < 1 ||
      (splits > 1 && steps / splits < kGMinSteps) || h == nullptr ||
      !cols_ok(up_cols) || !cols_ok(down_cols) || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  int err = launch_product<true>(up_cols, x, w1, b1, h, nullptr, N, I, H, 1, st);
  if (err) return err;
  err = launch_product<false>(down_cols, h, w2, b2, y, partial, N, H, I, splits, st);
  if (err || splits == 1) return err;
  const int blocks = (int)(((size_t)N * H + kReduceThreads - 1) / kReduceThreads);
  const auto* b2b = static_cast<const __nv_bfloat16*>(b2);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  // at 1,024 the compile-time width's reduce, whose e % H is a mask and not a
  // 64-bit division: 0.0036 against the run-time width's 0.0040 ms at a
  // query's 512 tokens, 4 splits (kernel_ab.py device time, the same bits;
  // NVIDIA H100 80GB HBM3, 700 W)
  if (H == kGH)
    ffn_reduce_kernel<kGH><<<blocks, kReduceThreads, 0, st>>>(partial, b2b, yb, N, splits, H);
  else
    ffn_reduce_kernel<0><<<blocks, kReduceThreads, 0, st>>>(partial, b2b, yb, N, splits, H);
  return (int)cudaGetLastError();
}

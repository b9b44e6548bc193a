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
// tokens a block instead, with both warpgroups on the same x rows (96 KB,
// loaded once by cp.async): warpgroup w owns y's columns 384w .. 384w+383,
// so each again keeps 192 accumulator registers a thread, and each computes
// the whole h of every chunk itself. That repeats the first product, 1.5x
// the flops of one pass, and needs no barrier between the warpgroups. The I
// axis is walked in 16-wide chunks through a ring of 2 stages of 48 KB
// (193 KB a block): the chunk's W1 columns [768][16] (32-byte swizzle, 3
// boxes) and W2 rows [16][768] (128-byte swizzle, 12 boxes), by TMA, as
// above. Per chunk a warpgroup runs h = x W1c (48 x wgmma m64n16k16, W1c
// MN-major), GELU, then y += h W2c over its half (3 x wgmma m64n128k16).
// With 16 columns a step, the first product reads x from shared memory
// twice as often per flop as at 384: a simple design that is right first.
//
// A query-time call has few tokens (8 x 64 = 512: 4 tiles for 132 SMs), so
// the I axis is also split over `splits` blocks per tile (grid.y). Each then
// writes its f32 partial of y to scratch, and a second kernel sums the
// partials in split order, adds b2 and rounds; still no [N,I] intermediate
// in device memory. With splits == 1 the first kernel writes y itself.
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

// hidden 768: 64 tokens a block, warpgroup w owns y's columns 384w ..
constexpr int kWH = 768;
constexpr int kWRows = 64;                     // tokens per block
constexpr int kWHalf = kWH / kConsumers;       // y columns a warpgroup owns
constexpr int kWChunk = 16;                    // width of one I chunk
constexpr int kWXBytes = kWRows * kWH * 2;     // x rows: 12 regions of 64 x 128 bytes, SW128
constexpr int kWW1Box = 256;                   // W1 rows a TMA box
constexpr int kWW1Bytes = kWH * kWChunk * 2;   // W1 chunk [768][16], SW32: 24 KB
constexpr int kWW2Region = kWChunk * 128;      // 16 rows x 64 columns (128 bytes), SW128
constexpr int kWW2Bytes = kWChunk * kWH * 2;   // W2 chunk [16][768]: 12 regions, 24 KB
constexpr int kWStageBytes = kWW1Bytes + kWW2Bytes;
constexpr int kWSmemBytes = kWXBytes + kStages * kWStageBytes + 1024;  // + alignment

__global__ void __launch_bounds__(kThreads, 1)
ffn_wide_kernel(const __nv_bfloat16* __restrict__ x, const __grid_constant__ CUtensorMap tm_w1,
                const __nv_bfloat16* __restrict__ b1, const __grid_constant__ CUtensorMap tm_w2,
                const __nv_bfloat16* __restrict__ b2, __nv_bfloat16* __restrict__ y,
                float* __restrict__ partial, int N, int I, int splits) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const uint32_t sX = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sRing = sX + kWXBytes;  // stage st: W1 chunk, then W2 chunk

  const int span = I / splits;  // this block's range of the I axis
  const int c_begin = blockIdx.y * span, nchunks = span / kWChunk;
  const int m0 = blockIdx.x * kWRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = warp >> 2;      // warpgroup: y columns kWHalf*w ..

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);          // thread 0's expect_tx; then the chunk's bytes
      mbar_init(&empty[st], kThreads);  // every thread, once its products of the chunk ended
    }
    mbar_init_fence();
  }
  __syncthreads();

  // thread 0: chunk t's W1 columns (3 boxes of 256 x 16) and W2 rows (12
  // boxes of 16 x 64) into stage t % kStages by TMA
  auto fetch = [&](int t) {
    const int st = t % kStages, c0 = c_begin + t * kWChunk;
    const uint32_t w1t = sRing + st * kWStageBytes, w2t = w1t + kWW1Bytes;
    mbar_expect_tx(&full[st], kWStageBytes);
#pragma unroll
    for (int j = 0; j < kWH / kWW1Box; ++j)
      tma_load_2d(w1t + j * kWW1Box * kWChunk * 2, &tm_w1, c0, kWW1Box * j, &full[st]);
#pragma unroll
    for (int j = 0; j < kWH / 64; ++j) tma_load_2d(w2t + j * kWW2Region, &tm_w2, 64 * j, c0, &full[st]);
  };
  if (threadIdx.x == 0) fetch(0);
  // the block's 64 token rows, zeros past N, by all 256 threads
  for (int e = threadIdx.x; e < kWRows * (kWH / 8); e += kThreads) {
    const int r = e / (kWH / 8), ch = e % (kWH / 8), row = m0 + r;
    const bool ok = row < N;
    cp_async16(sX + sw128_chunk(r, ch), x + (size_t)(ok ? row : 0) * kWH + 8 * ch, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  const int gid = lane >> 2, tig = lane & 3;
  const uint64_t x_desc = make_desc(sX, 16, 1024, kSw128);
  float acc[3][64];  // y columns kWHalf*w + 128*nb .. +127
#pragma unroll
  for (int nb = 0; nb < 3; ++nb) zero(acc[nb]);
  for (int t = 0; t < nchunks; ++t) {
    const int st = t % kStages;
    const int c0 = c_begin + t * kWChunk;
    // b1 at this thread's 4 columns of the chunk, 8*(q/2) + 2*tig + q%2: h[i]
    // is column 8*(i/4) + 2*tig + i%2, so its bias is bb[2*(i/4) + i%2]
    __nv_bfloat16 bb[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) bb[q] = b1[c0 + 8 * (q >> 1) + 2 * tig + (q & 1)];
    mbar_wait(&full[st], (t / kStages) & 1);  // chunk t landed
    const uint32_t w1t = sRing + st * kWStageBytes, w2t = w1t + kWW1Bytes;
    // W1c [768][16] in 32-byte rows: a k16 step is 512 bytes, 8-row groups 256
    const uint64_t w1_desc = make_desc(w1t, kWW1Bytes, 256, kSw32);
    const uint64_t w2_desc = make_desc(w2t + w * (kWHalf / 64) * kWW2Region, kWW2Region, 1024, kSw128);

    // h = x @ W1[:, c0:c0+16]
    float h[8];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWH / 16; ++kk)
      wgmma_ss_n16_tb(h, desc_add(x_desc, (kk >> 2) * kXRegion + (kk & 3) * 32),
                      desc_add(w1_desc, 512 * kk), kk > 0);
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
    for (int i = 0; i < 8; ++i) h[i] = gelu_erf(h[i] + __bfloat162float(bb[2 * (i >> 2) + (i & 1)]));
    uint32_t a[4];
    pack_a(a, h, 0);

    // y[:, this half] += h @ W2[c0:c0+16, this half]
    wgmma_fence();
#pragma unroll
    for (int nb = 0; nb < 3; ++nb) wgmma_rs_n128(acc[nb], a, desc_add(w2_desc, nb * 2 * kWW2Region));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < 3; ++nb) fence_acc(acc[nb]);
    mbar_arrive(&empty[st]);
  }

  // acc[nb][4*j + e]: row 16*(warp%4) + gid + 8*(e/2), column kWHalf*w +
  // 128*nb + 8*j + 2*tig + e%2
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + 16 * (warp & 3) + gid + 8 * r;
    if (row >= N) continue;
#pragma unroll
    for (int nb = 0; nb < 3; ++nb)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = kWHalf * w + 128 * nb + 8 * j + 2 * tig;
        const float v0 = acc[nb][4 * j + 2 * r], v1 = acc[nb][4 * j + 2 * r + 1];
        if (splits == 1) {
          *reinterpret_cast<uint32_t*>(y + (size_t)row * kWH + col) =
              pack_bf16(v0 + __bfloat162float(b2[col]), v1 + __bfloat162float(b2[col + 1]));
        } else {
          *reinterpret_cast<float2*>(partial + ((size_t)blockIdx.y * N + row) * kWH + col) =
              make_float2(v0, v1);
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

// The first kernel (one of the two designs above), then, when the I axis is
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
  // 768: W1 in boxes of 256 x 16, W2 in boxes of 16 x 64
  CUtensorMap tm_w1, tm_w2;
  const bool mapped =
      wide ? hopper::tensor_map_2d(&tm_w1, w1, H, I, kWW1Box, kWChunk, CU_TENSOR_MAP_SWIZZLE_32B) &&
                 hopper::tensor_map_2d(&tm_w2, w2, I, H, kWChunk, 64, CU_TENSOR_MAP_SWIZZLE_128B)
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
      partial, static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(y), N, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes: x/y [N,H], w1 [H,I], b1 [I], w2 [I,H], b2 [H], all bf16, row-major,
// x, w1 and w2 16-byte aligned; partial [splits,N,H] f32 scratch (unused when
// splits is 1). Any N >= 1; H == 384 with (I / splits) % 32 == 0, or H ==
// 768 with (I / splits) % 16 == 0.
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

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
// 4*H bytes of x and y per token: ~1500 flop/byte, far above the ridge.
//
// Design: one block of 8 warps per 64-token tile, the tile held in shared
// memory for the whole block. It walks the I axis in chunks of 32; each
// chunk's slices of W1 (H x 32) and W2 (32 x H) are copied into a
// double-buffered shared-memory ring with cp.async, the next chunk's while
// the current one computes, so every weight byte crosses from L2 once per
// block. Per chunk, warp (r, c) computes rows 16r.. x columns 16c.. of
// x@W1 with bf16 mma.sync m16n8k16 (f32 accumulate), adds b1, applies GELU,
// rounds to bf16 into a 64 x 32 shared tile, and after one barrier
// multiplies that tile into its 16 x H/2 slice of y, held in registers
// across all chunks. B operands come from the row-major shared tiles through
// ldmatrix.trans. wgmma and TMA are later work.
//
// A query-time call has few tokens (8 x 64 = 512: 8 tiles for 132 SMs), so
// the I axis is also split over `splits` blocks per tile (grid.y). Each then
// writes its f32 partial of y to scratch, and a second kernel sums the
// partials in split order, adds b2 and rounds; still no [N,I] intermediate
// in device memory. With splits == 1 the first kernel writes y itself.
#include "common.cuh"

namespace {

constexpr int kH = 384;            // hidden width the kernel is built for
constexpr int kTokens = 64;        // tokens per block
constexpr int kChunk = 32;         // width of one I chunk
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kXLd = kH + 8;       // row strides (bf16) of the shared tiles: 16-byte
constexpr int kW1Ld = kChunk + 8;  // aligned rows, conflict-free fragment loads
constexpr int kW2Ld = kH + 8;
constexpr int kHLd = kChunk + 8;
constexpr int kYTiles = kH / 2 / 8;  // n8 tiles of y per warp
constexpr size_t kSmemBytes =
    sizeof(__nv_bfloat16) *
    ((size_t)kTokens * kXLd + 2 * (size_t)kH * kW1Ld + 2 * (size_t)kChunk * kW2Ld +
     (size_t)kTokens * kHLd);
constexpr int kReduceThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// The B fragments of two adjacent n8 tiles of a row-major [k][n] shared tile:
// lane l addresses row k0 + (l & 15), column n0 + 8 * (l >> 4); returns
// {b0, b1} of tile n0 and {b0, b1} of tile n0 + 8.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752440f));
}

__global__ void __launch_bounds__(kThreads, 1)
ffn_fwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
               const __nv_bfloat16* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
               const __nv_bfloat16* __restrict__ b2, __nv_bfloat16* __restrict__ y,
               float* __restrict__ partial, int N, int I, int splits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kTokens][kXLd]
  __nv_bfloat16* w1s = xs + kTokens * kXLd;                         // [2][kH][kW1Ld]
  __nv_bfloat16* w2s = w1s + 2 * kH * kW1Ld;                        // [2][kChunk][kW2Ld]
  __nv_bfloat16* hs = w2s + 2 * kChunk * kW2Ld;                     // [kTokens][kHLd]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp & 3, ch = warp >> 2;  // 16-row group, column half
  const int ra = 16 * rg + gid;             // this thread's rows: ra, ra + 8
  const size_t m0 = (size_t)blockIdx.x * kTokens;
  const int span = I / splits;              // this block's range of the I axis
  const int c_begin = blockIdx.y * span, c_end = c_begin + span;
  // ldmatrix addressing of a 16-row k slab: row and column offset of this lane
  const int lrow = lane & 15, lcol = 8 * (lane >> 4);

  auto load_chunk = [&](int c0, int buf) {
    __nv_bfloat16* w1b = w1s + buf * kH * kW1Ld;
    for (int e = tid; e < kH * (kChunk / 8); e += kThreads) {
      const int r = e / (kChunk / 8), c = 8 * (e % (kChunk / 8));
      cp_async16(w1b + r * kW1Ld + c, w1 + (size_t)r * I + c0 + c);
    }
    __nv_bfloat16* w2b = w2s + buf * kChunk * kW2Ld;
    for (int e = tid; e < kChunk * (kH / 8); e += kThreads) {
      const int r = e / (kH / 8), c = 8 * (e % (kH / 8));
      cp_async16(w2b + r * kW2Ld + c, w2 + (size_t)(c0 + r) * kH + c);
    }
  };

  for (int e = tid; e < kTokens * (kH / 8); e += kThreads) {
    const int r = e / (kH / 8), c = 8 * (e % (kH / 8));
    cp_async16(xs + r * kXLd + c, x + (m0 + r) * kH + c);
  }
  load_chunk(c_begin, 0);
  cp_async_commit();

  float acc[kYTiles][4];
#pragma unroll
  for (int nt = 0; nt < kYTiles; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

  int buf = 0;
  for (int c0 = c_begin; c0 < c_end; c0 += kChunk, buf ^= 1) {
    if (c0 + kChunk < c_end) load_chunk(c0 + kChunk, buf ^ 1);
    cp_async_commit();               // possibly empty: keeps the group count regular
    cp_async_wait_all_but_newest();  // this chunk (and the x tile) have landed
    __syncthreads();

    // h = gelu(x @ W1[:, c0:c0+32] + b1): this warp's 16 rows x 16 columns
    const __nv_bfloat16* w1b = w1s + buf * kH * kW1Ld;
    float h[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
    for (int kk = 0; kk < kH; kk += 16) {
      uint32_t a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = ld32(xs + (ra + 8 * (i & 1)) * kXLd + kk + 8 * (i >> 1) + 2 * tig);
      ldsm_x4_trans(b, w1b + (kk + lrow) * kW1Ld + 16 * ch + lcol);
      mma_bf16(h[0], a, b[0], b[1]);
      mma_bf16(h[1], a, b[2], b[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = 16 * ch + 8 * nt + 2 * tig;
      const float bb0 = __bfloat162float(b1[c0 + col]), bb1 = __bfloat162float(b1[c0 + col + 1]);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(hs + (ra + 8 * r) * kHLd + col) =
            pack_bf16(gelu_erf(h[nt][2 * r] + bb0), gelu_erf(h[nt][2 * r + 1] + bb1));
    }
    __syncthreads();

    // y += h @ W2[c0:c0+32, :]: this warp's 16 rows x H/2 columns
    const __nv_bfloat16* w2b = w2s + buf * kChunk * kW2Ld;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      uint32_t a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = ld32(hs + (ra + 8 * (i & 1)) * kHLd + kk + 8 * (i >> 1) + 2 * tig);
#pragma unroll
      for (int np = 0; np < kYTiles / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, w2b + (kk + lrow) * kW2Ld + (kH / 2) * ch + 16 * np + lcol);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer and hs are rewritten two chunks on
  }

#pragma unroll
  for (int nt = 0; nt < kYTiles; ++nt) {
    const int col = (kH / 2) * ch + 8 * nt + 2 * tig;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t row = m0 + ra + 8 * r;
      if (splits == 1) {
        *reinterpret_cast<uint32_t*>(y + row * kH + col) =
            pack_bf16(acc[nt][2 * r] + __bfloat162float(b2[col]),
                      acc[nt][2 * r + 1] + __bfloat162float(b2[col + 1]));
      } else {
        *reinterpret_cast<float2*>(partial + ((size_t)blockIdx.y * N + row) * kH + col) =
            make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
      }
    }
  }
}

// y[n, c] = bf16(sum over s of partial[s, n, c], in s order, + b2[c])
__global__ void __launch_bounds__(kReduceThreads)
ffn_reduce_kernel(const float* __restrict__ partial, const __nv_bfloat16* __restrict__ b2,
                  __nv_bfloat16* __restrict__ y, int N, int splits) {
  const size_t total = (size_t)N * kH;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += partial[(size_t)s * total + e];
    y[e] = __float2bfloat16(v + __bfloat162float(b2[e % kH]));
  }
}

}  // namespace

// Shapes: x/y [N,H], w1 [H,I], b1 [I], w2 [I,H], b2 [H], all bf16, row-major,
// x, w1 and w2 16-byte aligned; partial [splits,N,H] f32 scratch (unused when
// splits is 1). N % 64 == 0, (I / splits) % 32 == 0, H == 384.
FRAG_EXPORT int frag_fused_ffn(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* y, float* partial,
                               int N, int H, int I, int splits, void* stream) {
  if (H != kH || N % kTokens || splits < 1 || I % splits || (I / splits) % kChunk ||
      (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      ffn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(N / kTokens, splits);
  ffn_fwd_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const __nv_bfloat16*>(b1), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(y), partial, N, I,
      splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int blocks = (int)(((size_t)N * kH + kReduceThreads - 1) / kReduceThreads);
  ffn_reduce_kernel<<<blocks, kReduceThreads, 0, st>>>(
      partial, static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(y), N,
      splits);
  return (int)cudaGetLastError();
}

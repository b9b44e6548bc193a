// K10: fused bidirectional multi-head self-attention, backward.
//
// Replaces financial_rag_tpu/ops/flash_attention.py:_flash_bwd (the Pallas
// kernel _attn_bwd_kernel): q, k, v and dout are [B,S,H] bf16 with the heads
// interleaved along H (head g owns columns g*32 .. g*32+31), bias is the
// additive [B,S] f32 key bias of the forward (0 or -1e9), and dq, dk, dv are
// [B,S,H] bf16. It recomputes the probabilities from q, k and the bias (the
// forward saves neither P nor its output) and applies
//     dV = P^T dO,  dP = dO V^T,  dS = P o (dP - rowsum(dP o P)),
//     dQ = dS K * scale,  dK = dS^T Q * scale
// with the TPU kernel's rounding points: scores, P, dP, dS and the row sums
// in f32; P^T and dS rounded to bf16 before the products that take them;
// every product a bf16 mma.sync m16n8k16 with f32 accumulation.
//
// Bound on the H100: the five S x S x 32 products (QK^T, dO V^T, P^T dO,
// dS K, dS^T Q) are 320*S*S flops per (batch row, head) against 7*S*32*2
// bytes (q, k, v, dO in; dq, dk, dv out): ~91 flop/byte at S=128, under the
// ~295 flop/byte ridge, so the bytes bound it there; ~366 at S=512, where the
// tensor cores do. This design runs nine products (QK^T and dO V^T three
// times), so at S=512 it does 1.8x the bound's operations.
//
// Design: the TPU holds the whole [S,S] matrix of all 12 heads of one batch
// row in VMEM; one SM cannot at S=512. Here two kernels, each on a grid of
// (64-row tile, head, batch row) blocks of 4 warps, each warp 16 rows:
//   1. attn_bwd_dq_kernel, per 64-query tile. Q and dO stay in registers as
//      mma A fragments. A first walk over 64-key tiles recomputes S = QK^T
//      and dP = dO V^T and keeps each row's max, sum and D = rowsum(dP o P)
//      online in f32 (D from the recomputed f32 P, not from the forward's
//      bf16 output); it writes them to a [3,B,heads,S] f32 scratch. A second
//      walk recomputes S and dP, forms dS and accumulates dQ = dS K in
//      registers.
//   2. attn_bwd_dkdv_kernel, per 64-key tile. K and V stay in registers; a
//      walk over 64-query tiles recomputes S^T = K Q^T and dP^T = V dO^T, reads
//      each query's max, sum and D from the scratch, and accumulates dV and
//      dK in registers.
// Nothing crosses blocks except the scratch, so the result does not depend on
// the order blocks run in (no atomics). Staged tiles are row-major or
// transposed in shared memory so that every mma B fragment is one 32-bit
// load. Keys past S get bias -inf; queries past S get max +inf, sum 1 and
// D 0, so they add exact zeros. A fully masked row sees every real score at
// -1e9 and gets the uniform P over the real keys, as the plain version and
// the TPU do. head_dim 32 only; any S >= 1 (S not a multiple of 64 included).
// Later work: wgmma, TMA, the forward's log-sum-exp saved to skip the stats
// walk, and one kernel for all three gradients.
#include "common.cuh"

namespace {

constexpr int kHeadDim = 32;
constexpr int kWarps = 4;
constexpr int kTile = 16 * kWarps;   // rows per block and per staged tile, 16 per warp
constexpr int kLd = kHeadDim + 8;    // row-major tile stride (bf16): conflict-free B fragments
constexpr int kTLd = kTile + 8;      // transposed tile stride (bf16): likewise

// Rows [r0, r0+64) of one head of a [B,S,H] bf16 tensor into shared memory:
// row-major into `rm` and/or transposed into `tr`; rows past S are zeros.
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ src, size_t base, int r0,
                                      int S, int H, __nv_bfloat16* rm, __nv_bfloat16* tr) {
  for (int e = threadIdx.x; e < kTile * (kHeadDim / 8); e += kWarps * 32) {
    const int r = e / (kHeadDim / 8), c = 8 * (e % (kHeadDim / 8));
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(src + base + (size_t)(r0 + r) * H + c);
    if (rm) *reinterpret_cast<uint4*>(&rm[r * kLd + c]) = val;
    if (tr) {
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int d = 0; d < 8; ++d) tr[(c + d) * kTLd + r] = ve[d];
    }
  }
}

// This warp's 16 rows (row0 = first row + gid) x 32 as mma A fragments of
// the two k16 steps over head_dim; rows past S are zeros.
__device__ __forceinline__ void load_rows(uint32_t (&a)[2][4], const __nv_bfloat16* __restrict__ src,
                                          size_t base, int row0, int S, int H, int tig) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + 8 * (i & 1), c = 16 * kk + 8 * (i >> 1) + 2 * tig;
      a[kk][i] = r < S ? ld32(src + base + (size_t)r * H + c) : 0u;
    }
}

// c[16 x 64] = a[16 x 32] times the transpose of a row-major 64 x 32 tile
__device__ __forceinline__ void mma_rows_tile(float (&c)[kTile / 8][4], const uint32_t (&a)[2][4],
                                              const __nv_bfloat16* tile, int gid, int tig) {
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) c[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const __nv_bfloat16* r = &tile[(8 * nt + gid) * kLd + 16 * kk + 2 * tig];
      mma_bf16(c[nt], a[kk], ld32(r), ld32(r + 8));
    }
  }
}

// c[16 x 32] += a[16 x 64] times a 64 x 32 matrix stored transposed (tr[d][row])
__device__ __forceinline__ void mma_acc_tr(float (&c)[kHeadDim / 8][4], const uint32_t (&a)[kTile / 16][4],
                                           const __nv_bfloat16* tr, int gid, int tig) {
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt)
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const __nv_bfloat16* r = &tr[(8 * dt + gid) * kTLd + 16 * kk + 2 * tig];
      mma_bf16(c[dt], a[kk], ld32(r), ld32(r + 8));
    }
}

// One n-tile of an f32 accumulator, rounded to bf16, into the A fragments of
// the next product (two n-tiles of 8 columns make one k16 step).
__device__ __forceinline__ void pack_a(uint32_t (&a)[kTile / 16][4], int nt, const float (&v)[4]) {
  a[nt >> 1][2 * (nt & 1)] = pack_bf16(v[0], v[1]);
  a[nt >> 1][2 * (nt & 1) + 1] = pack_bf16(v[2], v[3]);
}

// [16 x 32] f32 accumulator * scale -> bf16 rows row0, row0+8 of one head
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out, size_t base, int row0, int S,
                                           int H, int tig, const float (&c)[kHeadDim / 8][4], float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int dt = 0; dt < kHeadDim / 8; ++dt)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)row * H + 8 * dt + 2 * tig) =
          pack_bf16(c[dt][2 * r] * scale, c[dt][2 * r + 1] * scale);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                   const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
                   float* __restrict__ stats, int S, int H, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * kLd];       // K, row-major: S = Q K^T
  __shared__ __align__(16) __nv_bfloat16 kt[kHeadDim * kTLd];   // K, transposed: dQ += dS K
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * kLd];       // V, row-major: dP = dO V^T
  __shared__ float bs[kTile];

  const int b = blockIdx.z, head = blockIdx.y, heads = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * kTile + warp * 16 + gid;  // this thread's rows: row0, row0+8
  const size_t base = (size_t)b * S * H + (size_t)head * kHeadDim;

  uint32_t qa[2][4], da[2][4];
  load_rows(qa, q, base, row0, S, H, tig);
  load_rows(da, dout, base, row0, S, H, tig);

  auto load_tile = [&](int k0, bool transposed) {
    __syncthreads();  // the previous tile is no longer read
    stage(k, base, k0, S, H, ks, transposed ? kt : nullptr);
    stage(v, base, k0, S, H, vs, nullptr);
    for (int e = threadIdx.x; e < kTile; e += kWarps * 32)
      bs[e] = k0 + e < S ? bias[(size_t)b * S + k0 + e] : -INFINITY;
    __syncthreads();
  };

  // walk 1: each row's max m, sum l and acc = sum exp(s - m) dP, online
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < S; k0 += kTile) {
    load_tile(k0, false);
    float s[kTile / 8][4], dp[kTile / 8][4];
    mma_rows_tile(s, qa, ks, gid, tig);
    mma_rows_tile(dp, da, vs, gid, tig);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = s[nt][i] * scale + bs[8 * nt + 2 * tig + (i & 1)];
        mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // each row's 64 scores live in the 4 threads of a group
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      const float alpha = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
      acc[r] *= alpha;
    }
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(s[nt][i] - m[i >> 1]);
        l[i >> 1] += e;
        acc[i >> 1] += e * dp[nt][i];
      }
  }
  float dsum[2];
  const size_t plane = (size_t)gridDim.z * heads * S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 1);
    acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 2);
    dsum[r] = acc[r] / l[r];
    const int row = row0 + 8 * r;
    if (tig == 0 && row < S) {
      const size_t at = ((size_t)b * heads + head) * S + row;
      stats[at] = m[r];
      stats[plane + at] = l[r];
      stats[2 * plane + at] = dsum[r];
    }
  }

  // walk 2: dS = P o (dP - D), dQ += dS(bf16) K
  float acc_dq[kHeadDim / 8][4];
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_dq[dt][i] = 0.f;
  for (int k0 = 0; k0 < S; k0 += kTile) {
    load_tile(k0, true);
    float s[kTile / 8][4], dp[kTile / 8][4];
    mma_rows_tile(s, qa, ks, gid, tig);
    mma_rows_tile(dp, da, vs, gid, tig);
    uint32_t sa[kTile / 16][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[nt][i] * scale + bs[8 * nt + 2 * tig + (i & 1)] - m[i >> 1]) / l[i >> 1];
        ds[i] = p * (dp[nt][i] - dsum[i >> 1]);
      }
      pack_a(sa, nt, ds);
    }
    mma_acc_tr(acc_dq, sa, kt, gid, tig);
  }
  store_rows(dq, base, row0, S, H, tig, acc_dq, scale);
}

__global__ void __launch_bounds__(kWarps * 32)
attn_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                     const __nv_bfloat16* __restrict__ dout, const float* __restrict__ stats,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int H,
                     float scale) {
  __shared__ __align__(16) __nv_bfloat16 qs[kTile * kLd];       // Q, row-major: S^T = K Q^T
  __shared__ __align__(16) __nv_bfloat16 qt[kHeadDim * kTLd];   // Q, transposed: dK += dS^T Q
  __shared__ __align__(16) __nv_bfloat16 os[kTile * kLd];       // dO, row-major: dP^T = V dO^T
  __shared__ __align__(16) __nv_bfloat16 ot[kHeadDim * kTLd];   // dO, transposed: dV += P^T dO
  __shared__ float ms[kTile], ls[kTile], dsums[kTile];

  const int b = blockIdx.z, head = blockIdx.y, heads = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int key0 = blockIdx.x * kTile + warp * 16 + gid;  // this thread's keys: key0, key0+8
  const size_t base = (size_t)b * S * H + (size_t)head * kHeadDim;
  const size_t plane = (size_t)gridDim.z * heads * S;
  const float* srow = stats + ((size_t)b * heads + head) * S;

  uint32_t ka[2][4], va[2][4];
  load_rows(ka, k, base, key0, S, H, tig);
  load_rows(va, v, base, key0, S, H, tig);
  float kb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    kb[r] = key0 + 8 * r < S ? bias[(size_t)b * S + key0 + 8 * r] : -INFINITY;

  float acc_dk[kHeadDim / 8][4], acc_dv[kHeadDim / 8][4];
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_dk[dt][i] = acc_dv[dt][i] = 0.f;

  for (int q0 = 0; q0 < S; q0 += kTile) {
    __syncthreads();  // the previous tile is no longer read
    stage(q, base, q0, S, H, qs, qt);
    stage(dout, base, q0, S, H, os, ot);
    for (int e = threadIdx.x; e < kTile; e += kWarps * 32) {
      const bool real = q0 + e < S;  // queries past S add exact zeros
      ms[e] = real ? srow[q0 + e] : INFINITY;
      ls[e] = real ? srow[plane + q0 + e] : 1.f;
      dsums[e] = real ? srow[2 * plane + q0 + e] : 0.f;
    }
    __syncthreads();

    float st[kTile / 8][4], dpt[kTile / 8][4];
    mma_rows_tile(st, ka, qs, gid, tig);
    mma_rows_tile(dpt, va, os, gid, tig);
    uint32_t pa[kTile / 16][4], sa[kTile / 16][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 8 * nt + 2 * tig + (i & 1);  // the query of this element
        p[i] = expf(st[nt][i] * scale + kb[i >> 1] - ms[col]) / ls[col];
        ds[i] = p[i] * (dpt[nt][i] - dsums[col]);
      }
      pack_a(pa, nt, p);
      pack_a(sa, nt, ds);
    }
    mma_acc_tr(acc_dv, pa, ot, gid, tig);
    mma_acc_tr(acc_dk, sa, qt, gid, tig);
  }
  store_rows(dk, base, key0, S, H, tig, acc_dk, scale);
  store_rows(dv, base, key0, S, H, tig, acc_dv, 1.f);
}

}  // namespace

// q/k/v/dout/dq/dk/dv [B,S,H] bf16 (H = num_heads * 32), 16-byte aligned;
// bias [B,S] f32; stats: scratch of 3*B*num_heads*S f32 (each row's max, sum
// and D), written by the first kernel and read by the second.
FRAG_EXPORT int frag_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const float* bias, const void* dout, void* dq, void* dk,
                                         void* dv, float* stats, int B, int S, int H, int num_heads,
                                         void* stream) {
  if (H != num_heads * kHeadDim || S < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((S + kTile - 1) / kTile, num_heads, B);
  const float scale = (float)(1.0 / sqrt((double)kHeadDim));
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  const auto* ob = static_cast<const __nv_bfloat16*>(dout);
  attn_bwd_dq_kernel<<<grid, kWarps * 32, 0, st>>>(qb, kb, vb, bias, ob,
                                                   static_cast<__nv_bfloat16*>(dq), stats, S, H,
                                                   scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv_kernel<<<grid, kWarps * 32, 0, st>>>(qb, kb, vb, bias, ob, stats,
                                                     static_cast<__nv_bfloat16*>(dk),
                                                     static_cast<__nv_bfloat16*>(dv), S, H, scale);
  return (int)cudaGetLastError();
}

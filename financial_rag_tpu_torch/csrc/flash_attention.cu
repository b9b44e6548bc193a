// K2: fused bidirectional multi-head self-attention, forward.
//
// Replaces financial_rag_tpu/ops/flash_attention.py:flash_attention (the
// Pallas kernel _attn_kernel via _fwd_call): q, k, v are [B,S,H] bf16 with the
// heads interleaved along H (head g owns columns g*32 .. g*32+31), bias is an
// additive [B,S] f32 key bias (0 or -1e9), the output is [B,S,H] bf16. Scores,
// bias and softmax stay f32; P is rounded to bf16 (v's dtype) before P@V, as
// the TPU kernel does.
//
// Bound on the H100: at S=512 the work is 4*S*S*head_dim flops per (row,
// head) against 4*S*head_dim*2 bytes, ~256 flop/byte in bf16 -- just under the
// ~295 flop/byte ridge, so the bytes bound it by a hair and the tensor cores
// nearly so; the S*S exponentials on the SFUs are the third limit.
//
// Design: the TPU runs all 12 heads of one batch row in one grid cell (its
// grid is sequential); here the grid is (64-query tile, head, batch row) so
// that thousands of blocks are in flight. Each of the block's 4 warps owns 16
// query rows and runs FlashAttention-2 style on the tensor cores: Q stays in
// registers as mma A fragments, 64-key tiles of K (row-major) and V (stored
// transposed) are staged in shared memory, S = QK^T and O += PV are bf16
// mma.sync m16n8k16 with f32 accumulation, and the scores never leave
// registers (the S accumulators are re-packed as the A operand of PV). The
// softmax is online over key tiles, equal to the TPU's full-row softmax up to
// rounding. Keys past S get bias -inf; a fully masked row sees every real
// score at -1e9, so it gets a defined output: the mean of v over the real
// keys, as the plain version and the TPU give. wgmma, TMA and a pipelined
// K/V ring are later work.
#include "common.cuh"

namespace {

constexpr int kHeadDim = 32;
constexpr int kWarps = 4;
constexpr int kQTile = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kKTile = 64;           // keys per shared-memory tile
constexpr int kKLd = kHeadDim + 8;   // K row stride (bf16): conflict-free B fragments
constexpr int kVLd = kKTile + 8;     // transposed V row stride (bf16): likewise

__global__ void __launch_bounds__(kWarps * 32)
attn_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                __nv_bfloat16* __restrict__ out, int S, int H, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kKTile * kKLd];
  __shared__ __align__(16) __nv_bfloat16 vt[kHeadDim * kVLd];
  __shared__ float bs[kKTile];

  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * kQTile + warp * 16 + gid;  // this thread's rows: row0, row0+8
  const size_t base = (size_t)b * S * H + (size_t)blockIdx.y * kHeadDim;

  uint32_t qa[2][4];  // Q rows as the A operand of the two k16 steps over head_dim
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + 8 * (i & 1), c = 16 * kk + 8 * (i >> 1) + 2 * tig;
      qa[kk][i] = r < S ? ld32(q + base + (size_t)r * H + c) : 0u;
    }

  float o[kHeadDim / 8][4];
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dt][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < S; k0 += kKTile) {
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < kKTile * (kHeadDim / 8); e += kWarps * 32) {
      const int r = e / (kHeadDim / 8), c = 8 * (e % (kHeadDim / 8));
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < S) {
        const size_t src = base + (size_t)(k0 + r) * H + c;
        kv = *reinterpret_cast<const uint4*>(k + src);
        vv = *reinterpret_cast<const uint4*>(v + src);
      }
      *reinterpret_cast<uint4*>(&ks[r * kKLd + c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int d = 0; d < 8; ++d) vt[(c + d) * kVLd + r] = ve[d];
    }
    for (int e = threadIdx.x; e < kKTile; e += kWarps * 32)
      bs[e] = k0 + e < S ? bias[(size_t)b * S + k0 + e] : -INFINITY;
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys, then scale and bias
    float s[kKTile / 8][4];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kKTile / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const __nv_bfloat16* kr = &ks[(8 * nt + gid) * kKLd + 16 * kk + 2 * tig];
        mma_bf16(s[nt], qa[kk], ld32(kr), ld32(kr + 8));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = s[nt][i] * scale + bs[8 * nt + 2 * tig + (i & 1)];
        mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
      }
    }

    // online softmax: each row's 64 scores live in the 4 threads of a group
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int dt = 0; dt < kHeadDim / 8; ++dt)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[dt][i] *= alpha[i >> 1];

    // P (bf16) as the A operand over keys; O += P V
    uint32_t pa[kKTile / 16][4];
#pragma unroll
    for (int nt = 0; nt < kKTile / 8; ++nt) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = expf(s[nt][i] - m[i >> 1]);
        l[i >> 1] += p[i];
      }
      pa[nt >> 1][2 * (nt & 1)] = pack_bf16(p[0], p[1]);
      pa[nt >> 1][2 * (nt & 1) + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int dt = 0; dt < kHeadDim / 8; ++dt)
#pragma unroll
      for (int kk = 0; kk < kKTile / 16; ++kk) {
        const __nv_bfloat16* vr = &vt[(8 * dt + gid) * kVLd + 16 * kk + 2 * tig];
        mma_bf16(o[dt], pa[kk], ld32(vr), ld32(vr + 8));
      }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int dt = 0; dt < kHeadDim / 8; ++dt)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)row * H + 8 * dt + 2 * tig) =
          pack_bf16(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
  }
}

}  // namespace

// q/k/v/out [B,S,H] bf16 (H = num_heads * 32), 16-byte aligned; bias [B,S] f32.
FRAG_EXPORT int frag_flash_attention(const void* q, const void* k, const void* v,
                                     const float* bias, void* out, int B, int S, int H,
                                     int num_heads, void* stream) {
  if (H != num_heads * kHeadDim || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((S + kQTile - 1) / kQTile, num_heads, B);
  const float scale = (float)(1.0 / sqrt((double)kHeadDim));
  attn_fwd_kernel<<<grid, kWarps * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), bias, static_cast<__nv_bfloat16*>(out), S, H,
      scale);
  return (int)cudaGetLastError();
}

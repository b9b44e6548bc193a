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
// answer prompt) the causal QK^T and PV are ~30 GFLOP, ~0.030 ms at 989
// TFLOP/s bf16, against ~16.8 MB of q/k/v/out, ~0.005 ms at 3.35 TB/s: the
// operations bound it.
//
// Design: K2's (csrc/flash_attention.cu). The TPU runs all heads of one
// batch row in a grid cell and keeps the row's whole K and V in VMEM; here
// the grid is (64-query tile, query head, batch row), heaviest causal tiles
// first. Each of 4 warps owns 16 query rows: Q stays in registers as mma A
// fragments, 64-key tiles of K (row-major) and V (transposed) are staged in
// shared memory, S = QK^T and O += PV are bf16 mma.sync m16n8k16 with f32
// accumulation, and the online softmax stays in registers. A block walks
// key tiles from the one holding key pad_len to the last one that meets its
// last query row (the causal skip); a tile of padding rows only writes
// zeros. The f32 instantiation (LLM_DTYPE=float32 only) is a plain CUDA-core
// loop: four threads per query row, 32-key tiles in shared memory. Later
// work: share each K/V tile across the 7 query heads of a GQA group, wgmma,
// TMA and a pipelined K/V ring.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kQTile = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kKTile = 64;           // keys per shared-memory tile
constexpr int kVLd = kKTile + 8;     // transposed V row stride (bf16): conflict-free B fragments

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
causal_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const int* __restrict__ pad_len,
                       __nv_bfloat16* __restrict__ out, int S, int Hq, int group, float scale) {
  constexpr int kKLd = D + 8;  // K row stride (bf16): conflict-free B fragments
  __shared__ __align__(16) __nv_bfloat16 ks[kKTile * kKLd];
  __shared__ __align__(16) __nv_bfloat16 vt[D * kVLd];

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQTile;  // longest causal rows launch first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = q0 + warp * 16 + gid;  // this thread's rows: row0, row0+8
  const int hq_w = Hq * D, hkv_w = (Hq / group) * D;
  const size_t qbase = (size_t)b * S * hq_w + (size_t)h * D;
  const size_t kbase = (size_t)b * S * hkv_w + (size_t)(h / group) * D;
  const int pad = min(max(pad_len[b], 0), S);

  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dt][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int key_end = min(q0 + kQTile, S);  // keys past the tile's last row are all masked
  if (q0 + kQTile > pad) {                  // else every row of the tile is padding
    uint32_t qa[D / 16][4];  // Q rows as the A operand of the k16 steps over head_dim
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + 8 * (i & 1), c = 16 * kk + 8 * (i >> 1) + 2 * tig;
        qa[kk][i] = r < S ? ld32(q + qbase + (size_t)r * hq_w + c) : 0u;
      }

    for (int k0 = (pad / kKTile) * kKTile; k0 < key_end; k0 += kKTile) {
      __syncthreads();  // the previous tile is no longer read
      for (int e = threadIdx.x; e < kKTile * (D / 8); e += kWarps * 32) {
        const int r = e / (D / 8), c = 8 * (e % (D / 8));
        uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
        if (k0 + r < S) {
          const size_t src = kbase + (size_t)(k0 + r) * hkv_w + c;
          kv = *reinterpret_cast<const uint4*>(k + src);
          vv = *reinterpret_cast<const uint4*>(v + src);
        }
        *reinterpret_cast<uint4*>(&ks[r * kKLd + c]) = kv;
        const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
        for (int d = 0; d < 8; ++d) vt[(c + d) * kVLd + r] = ve[d];
      }
      __syncthreads();

      // S = Q K^T for this warp's 16 rows x 64 keys, scaled, then masked
      float s[kKTile / 8][4];
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < kKTile / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const __nv_bfloat16* kr = &ks[(8 * nt + gid) * kKLd + 16 * kk + 2 * tig];
          mma_bf16(s[nt], qa[kk], ld32(kr), ld32(kr + 8));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + 8 * nt + 2 * tig + (i & 1);
          const int row = row0 + 8 * (i >> 1);
          s[nt][i] = (key >= pad && key <= row && key < S) ? s[nt][i] * scale : -INFINITY;
          mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
        }
      }

      // online softmax: each row's 64 scores live in the 4 threads of a
      // group; a row with no live key so far keeps m = -inf and adds zeros
      float m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = expf(m[r] - m_use[r]);
        m[r] = m_new;
        l[r] *= alpha;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          o[dt][2 * r] *= alpha;
          o[dt][2 * r + 1] *= alpha;
        }
      }

      // P (bf16) as the A operand over keys; O += P V
      uint32_t pa[kKTile / 16][4];
#pragma unroll
      for (int nt = 0; nt < kKTile / 8; ++nt) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = expf(s[nt][i] - m_use[i >> 1]);
          l[i >> 1] += p[i];
        }
        pa[nt >> 1][2 * (nt & 1)] = pack_bf16(p[0], p[1]);
        pa[nt >> 1][2 * (nt & 1) + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
        for (int kk = 0; kk < kKTile / 16; ++kk) {
          const __nv_bfloat16* vr = &vt[(8 * dt + gid) * kVLd + 16 * kk + 2 * tig];
          mma_bf16(o[dt], pa[kk], ld32(vr), ld32(vr + 8));
        }
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
    const float inv = row < pad ? 0.f : 1.f / l[r];  // padding rows: zeros
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(out + qbase + (size_t)row * hq_w + 8 * dt + 2 * tig) =
          pack_bf16(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
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
FRAG_EXPORT int frag_causal_flash(const void* q, const void* k, const void* v, const int* pad_len,
                                  void* out, int B, int S, int Hq, int Hkv, int D, int dtype,
                                  void* stream) {
  if (S < 1 || B < 1 || Hkv < 1 || Hq % Hkv || (D != 64 && D != 128)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((S + kQTile - 1) / kQTile, Hq, B);
  const int group = Hq / Hkv;
  const float scale = (float)(1.0 / sqrt((double)D));
  if (dtype == FRAG_BF16) {
    const auto* qb = static_cast<const __nv_bfloat16*>(q);
    const auto* kb = static_cast<const __nv_bfloat16*>(k);
    const auto* vb = static_cast<const __nv_bfloat16*>(v);
    auto* ob = static_cast<__nv_bfloat16*>(out);
    if (D == 64)
      causal_fwd_bf16_kernel<64><<<grid, kWarps * 32, 0, st>>>(qb, kb, vb, pad_len, ob, S, Hq, group, scale);
    else
      causal_fwd_bf16_kernel<128><<<grid, kWarps * 32, 0, st>>>(qb, kb, vb, pad_len, ob, S, Hq, group, scale);
  } else if (dtype == FRAG_F32) {
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

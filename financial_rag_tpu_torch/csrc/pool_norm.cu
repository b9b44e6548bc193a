// K1: fused masked mean-pool + L2-normalise (the gte-small pooling).
//
// Replaces financial_rag_tpu/ops/pool_norm.py:masked_mean_l2_normalize (the
// Pallas kernel _pool_norm_kernel): [B,S,H] hidden states (bf16 or f32) and a
// [B,S] f32 mask in, [B,H] f32 unit vectors out. out = pooled * rsqrt(max(
// sum(pooled^2), 1e-24)) with pooled = sum_s(h*m) / max(sum_s(m), 1e-9). The
// mask is a weight (h*m), not only a selection; tokens whose weight is 0 are
// never read; a row with no weight gives a zero vector.
//
// Bound on the H100: device-memory bytes. It reads each live token's H
// values once and does ~2 flops per value, far below the 295 flop/byte ridge.
//
// Design: a block of 384 threads takes one batch row (or a span of its
// tokens, below). Each thread loads 16 bytes of a token (8 bf16 or 4 f32
// values): at H=384 bf16, 48 vector lanes cover a token and the 384 threads
// cover 8 tokens at once, and the token loop is unrolled 4 deep, so a thread
// has 4 independent 16-byte loads in flight. The span's mask is staged in
// shared memory once per 1,024 tokens, with the last token of nonzero
// weight, so the loop stops there and a padded tail costs nothing; a hole in
// the mask skips its load by predicate. The token groups' f32 partials fold
// in shared memory, then the norm is one block reduction.
//
// A small batch (the ingest's ~68 rows) gives fewer blocks than the card
// has SMs. Below 2 x SMs rows, the tokens of a row are split over a
// thread-block cluster of 2 or 4 CTAs (a span of at least 64 tokens each):
// each CTA folds its partial sums in its own shared memory, and the first
// CTA of the cluster sums the others' through distributed shared memory, in
// rank order (the same bits run to run), and writes the row. The cluster,
// not a second kernel or atomics, so the partials never reach device memory
// and the row is written once. Tried on the H100 and dropped, each slower:
// 8 loads in flight a thread, and splitting rows up to 4 x SMs (4 CTAs a row
// at B=256).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;         // independent 16-byte loads in flight a thread
constexpr int kMaskChunk = 1024;   // tokens of mask staged at a time
constexpr int kMaxCluster = 4;
constexpr int kMinSpan = 64;       // fewest tokens a CTA of a cluster takes
constexpr int kMaxPartialBytes = 48 * 1024;

__device__ __forceinline__ void unpack16(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}

// Blocks come in clusters of `csize` consecutive blockIdx.x: block
// blockIdx.x / csize is the batch row, blockIdx.x % csize its rank, which
// takes tokens rank*span .. rank*span + span - 1.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pool_norm_kernel(const T* __restrict__ hidden, const float* __restrict__ mask,
                 float* __restrict__ out, int S, int H, int span, int csize) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ float part[];  // [groups][H] partial sums; row 0 then the pooled row
  __shared__ float smask[kMaskChunk];
  __shared__ float scratch[kWarps];
  __shared__ int warp_last[kWarps];
  __shared__ float cta_weight;
  const int b = blockIdx.x / csize, rank = blockIdx.x % csize;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lanes = H / kVec;                      // 16-byte vectors a token
  const int L = min(lanes, kThreads), G = kThreads / L;  // vector lanes, token groups
  const int g = threadIdx.x / L, l = threadIdx.x - g * L;
  const T* hb = hidden + (size_t)b * S * H;
  const float* mb = mask + (size_t)b * S;

  for (int i = threadIdx.x; i < G * H; i += kThreads) part[i] = 0.f;
  float wsum = 0.f;
  const int s_end = min(S, (rank + 1) * span);
  for (int c0 = rank * span; c0 < s_end; c0 += kMaskChunk) {
    const int n = min(kMaskChunk, s_end - c0);
    __syncthreads();  // the previous chunk's mask and last token are read
    int last = -1;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float m = mb[c0 + i];
      smask[i] = m;
      wsum += m;
      if (m != 0.f) last = i;
    }
    for (int off = 16; off > 0; off >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, off));
    if (lane == 0) warp_last[warp] = last;
    __syncthreads();
    int live = 0;  // tokens up to and with the chunk's last of nonzero weight
#pragma unroll
    for (int w = 0; w < kWarps; ++w) live = max(live, warp_last[w] + 1);
    if (g >= G) continue;
    for (int cv = l; cv < lanes; cv += L) {
      float acc[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = 0.f;
      const T* col = hb + (size_t)c0 * H + cv * kVec;
      for (int i = g; i < live; i += kUnroll * G) {
        uint4 u[kUnroll];
        float m[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int t = i + k * G;
          m[k] = t < live ? smask[t] : 0.f;
          u[k] = m[k] != 0.f ? __ldg(reinterpret_cast<const uint4*>(col + (size_t)t * H))
                             : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          float v[kVec];
          unpack16(u[k], v);
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[e] = fmaf(v[e], m[k], acc[e]);
        }
      }
      float* p = part + g * H + cv * kVec;
#pragma unroll
      for (int e = 0; e < kVec; ++e) p[e] += acc[e];
    }
  }

  float weight = block_sum(wsum, scratch);  // its barriers also publish the partials
  for (int c = threadIdx.x; c < H; c += kThreads) {
    float s = part[c];
    for (int gg = 1; gg < G; ++gg) s += part[gg * H + c];
    part[c] = s;
  }
  if (csize > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) cta_weight = weight;
    cluster.sync();  // every CTA's row of partials and weight is final
    if (rank == 0) {
      for (int c = threadIdx.x; c < H; c += kThreads) {
        float s = part[c];
        for (int r = 1; r < csize; ++r) s += cluster.map_shared_rank(part, r)[c];
        part[c] = s;
      }
      for (int r = 1; r < csize; ++r) weight += *cluster.map_shared_rank(&cta_weight, r);
    }
    cluster.sync();  // the first CTA has read the others' shared memory
    if (rank != 0) return;
  }

  const float count = fmaxf(weight, 1e-9f);
  float sq = 0.f;
  for (int c = threadIdx.x; c < H; c += kThreads) {
    const float p = part[c] / count;
    part[c] = p;
    sq += p * p;
  }
  const float inv = rsqrtf(fmaxf(block_sum(sq, scratch), 1e-24f));
  for (int c = threadIdx.x; c < H; c += kThreads) out[(size_t)b * H + c] = part[c] * inv;
}

template <typename T>
cudaError_t launch_pool_norm(const void* hidden, const float* mask, float* out, int B, int S,
                             int H, cudaStream_t st) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int csize = 1;
  while (csize < kMaxCluster && (long long)B * csize < 2LL * sms && S >= 2 * kMinSpan * csize)
    csize *= 2;
  const int span = S > 0 ? (S + csize - 1) / csize : 1;
  const int lanes = H / (16 / (int)sizeof(T));
  const int L = lanes < kThreads ? lanes : kThreads;
  const size_t smem = (size_t)(kThreads / L) * H * sizeof(float);
  if (smem > kMaxPartialBytes) return cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * csize));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = csize > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, pool_norm_kernel<T>, static_cast<const T*>(hidden), mask, out,
                            S, H, span, csize);
}

}  // namespace

// hidden [B,S,H] bf16 or f32, 16-byte aligned, H % 8 == 0; mask [B,S] f32;
// out [B,H] f32. B == 0 launches nothing.
FRAG_EXPORT int frag_pool_norm(const void* hidden, const float* mask, float* out,
                               int B, int S, int H, int dtype, void* stream) {
  if (B < 0 || S < 0 || H < 8 || H % 8 || (reinterpret_cast<uintptr_t>(hidden) & 15))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == FRAG_BF16 ? launch_pool_norm<__nv_bfloat16>(hidden, mask, out, B, S, H, st)
                         : launch_pool_norm<float>(hidden, mask, out, B, S, H, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

FRAG_EXPORT const char* frag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

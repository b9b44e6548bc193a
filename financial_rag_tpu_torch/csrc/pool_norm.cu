// K1: fused masked mean-pool + L2-normalise (the gte-small pooling).
//
// Replaces financial_rag_tpu/ops/pool_norm.py:masked_mean_l2_normalize (the
// Pallas kernel _pool_norm_kernel): [B,S,H] hidden states (bf16 or f32) and a
// [B,S] f32 mask in, [B,H] f32 unit vectors out. out = pooled * rsqrt(max(
// sum(pooled^2), 1e-24)) with pooled = sum_s(h*m) / max(sum_s(m), 1e-9).
//
// Bound on the H100: device-memory bytes. It reads B*S*H hidden values once
// and does ~2 flops per value, far below the 295 flop/byte ridge.
//
// Design: one block per batch row; each thread owns H/blockDim columns and
// walks the sequence, so consecutive threads read consecutive columns of a
// token (coalesced). Tokens whose mask is 0 are skipped, so pad tokens are
// never read. Accumulation is f32 throughout, as on the TPU; the norm is one
// block reduction. A later PR can split S across warps for more bytes in
// flight.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
pool_norm_kernel(const T* __restrict__ hidden, const float* __restrict__ mask,
                 float* __restrict__ out, int S, int H) {
  __shared__ float scratch[kThreads / 32];
  extern __shared__ float pooled[];  // H floats
  const int b = blockIdx.x;
  const T* hb = hidden + (size_t)b * S * H;
  const float* mb = mask + (size_t)b * S;

  float c = 0.f;
  for (int s = threadIdx.x; s < S; s += blockDim.x) c += mb[s];
  const float count = fmaxf(block_sum(c, scratch), 1e-9f);

  float sq = 0.f;
  for (int col = threadIdx.x; col < H; col += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) {
      const float m = mb[s];
      if (m != 0.f) acc += to_f32(hb[(size_t)s * H + col]) * m;
    }
    const float p = acc / count;
    pooled[col] = p;
    sq += p * p;
  }
  const float inv = rsqrtf(fmaxf(block_sum(sq, scratch), 1e-24f));
  for (int col = threadIdx.x; col < H; col += blockDim.x)
    out[(size_t)b * H + col] = pooled[col] * inv;
}

}  // namespace

FRAG_EXPORT int frag_pool_norm(const void* hidden, const float* mask, float* out,
                               int B, int S, int H, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)H * sizeof(float);
  if (dtype == FRAG_BF16) {
    pool_norm_kernel<__nv_bfloat16><<<B, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(hidden), mask, out, S, H);
  } else {
    pool_norm_kernel<float><<<B, kThreads, smem, st>>>(
        static_cast<const float*>(hidden), mask, out, S, H);
  }
  return (int)cudaGetLastError();
}

FRAG_EXPORT const char* frag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

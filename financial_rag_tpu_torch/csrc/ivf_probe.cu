// K8: the IVF probe, a gather of whole posting lists and their scores.
//
// Replaces financial_rag_tpu/ops/ivf_probe.py:probe_scores (Pallas kernel
// _probe_kernel). For query b and probe p, with li = probes[b, p]:
//   out[b, p, l] = s * w + (live - 1) * 1e5,  s = q_b . storage[li, l],
//   w = weights[li, l] (0 = empty slot -> -1e5; int8: s is the exact int32
//   dot, w the row's dequantization weight).
// The per-query int8 scale is applied by the caller, as in JAX.
//
// Bound on the H100: device-memory bytes. Each probe reads a contiguous
// [L, D] list (L*D*2 bytes in bf16) and its L weights and writes L scores;
// there are 2*D operations per 2*D (bf16) bytes read.
//
// Design: the TPU brings probes[b, p] in by scalar prefetch and lets the
// pipeline DMA the list tile. Here one block takes 64 rows of one (query,
// probe) list, so even a single query's few probes fill the card: it reads
// its list id itself, holds the query row in shared memory (f32 for bf16/f32
// lists, raw bytes for int8), and streams its rows with 16-byte loads, eight
// threads to a row (128 contiguous bytes per load step), 32 rows in flight;
// the eight partial dots meet by warp shuffle.
// int8 rows take __dp4a into an int32 sum, exact as the TPU's int32 dot. Like
// the TPU grid, a list probed by several queries is read once per query;
// grouping those queries is later work. List ids outside [0, nlist) are
// clamped, so a bad id cannot read outside the storage.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowThreads = 8;     // threads per list row
constexpr int kBlockRows = 64;     // list rows per block

__device__ __forceinline__ float chunk_dot(const uint4& v, const float* qf, int c) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float* qc = qf + 8 * c;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    acc = fmaf(f.x, qc[2 * j], acc);
    acc = fmaf(f.y, qc[2 * j + 1], acc);
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const T* __restrict__ q, const T* __restrict__ storage,
             const float* __restrict__ weights, const int* __restrict__ probes,
             float* __restrict__ out, int P, int nlist, int L, int D) {
  extern __shared__ __align__(16) unsigned char qsm[];
  const int p = blockIdx.x, b = blockIdx.y;
  const int li = min(max(probes[(size_t)b * P + p], 0), nlist - 1);
  const T* qrow = q + (size_t)b * D;
  float* qf = reinterpret_cast<float*>(qsm);
  if constexpr (sizeof(T) == 1) {
    for (int d = threadIdx.x; d < D; d += kThreads) qsm[d] = reinterpret_cast<const unsigned char*>(qrow)[d];
  } else {
    for (int d = threadIdx.x; d < D; d += kThreads) qf[d] = to_f32(qrow[d]);
  }
  __syncthreads();

  const int sub = threadIdx.x % kRowThreads;
  const int chunks = D * (int)sizeof(T) / 16;
  const T* list = storage + (size_t)li * L * D;
  const float* w = weights + (size_t)li * L;
  float* o = out + ((size_t)b * P + p) * L;
  const int l_end = min(L, (int)(blockIdx.z + 1) * kBlockRows);
  for (int l = blockIdx.z * kBlockRows + threadIdx.x / kRowThreads; l < l_end;
       l += kThreads / kRowThreads) {
    const uint4* row = reinterpret_cast<const uint4*>(list + (size_t)l * D);
    float s;
    if constexpr (sizeof(T) == 1) {
      const int* qi = reinterpret_cast<const int*>(qsm);
      int acc = 0;
      for (int c = sub; c < chunks; c += kRowThreads) {
        const uint4 v = row[c];
        acc = __dp4a((int)v.x, qi[4 * c], acc);
        acc = __dp4a((int)v.y, qi[4 * c + 1], acc);
        acc = __dp4a((int)v.z, qi[4 * c + 2], acc);
        acc = __dp4a((int)v.w, qi[4 * c + 3], acc);
      }
#pragma unroll
      for (int off = kRowThreads / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      s = __int2float_rn(acc);
    } else {
      float acc = 0.f;
      for (int c = sub; c < chunks; c += kRowThreads) {
        const uint4 v = row[c];
        if constexpr (sizeof(T) == 2) {
          acc += chunk_dot(v, qf, c);
        } else {
          const float* qc = qf + 4 * c;
          acc = fmaf(__uint_as_float(v.x), qc[0], acc);
          acc = fmaf(__uint_as_float(v.y), qc[1], acc);
          acc = fmaf(__uint_as_float(v.z), qc[2], acc);
          acc = fmaf(__uint_as_float(v.w), qc[3], acc);
        }
      }
#pragma unroll
      for (int off = kRowThreads / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      s = acc;
    }
    if (sub == 0) {
      const float wl = w[l];
      const float live = wl > 0.f ? 1.f : 0.f;
      o[l] = __fadd_rn(__fmul_rn(s, wl), (live - 1.f) * 1.0e5f);
    }
  }
}

template <typename T>
void launch(const void* q, const void* storage, const float* weights, const int* probes,
            float* out, int B, int P, int nlist, int L, int D, cudaStream_t st) {
  const dim3 grid(P, B, (L + kBlockRows - 1) / kBlockRows);
  probe_kernel<T><<<grid, kThreads, (size_t)D * sizeof(float), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(storage), weights, probes, out, P, nlist,
      L, D);
}

}  // namespace

// q [B,D], storage [nlist,L,D] in the same dtype (f32 / bf16 / int8), weights
// [nlist,L] f32, probes [B,P] int32, out [B,P,L] f32. Rows are whole 16-byte
// chunks: D*sizeof(dtype) % 16 == 0, and storage 16-byte aligned; L % 32 == 0
// (a warp's four rows finish their shuffles together; kBlockRows is a
// multiple of 32 too).
FRAG_EXPORT int frag_probe_scores(const void* q, const void* storage, const float* weights,
                                  const int* probes, float* out, int B, int P, int nlist, int L,
                                  int D, int dtype, void* stream) {
  const int esize = dtype == FRAG_I8 ? 1 : dtype == FRAG_BF16 ? 2 : 4;
  if (B < 1 || P < 1 || nlist < 1 || L < 1 || L % (kThreads / kRowThreads) || D < 1 ||
      (D * esize) % 16 || B > 65535 || (L + kBlockRows - 1) / kBlockRows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == FRAG_BF16) {
    launch<__nv_bfloat16>(q, storage, weights, probes, out, B, P, nlist, L, D, st);
  } else if (dtype == FRAG_I8) {
    launch<int8_t>(q, storage, weights, probes, out, B, P, nlist, L, D, st);
  } else {
    launch<float>(q, storage, weights, probes, out, B, P, nlist, L, D, st);
  }
  return (int)cudaGetLastError();
}

// Shared helpers for the port's hand-written CUDA kernels.
//
// Every entry point has a plain C interface (pointers, ints and the caller's
// stream), is loaded from Python with ctypes, launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError() so that a launch
// the device refused reaches the Python wrapper as an exception.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FRAG_EXPORT extern "C" __attribute__((visibility("default")))

// dtype codes shared with financial_rag_tpu_torch/ops/kernel_lib.py
enum FragDtype { FRAG_F32 = 0, FRAG_BF16 = 1, FRAG_I8 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Sum over the block; every thread gets the total. `scratch` holds one float
// per warp. blockDim.x must be a multiple of 32.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();  // scratch may still be read by an earlier call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < nwarps; ++w) total += scratch[w];
  return total;
}

// ---- bf16 tensor-core helpers (mma.sync m16n8k16, f32 accumulate) --------
//
// Fragment layouts of m16n8k16 (gid = lane / 4, tig = lane % 4):
//   A reg i: row gid + 8*(i&1), columns 8*(i>>1) + 2*tig, +1
//   B reg i: rows (k) 8*i + 2*tig, +1, column (n) gid
//   C elt i: row gid + 8*(i>>1), column 2*tig + (i&1)
// A register (or B register) holds two bf16, the lower column (row) in its
// low half.

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c[16x8] += a[16x16] * b[16x8]
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

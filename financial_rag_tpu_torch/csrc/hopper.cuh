// Hopper (sm_90a) building blocks shared by the redesigned kernels K2
// (flash_attention.cu), K3 (fused_ffn.cu), K4 (packed_topk.cu), K5
// (bucketed_topk.cu), K6 (topk_exact.cu), K9 (causal_flash.cu) and K10
// (flash_attention_bwd.cu).
//
// Tile loads: cp.async (16 bytes a thread, zero-filled past the ragged edge)
// into a ring of shared-memory stages, not TMA. The tiles are one head's
// rows of a tensor whose heads interleave along the last axis (64 to 256
// bytes of every 768- or 1,792-byte row), the last tile of a sequence is
// ragged (any S), and at the train shapes a block reads one or two tiles of
// each operand: cp.async zero-fills the rows past S, needs no tensor map
// built on the host for every launch, and a kernel's own threads (or one
// producer warp) keep the next stages in flight while the current one is
// multiplied. A stage is published to the tensor cores by the thread that
// waited for its copies: cp.async.wait_group, then fence.proxy.async (the
// copies are generic-proxy writes and wgmma reads through the async proxy),
// then a block barrier or an mbarrier arrive. K3's weight chunks are one
// exception: whole boxes of a plain row-major matrix, the same for every
// block, so one thread has the TMA copy them (tensor_map_2d / _3d,
// tma_load_2d / _3d), swizzled, and their bytes complete the stage's
// mbarrier. K2's two kernels, K10's fused head-64 kernel and K9's head-128
// kernel are the others: their tiles are boxes of one head's columns of a
// 3-D map over [B][S][H] (K2's: a 4-D map over [B][S][heads][dh], so that a
// narrower head's columns past dh read as zeros, or a 3-D window on a
// 16-byte column) built for every launch, rows past S read as zeros, and
// K2's attn_fwd_d64_kernel and K10 write their outputs the same way back
// (tma_store_3d / _4d from a staging tile, stage_rows_sw128).
//
// Products: wgmma m64nNk16, bf16 in, f32 accumulate (and m64n32k32, int8
// in, exact int32 accumulate, for the int8 sweeps). B always comes from
// shared memory through a descriptor; A from shared memory or from
// registers, where it is a previous product's accumulator (P, dS) rounded to
// bf16. Accumulator layout (thread t of the warpgroup, w = t/32, lane l):
// d[4*j + e] is row 16*w + l/4 + 8*(e/2), column 8*j + 2*(l%4) + (e%2),
// the m16n8 C layout of each 8-column block (the int8 product's int32
// accumulator is laid out the same way); a register A operand is the
// m16n8k16 A fragment, so two 8-column blocks of an accumulator make one k16
// step (pack_a below).
//
// Shared-memory layouts are the canonical GMMA ones, swizzled: rows of 32
// (SW32), 64 (SW64) or 128 (SW128) bytes, 16-byte chunk c of row r stored at
// chunk c ^ ((byte offset >> 7) & (1 << B) - 1) with B = 1, 2 or 3, tiles
// aligned to 1,024 bytes. A tile stored [row][feature] serves as a K-major operand
// (features are the k dimension: S = Q K^T) and, with the transpose bit, as
// an MN-major one (rows are the k dimension: O = P V, dQ = dS K), so no
// operand is ever transposed in memory.
#pragma once

#include <cuda.h>  // CUtensorMap and its encoder's types (no libcuda link: see tensor_map_2d)

#include <atomic>

#include "common.cuh"

namespace hopper {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async -------------------------------------------------------------

// 16 bytes from global to shared; zeros when !valid (src is not read then).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
// 4 bytes from global to shared (always valid).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void st_shared_f32(uint32_t dst, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" :: "r"(dst), "f"(v) : "memory");
}
__device__ __forceinline__ void st_shared_u32(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(dst), "r"(v) : "memory");
}
// The 16-byte chunk of bf16 at `src` (16-byte aligned) into shared memory at
// `dst`, of which only the columns lo .. hi-1 (even; the chunk's are 0 .. 7)
// are read: the others land as zeros. A head read where it lies, whose
// columns do not fill its 16-byte chunks, takes its own columns this way and
// none of its neighbours': whole chunks by one 16-byte copy, a chunk that
// holds none by the copy's zero fill (src not read), a partial chunk by
// 4-byte copies of its pieces and zero stores of the rest. The zeros of a
// partial chunk are generic stores: like the copies, they are ordered before
// the tensor cores' reads by the publishing thread's fence.proxy.async.
__device__ __forceinline__ void cp_async_cols(uint32_t dst, const __nv_bfloat16* src, int lo, int hi) {
  if (lo <= 0 && hi >= 8) {
    cp_async16(dst, src, true);
  } else if (hi <= lo || hi <= 0 || lo >= 8) {
    cp_async16(dst, src, false);
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (2 * p >= lo && 2 * p + 2 <= hi) cp_async4(dst + 4 * p, src + 2 * p);
      else st_shared_u32(dst + 4 * p, 0u);
    }
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// Order this thread's generic-proxy shared-memory writes (cp.async
// included, once waited for) before later async-proxy reads (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk `off` (a multiple of 16 within a 1,024-byte
// aligned tile) under the Swizzle<B,4,3> pattern of the SW32/64/128 modes.
template <int B>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & ((1u << B) - 1)) << 4);
}

// Byte offset of 16-byte chunk ch of row r of a tile stored as regions of
// 64 rows x 128 bytes (64 bf16 columns each) in the 128-byte swizzle.
__device__ __forceinline__ uint32_t sw128_chunk(int r, int ch) {
  return (ch >> 3) * (64 * 128) + swz<3>(r * 128 + (ch & 7) * 16);
}

// bar.sync on barrier `id` (1-15; 0 is __syncthreads) for `count` threads.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
// bar.arrive: count this thread toward barrier `id`'s `count` without waiting.
__device__ __forceinline__ void named_barrier_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// ---- mbarrier -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
// Arrive on `bar` and add `bytes` to the transaction count its phase waits
// for (the bytes the tensor copies below will deliver).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// Make the initialised barriers visible before any thread uses them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}
// Block until the phase of parity `parity` has completed (a barrier starts
// in phase 0; its n-th completion, from 0, is waited for with parity n & 1).
// A wait that never ends is a bug: trap after 4 s instead of hanging the
// device.
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const uint64_t start = global_ns();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (global_ns() - start > 4000000000ull) __trap();
  }
}

// 2^x in one MUFU.EX2 (flushes subnormal results to 0; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- TMA ------------------------------------------------------------------

// The box of a 2-D tensor map at element coordinates (c0 innermost, c1) into
// shared memory at `dst`, swizzled as the map says; completes `bytes` of
// `bar`'s transaction count. `map` is a __grid_constant__ kernel parameter.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// The box of a 3-D tensor map at element coordinates (c0 innermost, c1, c2).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}
// The box of a 3-D tensor map at (c0, c1, c2) from shared memory at `src`
// (laid out and swizzled as the map says) to global memory, in this
// thread's bulk async group; elements outside the tensor are not written.
// The shared memory must not change until bulk_wait_read says the copy has
// read it; the global writes are complete after bulk_wait.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2) : "memory");
}
// The same for a 2-D tensor map at (c0, c1).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1) : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// Wait until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}
// Wait until at most N of this thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows row0 and row0 + 8 of an f32 [64 x 64] accumulator (the wgmma
// layout, tig = lane % 4) times `scale`, as bf16 into a 64-row tile of
// 128-byte rows in the 128-byte swizzle at `tile` (a TMA store's source).
__device__ __forceinline__ void stage_rows_sw128(uint32_t tile, int row0, int tig, const float (&c)[32],
                                                 float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      st_shared_u32(tile + swz<3>((row0 + 8 * r) * 128 + nt * 16) + 4 * tig,
                    pack_bf16(c[4 * nt + 2 * r] * scale, c[4 * nt + 2 * r + 1] * scale));
}

// Fetch a tensor map (a __grid_constant__ kernel parameter) into the TMA
// unit's descriptor cache ahead of its first copy.
__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// from global memory into shared memory at `dst` by the TMA, completing
// `bytes` of `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

using TensorMapEncode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                     const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                     const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                     CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
// cuTensorMapEncodeTiled, looked up once at run time through the CUDA
// runtime's entry-point query, so the library needs no link against
// libcuda (null if the driver lacks it).
inline TensorMapEncode tensor_map_encoder() {
  static const TensorMapEncode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<TensorMapEncode>(fn);
  }();
  return encode;
}

// A 2-D tensor map of a row-major [rows][cols] matrix of bf16 (elem_bytes
// 2) or 8-bit (elem_bytes 1) elements, 16-byte aligned, cols * elem_bytes a
// multiple of 16, read in boxes of [box_rows][box_cols] with the given
// swizzle. Returns false if the encoder refuses.
inline bool tensor_map_2d(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                          uint32_t box_rows, uint32_t box_cols, CUtensorMapSwizzle swizzle,
                          uint32_t elem_bytes = 2) {
  const TensorMapEncode encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t element_strides[2] = {1, 1};
  const CUtensorMapDataType type =
      elem_bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The box of a 4-D tensor map at element coordinates (c0 innermost, .., c3).
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(smem_u32(bar))
      : "memory");
}
// The box of a 4-D tensor map at (c0, .., c3) from shared memory at `src`
// to global memory, as tma_store_3d.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A 3-D tensor map of bf16 elements: dims[0] innermost (contiguous), the
// byte strides of dims[1] and dims[2] (multiples of 16, in any order), read
// in boxes of box[0] x box[1] x box[2] that land in shared memory with
// dims[0] innermost, then dims[1], then dims[2]. Returns false if the
// encoder refuses.
inline bool tensor_map_3d(CUtensorMap* map, const void* base, const uint64_t (&dims)[3],
                          const uint64_t (&strides)[2], const uint32_t (&box)[3],
                          CUtensorMapSwizzle swizzle) {
  const TensorMapEncode encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t d[3] = {dims[0], dims[1], dims[2]};
  const cuuint64_t st[2] = {strides[0], strides[1]};
  const cuuint32_t b[3] = {box[0], box[1], box[2]};
  const cuuint32_t element_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), d, st, b,
                element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-D tensor map of bf16 elements, as tensor_map_3d: dims[0] innermost,
// the byte strides of dims[1] .. dims[3]. A box wider than dims[0] reads
// the columns past it as zeros and a store of it does not write them.
inline bool tensor_map_4d(CUtensorMap* map, const void* base, const uint64_t (&dims)[4],
                          const uint64_t (&strides)[3], const uint32_t (&box)[4],
                          CUtensorMapSwizzle swizzle) {
  const TensorMapEncode encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t d[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t st[3] = {strides[0], strides[1], strides[2]};
  const cuuint32_t b[4] = {box[0], box[1], box[2], box[3]};
  const cuuint32_t element_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), d, st, b,
                element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The current device's SM count, having opted `kernel` in to `smem` bytes of
// dynamic shared memory on it: the first call on a device makes both runtime
// calls and keeps the count in `cache` (one entry a device, zero until
// then), so that later launches make neither. A CUDA error comes back
// negated.
constexpr int kMaxDevices = 64;
template <typename Kernel>
inline int opted_sm_count(Kernel kernel, int smem, std::atomic<int> (&cache)[kMaxDevices]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return -(int)err;
  if (device < kMaxDevices) {
    const int kept = cache[device].load(std::memory_order_relaxed);
    if (kept > 0) return kept;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int sms = 0;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  if (device < kMaxDevices) cache[device].store(sms, std::memory_order_relaxed);
  return sms;
}

// Give this warpgroup's registers back down to N a thread (a producer), or
// take up to N (a consumer): all four warps of the warpgroup execute it.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// Max and sum over the 4 threads of a quad (one accumulator row's columns).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- wgmma ----------------------------------------------------------------

enum Swizzle : int { kSw128 = 1, kSw64 = 2, kSw32 = 3 };

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (LBO, SBO), swizzle mode; base offset 0 (tiles 1,024-aligned).
// K-major: SBO = bytes between 8-row groups, LBO unused. MN-major: SBO =
// bytes between 8-row groups along k, LBO = bytes between swizzle-wide
// column blocks along N.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, int swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | ((uint64_t)swizzle << 62);
}

// A tile of 64-byte rows (32 bf16 a row: one head's slice) in the 64-byte
// swizzle, 1,024-aligned. K-major operand, k16 step kk (the 32 features
// are k); MN-major operand, k16 step kk (the rows are k, 16 rows a step;
// N = 32 is one swizzle-wide column block, so LBO is not read).
__device__ __forceinline__ uint64_t sw64_kmajor(uint32_t tile, int kk) {
  return make_desc(tile + 32 * kk, 16, 512, kSw64);
}
__device__ __forceinline__ uint64_t sw64_mnmajor(uint32_t tile, int kk) {
  return make_desc(tile + 1024 * kk, 4096, 512, kSw64);
}

// One attention head's slice of a 64-row tile (K2, K10): D bf16 = 2*D bytes
// a row in the swizzle of that width (64-byte rows in SW64 at D = 32,
// 128-byte rows in SW128 at D = 64), 1,024-aligned.
template <int D>
struct HeadTile {
  static_assert(D == 32 || D == 64, "a head is 32 or 64 wide");
  static constexpr int kRows = 64;
  static constexpr int kRowBytes = 2 * D;           // 64 or 128
  static constexpr int kChunks = D / 8;             // 16-byte chunks of a row: 4 or 8
  static constexpr int kChunkBits = D == 32 ? 2 : 3;
  static constexpr int kSwizzle = D == 32 ? 2 : 3;  // SW64, SW128
  static constexpr int kTileBytes = kRows * kRowBytes;  // 4 or 8 KB

  // byte offset of 16-byte chunk ch of row r
  __device__ static uint32_t at(int r, int ch) { return swz<kSwizzle>(r * kRowBytes + ch * 16); }
  // the tile as the K-major operand (the D features are k), k16 step kk
  __device__ static uint64_t kmajor(uint32_t tile, int kk) {
    if constexpr (D == 32) return sw64_kmajor(tile, kk);
    else return make_desc(tile + 32 * kk, 16, 1024, kSw128);
  }
  // the tile as the MN-major operand (the rows are k, 16 a step; N = D is
  // one swizzle-wide column block, so LBO is not read), k16 step kk
  __device__ static uint64_t mnmajor(uint32_t tile, int kk) {
    if constexpr (D == 32) return sw64_mnmajor(tile, kk);
    else return make_desc(tile + kk * 16 * kRowBytes, kTileBytes, 1024, kSw128);
  }
};

// The descriptor of the same layout `bytes` further on (a multiple of 16):
// one add to the start-address field, which cannot carry out of its 14 bits
// within shared memory.
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keep the compiler from moving reads of an accumulator above the wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}
// The same for register A fragments (packed bf16 pairs) of M k16 steps.
template <int M>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}
template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// Columns 16*kk .. 16*kk+15 of a [64 x N] f32 accumulator, rounded to bf16,
// as the register A operand of the k16 step kk of the next product.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&d)[N], int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// d[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B in shared memory, both
// K-major; with accumulate = 0 the product overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B in shared memory, both
// K-major; with accumulate = 0 the product overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 32] (+)= A[64 x 16] * B[16 x 32], A and B in shared memory, both
// K-major; with accumulate = 0 the product overwrites d.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 16] (+)= A[64 x 16] * B[16 x 16], A and B in shared memory, both
// K-major; with accumulate = 0 the product overwrites d.
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 32] (+)= A[64 x 32] * B[32 x 32], int8 in, int32 accumulate (exact:
// no rounding, no saturation below 2^31); A and B in shared memory, both
// K-major, which is the only layout wgmma takes for 8-bit operands. A k32
// step is 32 bytes of each row, as a bf16 k16 step is, so the descriptors
// advance as theirs do. With accumulate = 0 the product overwrites d.
__device__ __forceinline__ void wgmma_ss_n32_s8(int (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                                int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 32] (+)= A[64 x 16] * B[16 x 32], A in shared memory K-major, B in
// shared memory MN-major (a tile stored [k][n], read through the transpose
// bit); with accumulate = 0 the product overwrites d.
__device__ __forceinline__ void wgmma_ss_n32_tb(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                                int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] * B[16 x 64], both in shared memory MN-major:
// A a tile stored [k][m], B a tile stored [k][n], each read through its
// transpose bit (A^T B of two tiles that share their rows).
__device__ __forceinline__ void wgmma_ss_n64_tt(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d[64 x 64] (+)= A[64 x 16] * B[16 x 64], A in shared memory K-major, B in
// shared memory MN-major (a tile stored [k][n], read through the transpose
// bit); with accumulate = 0 the product overwrites d.
__device__ __forceinline__ void wgmma_ss_n64_tb(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 16] * B[16 x 128], A in shared memory K-major, B
// in shared memory MN-major (a tile stored [k][n], read through the
// transpose bit); with accumulate = 0 the product overwrites d.
__device__ __forceinline__ void wgmma_ss_n128_tb(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                 int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 256] (+)= A[64 x 16] * B[16 x 256], A in shared memory K-major, B
// in shared memory MN-major (four 64-column blocks of a tile stored [k][n],
// read through the transpose bit); with accumulate = 0 the product
// overwrites d.
__device__ __forceinline__ void wgmma_ss_n256_tb(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                                 int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 32] += A[64 x 16] * B[16 x 32], A in registers (the m16n8k16
// A-fragment layout, 16 rows per warp), B in shared memory MN-major (a
// tile stored [k][n], read through the transpose bit).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64 x 64] += A[64 x 16] * B[16 x 64], A in registers (the m16n8k16
// A-fragment layout, 16 rows per warp), B in shared memory MN-major (a
// tile stored [k][n], read through the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64 x D] += A[64 x 16] * B[16 x D] with N = D, a head's width (32 or
// 64): A in registers, B a HeadTile<D> read MN-major.
template <int D>
__device__ __forceinline__ void wgmma_rs_head(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t desc_b) {
  if constexpr (D == 32) wgmma_rs_n32(d, a, desc_b);
  else wgmma_rs_n64(d, a, desc_b);
}

// d[64 x 128] += A[64 x 16] * B[16 x 128], A in registers (the m16n8k16
// A-fragment layout, 16 rows per warp), B in shared memory MN-major (a
// tile stored [k][n], read through the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64 x 80] += A[64 x 16] * B[16 x 80], A in registers (the m16n8k16
// A-fragment layout), B in shared memory MN-major: a head's 80 columns of
// 64-column SW128 blocks (LBO apart), the last block read in part.
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64 x 96] += A[64 x 16] * B[16 x 96], A in registers (the m16n8k16
// A-fragment layout), B in shared memory MN-major: a head's 96 columns of
// 64-column SW128 blocks (LBO apart), the last block read in part.
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64 x 104] += A[64 x 16] * B[16 x 104], A in registers (the m16n8k16
// A-fragment layout), B in shared memory MN-major: a head's 104 columns of
// 64-column SW128 blocks (LBO apart), the last block read in part.
__device__ __forceinline__ void wgmma_rs_n104(float (&d)[52], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51}, {%52, %53, %54, %55}, %56, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64 x N] += A[64 x 16] * B[16 x N] with N = 80, 96, 104 or 128 (a K9
// head's columns): A in registers, B MN-major in 64-column SW128 blocks.
template <int N>
__device__ __forceinline__ void wgmma_rs_cols(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc_b) {
  static_assert(N == 80 || N == 96 || N == 104 || N == 128, "a K9 product width");
  if constexpr (N == 80) wgmma_rs_n80(d, a, desc_b);
  else if constexpr (N == 96) wgmma_rs_n96(d, a, desc_b);
  else if constexpr (N == 104) wgmma_rs_n104(d, a, desc_b);
  else wgmma_rs_n128(d, a, desc_b);
}

}  // namespace hopper

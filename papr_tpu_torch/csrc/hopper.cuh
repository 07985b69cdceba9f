// Hopper (sm_90a) building blocks of the wgmma kernels (wgrad.cu,
// attend_eval.cu): mbarriers, TMA / bulk copies into shared memory, shared
// memory matrix descriptors and the wgmma fences. Inline PTX throughout;
// see wgmma.cuh for the MMAs.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace papr {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier --

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Barrier inits visible to the async proxy (TMA) and the other threads; the
// caller follows it with __syncthreads().
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Spin until the barrier's phase with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// ------------------------------------------------------------- TMA copies --

// One contiguous block of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One box of a 2-D tensor map at (c0 inner, c1 outer), completing on `bar`;
// elements outside the tensor land as zeros and count toward the bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Generic-proxy writes to shared memory visible to the async proxy (wgmma
// operands written by threads).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------ descriptors --
//
// A wgmma shared-memory matrix descriptor for the 128-byte swizzle: 1024-byte
// atoms of eight 128-byte rows, the 16-byte chunks of row r XOR-ed with
// r % 8 (what TMA's CU_TENSOR_MAP_SWIZZLE_128B writes). lbo / sbo in bytes:
// K-major, sbo = the stride of 8-row groups, lbo unused; MN-major, lbo =
// the stride of 64-element MN blocks, sbo = the stride of 8-row K groups.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// ------------------------------------------------------------ wgmma sync --

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of a register that an
// in-flight wgmma owns across the fences above.
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}
template <class T, int N>
__device__ __forceinline__ void reg_fence(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) reg_fence(r[i]);
}

// Named barrier over `count` threads (a multiple of 32).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

}  // namespace papr

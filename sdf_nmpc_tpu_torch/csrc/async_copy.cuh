// Asynchronous copies from device memory to shared memory (cp.async, sm_80 and
// later): a block's loads all in flight at once, where a loop of plain loads
// waits for one round trip per iteration.  Kernels 7 and 8 (qp_solve.cu) load
// their matrices this way; kernel 3 (condense.cu) prefetches its next stage,
// and kernel 2's f32 route (sdf_fused.cu) fills a ring of chunks with groups
// (commit / wait).  Below them the sm_90 bulk copies (the TMA engine: one
// thread moves a contiguous block) with their mbarriers, which kernel 2's
// bf16 routes (sdf_fused_bf16.cu) stage their weights and inputs with.
#pragma once

#include <cstdint>

namespace acp {

// 4 bytes, cached in L1.
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// 16 bytes, both addresses 16-byte aligned; bypasses L1.
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// 4 bytes, or a zero where !valid (src is then not read).
__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

// Close the group of the copies this thread issued since the last commit.
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Until every copy this thread issued has landed.
__device__ __forceinline__ void wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier (8 bytes of shared memory) expecting count arrivals per phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

// Make the initialized mbarriers visible to the bulk copies (before the
// block's first barrier).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival, and bytes more to come from bulk copies in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from src to dst by
// the TMA engine, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace acp

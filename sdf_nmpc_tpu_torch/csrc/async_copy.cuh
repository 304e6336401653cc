// Asynchronous copies from device memory to shared memory (cp.async, sm_80 and
// later): a block's loads all in flight at once, where a loop of plain loads
// waits for one round trip per iteration.  Kernels 7 and 8 (qp_solve.cu) load
// their matrices this way.
#pragma once

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

// Until every copy this thread issued has landed.
__device__ __forceinline__ void wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

}  // namespace acp

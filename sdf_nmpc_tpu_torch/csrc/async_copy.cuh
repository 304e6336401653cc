// Asynchronous copies from device memory to shared memory (cp.async, sm_80 and
// later): a block's loads all in flight at once, where a loop of plain loads
// waits for one round trip per iteration.  Kernels 7 and 8 (qp_solve.cu) load
// their matrices this way; kernel 3 (condense.cu) prefetches its next stage,
// and kernel 2's f32 route (sdf_fused.cu) fills a ring of chunks with groups
// (commit / wait).
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

}  // namespace acp

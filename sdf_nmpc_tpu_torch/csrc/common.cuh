// Shared helpers for the port's kernels: the export macro, block-wide
// reductions and the argmax order.  Every kernel is compiled for sm_90a without
// --use_fast_math, so sinf/cosf/sqrtf and divisions keep their IEEE paths.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#define SDF_NMPC_EXPORT extern "C" __attribute__((visibility("default")))

// Block-wide reductions for blockDim.x == NT threads (NT a multiple of 32);
// every thread of the block must call them, in the same order, and gets the
// result.  One barrier each: the partials go to one half of `red` (2 * 8 *
// NT / 32 words), the halves alternating call by call (`slot`), so the
// barrier of the next call orders this call's reads before any rewrite.
// block_sum reduces N <= 8 values at once.
template <int NT, int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red, int& slot) {
  constexpr int NW = NT / 32;
#pragma unroll
  for (int k = 0; k < N; ++k)
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  float* buf = red + slot * (NW * 8);
  slot ^= 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) buf[warp * N + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += buf[w * N + k];
    v[k] = s;
  }
}

template <int NT>
__device__ __forceinline__ float block_min(float v, float* red, int& slot) {
  constexpr int NW = NT / 32;
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  float* buf = red + slot * (NW * 8);
  slot ^= 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) buf[warp] = v;
  __syncthreads();
  float s = buf[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) s = fminf(s, buf[w]);
  return s;
}

// n floats from shared src to dst by the block's NT consecutive threads,
// float4 where dst is 16-byte aligned (src always is): the staged outputs of
// kernels 1 and 9 (lin_y_sens.cu, erk4_sens.cu).
template <int NT>
__device__ __forceinline__ void store_chunk(float* __restrict__ dst, const float* src, int n) {
  const int t = threadIdx.x;
  int i0 = 0;
  if ((reinterpret_cast<size_t>(dst) & 15) == 0) {
    for (int i = t; i < n / 4; i += NT)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
    i0 = n / 4 * 4;
  }
  for (int i = i0 + t; i < n; i += NT) dst[i] = src[i];
}

// (value, index) order of argmax: larger value wins, NaN beats any number,
// and ties go to the LOWER index (jnp.argmax / lax.top_k ordering).
__device__ __forceinline__ bool argmax_better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn != bn) return vn;
  if (!vn && v != bv) return v > bv;
  return i < bi;
}

// Shared helpers for the port's kernels: launch-error reporting and
// block-wide reductions.  Every kernel is compiled for sm_90a without
// --use_fast_math, so sinf/cosf/sqrtf and divisions keep their IEEE paths.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#define SDF_NMPC_EXPORT extern "C" __attribute__((visibility("default")))

// Block-wide reductions for blockDim.x == NT threads (NT a multiple of 32).
// Every thread of the block must call them; every thread gets the result.
// `red` is shared scratch of at least 2 * (NT / 32) words.
template <int NT>
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // protect `red` from a previous reduction's readers
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) s += red[w];
  return s;
}

template <int NT>
__device__ __forceinline__ float2 block_sum2(float2 v, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) { red[2 * warp] = v.x; red[2 * warp + 1] = v.y; }
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) { s.x += red[2 * w]; s.y += red[2 * w + 1]; }
  return s;
}

template <int NT>
__device__ __forceinline__ float block_min(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) s = fminf(s, red[w]);
  return s;
}

// Logical AND of `v` over the block.
template <int NT>
__device__ __forceinline__ bool block_all(bool v, float* red) {
  return block_min<NT>(v ? 1.f : 0.f, red) > 0.5f;
}

// (value, index) order of argmax: larger value wins, NaN beats any number,
// and ties go to the LOWER index (jnp.argmax / lax.top_k ordering).
__device__ __forceinline__ bool argmax_better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn != bn) return vn;
  if (!vn && v != bv) return v > bv;
  return i < bi;
}

// Block-wide argmax; returns the winning index to every thread.
// `red` needs 2 * (NT / 32) words.
template <int NT>
__device__ __forceinline__ int block_argmax(float v, int i, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (argmax_better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* redi = reinterpret_cast<int*>(red + NT / 32);
  __syncthreads();
  if (lane == 0) { red[warp] = v; redi[warp] = i; }
  __syncthreads();
  float bv = red[0];
  int bi = redi[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w)
    if (argmax_better(red[w], redi[w], bv, bi)) { bv = red[w]; bi = redi[w]; }
  return bi;
}

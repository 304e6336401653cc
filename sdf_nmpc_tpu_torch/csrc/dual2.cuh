// Two forward-mode tangents at once (kernels 1 and 9, lin_y_sens.cu and
// erk4_sens.cu): each tangent component follows dual.cuh's scalar Dual rule
// with the same operations in the same order, and the value component is the
// float expression, so one Dual2 sweep computes what two scalar sweeps do.
#pragma once

#include "dual.cuh"

struct Dual2 {
  float v, d0, d1;
};
__device__ __forceinline__ Dual2 operator+(Dual2 a, Dual2 b) {
  return {a.v + b.v, a.d0 + b.d0, a.d1 + b.d1};
}
__device__ __forceinline__ Dual2 operator-(Dual2 a, Dual2 b) {
  return {a.v - b.v, a.d0 - b.d0, a.d1 - b.d1};
}
__device__ __forceinline__ Dual2 operator-(Dual2 a) { return {-a.v, -a.d0, -a.d1}; }
__device__ __forceinline__ Dual2 operator*(Dual2 a, Dual2 b) {
  return {a.v * b.v, a.d0 * b.v + a.v * b.d0, a.d1 * b.v + a.v * b.d1};
}
__device__ __forceinline__ Dual2 operator*(float s, Dual2 a) {
  return {s * a.v, s * a.d0, s * a.d1};
}
__device__ __forceinline__ Dual2 operator*(Dual2 a, float s) {
  return {a.v * s, a.d0 * s, a.d1 * s};
}
__device__ __forceinline__ Dual2 operator+(Dual2 a, float s) { return {a.v + s, a.d0, a.d1}; }
__device__ __forceinline__ Dual2 operator+(float s, Dual2 a) { return {s + a.v, a.d0, a.d1}; }
__device__ __forceinline__ Dual2 operator-(Dual2 a, float s) { return {a.v - s, a.d0, a.d1}; }
__device__ __forceinline__ Dual2 operator-(float s, Dual2 a) { return {s - a.v, -a.d0, -a.d1}; }
__device__ __forceinline__ Dual2 operator/(Dual2 a, float s) {
  return {a.v / s, a.d0 / s, a.d1 / s};
}
__device__ __forceinline__ Dual2 operator/(Dual2 a, Dual2 b) {
  const float q = a.v / b.v;
  return {q, (a.d0 - q * b.d0) / b.v, (a.d1 - q * b.d1) / b.v};
}
__device__ __forceinline__ Dual2 sin_(Dual2 x) {
  const float c = cosf(x.v);
  return {sinf(x.v), c * x.d0, c * x.d1};
}
__device__ __forceinline__ Dual2 cos_(Dual2 x) {
  const float s = -sinf(x.v);
  return {cosf(x.v), s * x.d0, s * x.d1};
}
__device__ __forceinline__ Dual2 rsqrt_(Dual2 x) {
  const float r = 1.f / sqrtf(fmaxf(x.v, 1e-30f));
  const bool in = x.v > 1e-30f;
  const float k = -0.5f * (r / x.v);
  return {r, in ? x.d0 * k : 0.f, in ? x.d1 * k : 0.f};
}
__device__ __forceinline__ Dual2 atan2_(Dual2 y, Dual2 x) {
  const float den = x.v * x.v + y.v * y.v;
  return {atan2f(y.v, x.v), (x.v * y.d0 - y.v * x.d0) / den, (x.v * y.d1 - y.v * x.d1) / den};
}
__device__ __forceinline__ Dual2 asin_clip_(Dual2 t) {
  const float c = fminf(fmaxf(t.v, -1.f), 1.f);
  const bool in = t.v >= -1.f && t.v <= 1.f;
  const float s = sqrtf(1.f - c * c);
  return {asinf(c), in ? t.d0 / s : 0.f, in ? t.d1 / s : 0.f};
}
template <> __device__ __forceinline__ Dual2 lift<Dual2>(float v) { return {v, 0.f, 0.f}; }

// Forward-mode dual numbers, the model constant block and the RK4 step shared
// by the linearization kernels (lin_y_sens.cu, kernel 1; erk4_sens.cu,
// kernel 9).
//
// A Dual carries one value and one tangent.  Every rule is the exact
// derivative of its IEEE f32 primal (the sources build without fast math):
// the kernels propagate one unit tangent per sweep, so a model's device
// function written once as a template over T = float / Dual gives both the
// primal and the Jacobian columns.  The model functions take the input
// scales and the other constants from ModelConsts, passed to each kernel by
// value (no device buffer); models/base.py::kernel_consts builds the same
// block on the host.
#pragma once

#include "common.cuh"

constexpr float GRAVITY = 9.81f;

struct Dual {
  float v, d;
};
__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
__device__ __forceinline__ Dual operator*(float s, Dual a) { return {s * a.v, s * a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, float s) { return {a.v * s, a.d * s}; }
__device__ __forceinline__ Dual operator+(Dual a, float s) { return {a.v + s, a.d}; }
__device__ __forceinline__ Dual operator+(float s, Dual a) { return {s + a.v, a.d}; }
__device__ __forceinline__ Dual operator-(Dual a, float s) { return {a.v - s, a.d}; }
__device__ __forceinline__ Dual operator-(float s, Dual a) { return {s - a.v, -a.d}; }
__device__ __forceinline__ Dual operator/(Dual a, float s) { return {a.v / s, a.d / s}; }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}

__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ Dual sin_(Dual x) { return {sinf(x.v), cosf(x.v) * x.d}; }
__device__ __forceinline__ Dual cos_(Dual x) { return {cosf(x.v), -sinf(x.v) * x.d}; }
// rsqrt(max(x, 1e-30)), with the tangent rule -0.5 * rsqrt(x) / x
__device__ __forceinline__ float rsqrt_(float x) { return 1.f / sqrtf(fmaxf(x, 1e-30f)); }
__device__ __forceinline__ Dual rsqrt_(Dual x) {
  const float r = 1.f / sqrtf(fmaxf(x.v, 1e-30f));
  return {r, x.v > 1e-30f ? x.d * (-0.5f * (r / x.v)) : 0.f};
}
// atan2(y, x), d = (x dy - y dx) / (x^2 + y^2)
__device__ __forceinline__ float atan2_(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ Dual atan2_(Dual y, Dual x) {
  return {atan2f(y.v, x.v), (x.v * y.d - y.v * x.d) / (x.v * x.v + y.v * y.v)};
}
// asin(clip(t, -1, 1)): the clip passes the tangent on [-1, 1] (torch.clamp's
// rule), then d asin = dt / sqrt(1 - t^2)
__device__ __forceinline__ float asin_clip_(float t) { return asinf(fminf(fmaxf(t, -1.f), 1.f)); }
__device__ __forceinline__ Dual asin_clip_(Dual t) {
  const float c = fminf(fmaxf(t.v, -1.f), 1.f);
  const float d = (t.v >= -1.f && t.v <= 1.f) ? t.d / sqrtf(1.f - c * c) : 0.f;
  return {asinf(c), d};
}
template <typename T> __device__ __forceinline__ T lift(float v);
template <> __device__ __forceinline__ float lift<float>(float v) { return v; }
template <> __device__ __forceinline__ Dual lift<Dual>(float v) { return {v, 0.f}; }

// models/base.py::kernel_consts: the four input scales, the mass, the
// allocation matrices Gf, Gt (3 x 4, row-major), diag J and diag J^-1.
struct ModelConsts {
  float scale[4];
  float mass;
  float Gf[12], Gt[12];
  float J[3], Jinv[3];
};
constexpr int N_MODEL_CONSTS = 35;
static_assert(sizeof(ModelConsts) == N_MODEL_CONSTS * sizeof(float), "ModelConsts layout");

// solver/integrator.py erk4: x+ = x + dt/6 (k1 + 2 k2 + 2 k3 + k4), the sum
// kept in that order as it accumulates, with Model::f the model's f_lanes.
template <class Model, typename T>
__device__ __forceinline__ void erk4(const T* x, const T* u, float dt, const ModelConsts& c,
                                     T* xn) {
  constexpr int NX = Model::NX;
  T k[NX], xs[NX], acc[NX];
  const float h = 0.5f * dt;
  Model::f(x, u, c, k);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    acc[i] = k[i];
    xs[i] = x[i] + h * k[i];
  }
  Model::f(xs, u, c, k);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    acc[i] = acc[i] + 2.f * k[i];
    xs[i] = x[i] + h * k[i];
  }
  Model::f(xs, u, c, k);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    acc[i] = acc[i] + 2.f * k[i];
    xs[i] = x[i] + dt * k[i];
  }
  Model::f(xs, u, c, k);
  const float w = dt / 6.0f;
#pragma unroll
  for (int i = 0; i < NX; ++i) xn[i] = x[i] + w * (acc[i] + k[i]);
}

// Copy the host's constant block into the struct passed to a kernel; false
// if the caller's count disagrees with the layout.
inline bool load_consts(const float* host, int n, ModelConsts* c) {
  if (n != N_MODEL_CONSTS || host == nullptr) return false;
  float* dst = reinterpret_cast<float*>(c);
  for (int i = 0; i < N_MODEL_CONSTS; ++i) dst[i] = host[i];
  return true;
}

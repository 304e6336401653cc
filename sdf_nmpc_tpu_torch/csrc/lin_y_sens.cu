// RK4 step + exact discrete sensitivities + stage residual and its Jacobians
// for the `att` quad, one thread per (scenario, shooting node) point.
//
// Replaces: sdf_nmpc_tpu/ops/lin_kernels.py _erk4_y_sens_kernel (:173).  For
// each point: x+ = RK4(f, x, u, dt), A = dx+/dx, B = dx+/du, res = y - yref,
// Jyx = dy/dx, Jyu = dy/du.  f and y are the component forms f_lanes / y_lanes
// of models/quad_att.py (the algebraic cos/sin-of-atan2 form), and the
// tangents are the nx + nu = 14 unit sweeps of the TPU kernel, each carried
// as a forward-mode dual number through RK4 and y in registers.
//
// Bound on this card: bytes.  Per point the kernel reads 30 floats and writes
// 10 + 100 + 40 + 11 + 110 + 44 = 315 (226 MB at B=8192, N=20) against
// ~15,000 flops of register arithmetic.  The design
// keeps every intermediate in registers (one thread per point, the 14 sweeps
// in a loop, never spilled to memory); outputs are written batch-first
// (point-major), which leaves the stores strided across a warp: staging them
// through shared memory for coalescing is a later lever.

#include "common.cuh"

namespace {

constexpr int NX = 10, NU = 4, NY = 11;
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
__device__ __forceinline__ Dual operator-(Dual a, float s) { return {a.v - s, a.d}; }

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
template <typename T> __device__ __forceinline__ T lift(float v);
template <> __device__ __forceinline__ float lift<float>(float v) { return v; }
template <> __device__ __forceinline__ Dual lift<Dual>(float v) { return {v, 0.f}; }

struct Limits {
  float gamma, roll, pitch, wz;
};

// models/quad_att.py f_lanes
template <typename T>
__device__ __forceinline__ void f_att(const T* x, const T* u, const Limits& lim, T* out) {
  const T sq = x[3] * x[3] + x[4] * x[4] + x[5] * x[5] + x[6] * x[6];
  const T inv = rsqrt_(sq);
  const T q0 = x[3] * inv, q1 = x[4] * inv, q2 = x[5] * inv, q3 = x[6] * inv;
  const T gamma = u[0] * lim.gamma, roll = u[1] * lim.roll, pitch = u[2] * lim.pitch;
  const T wz = u[3] * lim.wz;
  const T rinv = rsqrt_(q0 * q0 + q3 * q3);
  const T c = q0 * rinv, s = q3 * rinv;
  const T r00 = c * c - s * s;
  const T r10 = 2.f * c * s;
  const T cr = cos_(roll), sr = sin_(roll), cp = cos_(pitch), sp = sin_(pitch);
  const T b0 = gamma * (cr * sp);
  const T b1 = gamma * (-sr);
  const T b2 = gamma * (cr * cp);
  const T h = 0.5f * wz;
  out[0] = x[7];
  out[1] = x[8];
  out[2] = x[9];
  out[3] = -h * q3;
  out[4] = h * q2;
  out[5] = -h * q1;
  out[6] = h * q0;
  out[7] = r00 * b0 - r10 * b1;
  out[8] = r10 * b0 + r00 * b1;
  out[9] = (c * c + s * s) * b2 - GRAVITY;
}

// models/quad_att.py y_lanes
template <typename T>
__device__ __forceinline__ void y_att(const T* x, const T* u, const float* qd, const Limits& lim,
                                      T* out) {
  const T sq = x[3] * x[3] + x[4] * x[4] + x[5] * x[5] + x[6] * x[6];
  const T inv = rsqrt_(sq);
  const T q0 = x[3] * inv, q1 = x[4] * inv, q2 = x[5] * inv, q3 = x[6] * inv;
  const T s = rsqrt_(q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3);
  const T qi0 = q0 * s, qi1 = -q1 * s, qi2 = -q2 * s, qi3 = -q3 * s;
  const T qe3 = qd[0] * qi3 + qd[1] * qi2 - qd[2] * qi1 + qd[3] * qi0;
  const T gamma = u[0] * lim.gamma, roll = u[1] * lim.roll, pitch = u[2] * lim.pitch;
  const T wz = u[3] * lim.wz;
  const T rinv = rsqrt_(q0 * q0 + q3 * q3);
  const T c = q0 * rinv, sy = q3 * rinv;
  const T a2 = (c * c + sy * sy) * (gamma * cos_(roll) * cos_(pitch)) - GRAVITY;
  out[0] = x[0];
  out[1] = x[1];
  out[2] = x[2];
  out[3] = qe3;
  out[4] = x[7];
  out[5] = x[8];
  out[6] = x[9];
  out[7] = roll;
  out[8] = pitch;
  out[9] = wz;
  out[10] = a2;
}

// solver/integrator.py erk4
template <typename T>
__device__ __forceinline__ void erk4(const T* x, const T* u, float dt, const Limits& lim,
                                     T* xn) {
  T k1[NX], k2[NX], k3[NX], k4[NX], xs[NX];
  const float h = 0.5f * dt;
  f_att(x, u, lim, k1);
#pragma unroll
  for (int i = 0; i < NX; ++i) xs[i] = x[i] + h * k1[i];
  f_att(xs, u, lim, k2);
#pragma unroll
  for (int i = 0; i < NX; ++i) xs[i] = x[i] + h * k2[i];
  f_att(xs, u, lim, k3);
#pragma unroll
  for (int i = 0; i < NX; ++i) xs[i] = x[i] + dt * k3[i];
  f_att(xs, u, lim, k4);
  const float w = dt / 6.0f;
#pragma unroll
  for (int i = 0; i < NX; ++i) xn[i] = x[i] + w * (k1[i] + 2.f * k2[i] + 2.f * k3[i] + k4[i]);
}

__global__ void lin_y_sens_kernel(const float* __restrict__ X, const float* __restrict__ U,
                                  const float* __restrict__ dtv, const float* __restrict__ QD,
                                  const float* __restrict__ YREF, float* __restrict__ XN,
                                  float* __restrict__ A, float* __restrict__ Bm,
                                  float* __restrict__ RES, float* __restrict__ JYX,
                                  float* __restrict__ JYU, int M, Limits lim) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= M) return;
  float x[NX], u[NU], qd[4];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = X[size_t(p) * NX + i];
#pragma unroll
  for (int i = 0; i < NU; ++i) u[i] = U[size_t(p) * NU + i];
#pragma unroll
  for (int i = 0; i < 4; ++i) qd[i] = QD[size_t(p) * 4 + i];
  const float dt = dtv[p];

  {
    float xn[NX], yv[NY];
    erk4(x, u, dt, lim, xn);
    y_att(x, u, qd, lim, yv);
#pragma unroll
    for (int i = 0; i < NX; ++i) XN[size_t(p) * NX + i] = xn[i];
#pragma unroll
    for (int i = 0; i < NY; ++i) RES[size_t(p) * NY + i] = yv[i] - YREF[size_t(p) * NY + i];
  }

#pragma unroll 1
  for (int dir = 0; dir < NX + NU; ++dir) {
    Dual xd[NX], ud[NU], xn[NX], yd[NY];
#pragma unroll
    for (int i = 0; i < NX; ++i) xd[i] = {x[i], dir == i ? 1.f : 0.f};
#pragma unroll
    for (int i = 0; i < NU; ++i) ud[i] = {u[i], dir == NX + i ? 1.f : 0.f};
    erk4(xd, ud, dt, lim, xn);
    y_att(xd, ud, qd, lim, yd);
    if (dir < NX) {
#pragma unroll
      for (int i = 0; i < NX; ++i) A[(size_t(p) * NX + i) * NX + dir] = xn[i].d;
#pragma unroll
      for (int i = 0; i < NY; ++i) JYX[(size_t(p) * NY + i) * NX + dir] = yd[i].d;
    } else {
      const int j = dir - NX;
#pragma unroll
      for (int i = 0; i < NX; ++i) Bm[(size_t(p) * NX + i) * NU + j] = xn[i].d;
#pragma unroll
      for (int i = 0; i < NY; ++i) JYU[(size_t(p) * NY + i) * NU + j] = yd[i].d;
    }
  }
}

}  // namespace

SDF_NMPC_EXPORT int lin_y_sens_launch(const float* X, const float* U, const float* dt,
                                      const float* qd, const float* yref, float* xn, float* A,
                                      float* Bm, float* res, float* Jyx, float* Jyu, int M,
                                      float lim_gamma, float lim_roll, float lim_pitch,
                                      float lim_wz, cudaStream_t stream) {
  if (M <= 0) return int(cudaErrorInvalidValue);
  const Limits lim{lim_gamma, lim_roll, lim_pitch, lim_wz};
  const int threads = 128;
  lin_y_sens_kernel<<<(M + threads - 1) / threads, threads, 0, stream>>>(
      X, U, dt, qd, yref, xn, A, Bm, res, Jyx, Jyu, M, lim);
  return int(cudaGetLastError());
}

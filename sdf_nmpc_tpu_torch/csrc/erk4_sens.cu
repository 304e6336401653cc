// RK4 step + exact discrete sensitivities for the models without a
// component-form residual (rates, wrench, props), one thread per (scenario,
// shooting node) point.
//
// Replaces: sdf_nmpc_tpu/ops/lin_kernels.py _erk4_sens_kernel (:49).  For
// each point: x+ = RK4(f, x, u, dt), A = dx+/dx (nx x nx), B = dx+/du
// (nx x 4), in f32: kernel 1's first three outputs without the residual
// rows.  f is the model's component form f_lanes (models/quad_rates.py,
// quad_wrench.py, quad_props.py), one struct each; the kernel is a template
// over it.  The nx + 4 unit tangents (14 for rates, 17 for wrench and props)
// are swept one after another, each carried as a forward-mode dual number
// (dual.cuh) through the four stages of RK4 in registers.  The constants
// (input scales; props' mass, allocation and inertia) come by value in
// ModelConsts.
//
// Bound on this card: per point the kernel reads nx + 5 floats and writes
// nx (1 + nx + 4) (rates 15 and 150, wrench and props 18 and 234: 108 and
// 165 MB at B=8192, N=20), against the register arithmetic of one primal RK4
// and nx + 4 tangent sweeps through it (chip_smoke.py counts both; the
// operations come out near or above the bytes).  Like kernel 1 it keeps
// every intermediate in registers and writes each point's outputs from its
// own thread, so the column stores of A and B are strided across a warp.
// The levers for a later PR: stage the outputs through shared memory for
// coalesced stores, and carry several tangents per pass so that the primal
// values are computed once for them.

#include "dual.cuh"

namespace {

constexpr int NU = 4;

// lanes_quat: normalized q and the rotation entries R[i][j]
template <typename T>
__device__ __forceinline__ void quat_rot(const T* qraw, T* q, T (*R)[3]) {
  const T inv = rsqrt_(qraw[0] * qraw[0] + qraw[1] * qraw[1] + qraw[2] * qraw[2] +
                       qraw[3] * qraw[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = qraw[i] * inv;
  R[0][0] = q[0] * q[0] + q[1] * q[1] - q[2] * q[2] - q[3] * q[3];
  R[0][1] = 2.f * (q[1] * q[2] - q[0] * q[3]);
  R[0][2] = 2.f * (q[1] * q[3] + q[0] * q[2]);
  R[1][0] = 2.f * (q[1] * q[2] + q[0] * q[3]);
  R[1][1] = q[0] * q[0] - q[1] * q[1] + q[2] * q[2] - q[3] * q[3];
  R[1][2] = 2.f * (q[2] * q[3] - q[0] * q[1]);
  R[2][0] = 2.f * (q[1] * q[3] - q[0] * q[2]);
  R[2][1] = 2.f * (q[2] * q[3] + q[0] * q[1]);
  R[2][2] = q[0] * q[0] - q[1] * q[1] - q[2] * q[2] + q[3] * q[3];
}

// lanes_mv3: out = R v
template <typename T>
__device__ __forceinline__ void mv3(T (*R)[3], const T* v, T* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = R[i][0] * v[0] + R[i][1] * v[1] + R[i][2] * v[2];
}

// lanes_quat_deriv: hamilton(q, (0, w)) / 2
template <typename T>
__device__ __forceinline__ void quat_deriv(const T* q, const T* w, T* out) {
  out[0] = 0.5f * (-q[1] * w[0] - q[2] * w[1] - q[3] * w[2]);
  out[1] = 0.5f * (q[0] * w[0] + q[2] * w[2] - q[3] * w[1]);
  out[2] = 0.5f * (q[0] * w[1] - q[1] * w[2] + q[3] * w[0]);
  out[3] = 0.5f * (q[0] * w[2] + q[1] * w[1] - q[2] * w[0]);
}

// models/quad_rates.py f_lanes: dp = R v, dq, dv = R^T (-g e3) + gamma e3
struct Rates {
  static constexpr int NX = 10;

  template <typename T>
  static __device__ __forceinline__ void f(const T* x, const T* u, const ModelConsts& c, T* out) {
    T q[4], R[3][3];
    quat_rot(x + 3, q, R);
    const T w[3] = {u[1] * c.scale[1], u[2] * c.scale[2], u[3] * c.scale[3]};
    mv3(R, x + 7, out);
    quat_deriv(q, w, out + 3);
    out[7] = -GRAVITY * R[2][0];
    out[8] = -GRAVITY * R[2][1];
    out[9] = -GRAVITY * R[2][2] + u[0] * c.scale[0];
  }
};

// models/quad_wrench.py f_lanes: rates' translation with the body rates in
// the state, dw = torques (no gyroscopic term, as the reference model)
struct Wrench {
  static constexpr int NX = 13;

  template <typename T>
  static __device__ __forceinline__ void f(const T* x, const T* u, const ModelConsts& c, T* out) {
    T q[4], R[3][3];
    quat_rot(x + 3, q, R);
    mv3(R, x + 7, out);
    quat_deriv(q, x + 10, out + 3);
    out[7] = -GRAVITY * R[2][0];
    out[8] = -GRAVITY * R[2][1];
    out[9] = -GRAVITY * R[2][2] + u[0] * c.scale[0];
    out[10] = u[1] * c.scale[1];
    out[11] = u[2] * c.scale[2];
    out[12] = u[3] * c.scale[3];
  }
};

// models/quad_props.py f_lanes: t = (u wp)^2, W_a = R Gf t / m - g e3,
// dw = J^-1 (Gt t - w x J w), with J diagonal
struct Props {
  static constexpr int NX = 13;

  template <typename T>
  static __device__ __forceinline__ void f(const T* x, const T* u, const ModelConsts& c, T* out) {
    T q[4], R[3][3], t[4], gf[3], gt[3], Wa[3];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const T s = u[j] * c.scale[j];
      t[j] = s * s;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      gf[i] = c.Gf[4 * i] * t[0] + c.Gf[4 * i + 1] * t[1] + c.Gf[4 * i + 2] * t[2] +
              c.Gf[4 * i + 3] * t[3];
      gt[i] = c.Gt[4 * i] * t[0] + c.Gt[4 * i + 1] * t[1] + c.Gt[4 * i + 2] * t[2] +
              c.Gt[4 * i + 3] * t[3];
    }
    quat_rot(x + 3, q, R);
    mv3(R, gf, Wa);
    const T* w = x + 10;
    const T Jw[3] = {c.J[0] * w[0], c.J[1] * w[1], c.J[2] * w[2]};
    const T cr[3] = {w[1] * Jw[2] - w[2] * Jw[1], w[2] * Jw[0] - w[0] * Jw[2],
                     w[0] * Jw[1] - w[1] * Jw[0]};
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] = x[7 + i];
    quat_deriv(q, w, out + 3);
    out[7] = Wa[0] / c.mass;
    out[8] = Wa[1] / c.mass;
    out[9] = Wa[2] / c.mass - GRAVITY;
#pragma unroll
    for (int i = 0; i < 3; ++i) out[10 + i] = c.Jinv[i] * (gt[i] - cr[i]);
  }
};

template <class Model>
__global__ void erk4_sens_kernel(const float* __restrict__ X, const float* __restrict__ U,
                                 const float* __restrict__ dtv, float* __restrict__ XN,
                                 float* __restrict__ A, float* __restrict__ Bm, int M,
                                 ModelConsts c) {
  constexpr int NX = Model::NX;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= M) return;
  float x[NX], u[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = X[size_t(p) * NX + i];
#pragma unroll
  for (int i = 0; i < NU; ++i) u[i] = U[size_t(p) * NU + i];
  const float dt = dtv[p];

  {
    float xn[NX];
    erk4<Model>(x, u, dt, c, xn);
#pragma unroll
    for (int i = 0; i < NX; ++i) XN[size_t(p) * NX + i] = xn[i];
  }

#pragma unroll 1
  for (int dir = 0; dir < NX + NU; ++dir) {
    Dual xd[NX], ud[NU], xn[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) xd[i] = {x[i], dir == i ? 1.f : 0.f};
#pragma unroll
    for (int i = 0; i < NU; ++i) ud[i] = {u[i], dir == NX + i ? 1.f : 0.f};
    erk4<Model>(xd, ud, dt, c, xn);
    if (dir < NX) {
#pragma unroll
      for (int i = 0; i < NX; ++i) A[(size_t(p) * NX + i) * NX + dir] = xn[i].d;
    } else {
#pragma unroll
      for (int i = 0; i < NX; ++i) Bm[(size_t(p) * NX + i) * NU + dir - NX] = xn[i].d;
    }
  }
}

template <class Model>
cudaError_t launch(const float* X, const float* U, const float* dt, float* xn, float* A,
                   float* Bm, int M, const ModelConsts& c, cudaStream_t stream) {
  const int threads = 128;
  erk4_sens_kernel<Model><<<(M + threads - 1) / threads, threads, 0, stream>>>(
      X, U, dt, xn, A, Bm, M, c);
  return cudaGetLastError();
}

}  // namespace

// model: 0 rates, 1 wrench, 2 props (ModelSpec.kernel_model); consts:
// host pointer to the n_consts floats of models/base.py::kernel_consts.
SDF_NMPC_EXPORT int erk4_sens_launch(const float* X, const float* U, const float* dt, float* xn,
                                     float* A, float* Bm, int M, int model, const float* consts,
                                     int n_consts, cudaStream_t stream) {
  ModelConsts c;
  if (M <= 0 || !load_consts(consts, n_consts, &c)) return int(cudaErrorInvalidValue);
  switch (model) {
    case 0: return int(launch<Rates>(X, U, dt, xn, A, Bm, M, c, stream));
    case 1: return int(launch<Wrench>(X, U, dt, xn, A, Bm, M, c, stream));
    case 2: return int(launch<Props>(X, U, dt, xn, A, Bm, M, c, stream));
    default: return int(cudaErrorInvalidValue);
  }
}

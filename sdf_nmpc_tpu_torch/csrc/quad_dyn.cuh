// The dynamics and stage residual of the quad families with a component-form
// residual (att, acc, att_tau), as device structs templated on the number
// type (float, Dual, Dual2): f(x, u, c, out) is the model's f_lanes and
// y(x, u, qd, c, out) its y_lanes.  Kernel 1 (lin_y_sens.cu) runs both;
// kernel 9 (erk4_sens.cu) runs f alone under sdf_cost, where the OCP's stage
// residual is wider than the model's.  Each source includes this header once
// (an anonymous namespace, as the structs had in lin_y_sens.cu).
#pragma once

#include "dual.cuh"

namespace {

// models/quad_att.py f_lanes / y_lanes
struct Att {
  static constexpr int NX = 10;

  template <typename T>
  static __device__ __forceinline__ void f(const T* x, const T* u, const ModelConsts& c, T* out) {
    const T sq = x[3] * x[3] + x[4] * x[4] + x[5] * x[5] + x[6] * x[6];
    const T inv = rsqrt_(sq);
    const T q0 = x[3] * inv, q1 = x[4] * inv, q2 = x[5] * inv, q3 = x[6] * inv;
    const T gamma = u[0] * c.scale[0], roll = u[1] * c.scale[1], pitch = u[2] * c.scale[2];
    const T wz = u[3] * c.scale[3];
    const T rinv = rsqrt_(q0 * q0 + q3 * q3);
    const T cy = q0 * rinv, sy = q3 * rinv;
    const T r00 = cy * cy - sy * sy;
    const T r10 = 2.f * cy * sy;
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
    out[9] = (cy * cy + sy * sy) * b2 - GRAVITY;
  }

  template <typename T>
  static __device__ __forceinline__ void y(const T* x, const T* u, const float* qd,
                                           const ModelConsts& c, T* out) {
    const T sq = x[3] * x[3] + x[4] * x[4] + x[5] * x[5] + x[6] * x[6];
    const T inv = rsqrt_(sq);
    const T q0 = x[3] * inv, q1 = x[4] * inv, q2 = x[5] * inv, q3 = x[6] * inv;
    const T s = rsqrt_(q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3);
    const T qi0 = q0 * s, qi1 = -q1 * s, qi2 = -q2 * s, qi3 = -q3 * s;
    const T qe3 = qd[0] * qi3 + qd[1] * qi2 - qd[2] * qi1 + qd[3] * qi0;
    const T gamma = u[0] * c.scale[0], roll = u[1] * c.scale[1], pitch = u[2] * c.scale[2];
    const T wz = u[3] * c.scale[3];
    const T rinv = rsqrt_(q0 * q0 + q3 * q3);
    const T cy = q0 * rinv, sy = q3 * rinv;
    const T a2 = (cy * cy + sy * sy) * (gamma * cos_(roll) * cos_(pitch)) - GRAVITY;
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
};

// q_e's z-component: hamilton(qd, quat_invert(q))[3] on the normalized q
template <typename T>
__device__ __forceinline__ T qe3_of(const T& q0, const T& q1, const T& q2, const T& q3,
                                    const float* qd) {
  const T s = rsqrt_(q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3);
  const T qi0 = q0 * s, qi1 = -q1 * s, qi2 = -q2 * s, qi3 = -q3 * s;
  return qd[0] * qi3 + qd[1] * qi2 - qd[2] * qi1 + qd[3] * qi0;
}

// models/quad_acc.py f_lanes / y_lanes
struct Acc {
  static constexpr int NX = 10;

  template <typename T>
  static __device__ __forceinline__ void f(const T* x, const T* u, const ModelConsts& c, T* out) {
    const T inv = rsqrt_(x[3] * x[3] + x[4] * x[4] + x[5] * x[5] + x[6] * x[6]);
    const T q0 = x[3] * inv, q1 = x[4] * inv, q2 = x[5] * inv, q3 = x[6] * inv;
    const T h = 0.5f * u[3] * c.scale[3];
    out[0] = x[7];
    out[1] = x[8];
    out[2] = x[9];
    out[3] = -h * q3;
    out[4] = h * q2;
    out[5] = -h * q1;
    out[6] = h * q0;
    out[7] = u[0] * c.scale[0];
    out[8] = u[1] * c.scale[1];
    out[9] = u[2] * c.scale[2];
  }

  template <typename T>
  static __device__ __forceinline__ void y(const T* x, const T* u, const float* qd,
                                           const ModelConsts& c, T* out) {
    const T inv = rsqrt_(x[3] * x[3] + x[4] * x[4] + x[5] * x[5] + x[6] * x[6]);
    out[0] = x[0];
    out[1] = x[1];
    out[2] = x[2];
    out[3] = qe3_of(x[3] * inv, x[4] * inv, x[5] * inv, x[6] * inv, qd);
    out[4] = x[7];
    out[5] = x[8];
    out[6] = x[9];
#pragma unroll
    for (int i = 0; i < 4; ++i) out[7 + i] = u[i] * c.scale[i];
  }
};

// models/quad_att_tau.py f_lanes / y_lanes.  Roll and pitch are the true
// atan2 and asin (of the clipped argument), with their exact derivative
// rules; the TPU kernel spells them with polynomials (math.py atan2_poly /
// asin_poly) because its compiler has no atan2.  The lag's body rate divides
// by cos(pitch), as deuler_avel_map does.
struct AttTau {
  static constexpr int NX = 10;
  static constexpr float TAU_ROLL = 0.12f, TAU_PITCH = 0.12f;

  template <typename T>
  static __device__ __forceinline__ void f(const T* x, const T* u, const ModelConsts& c, T* out) {
    const T inv = rsqrt_(x[3] * x[3] + x[4] * x[4] + x[5] * x[5] + x[6] * x[6]);
    const T q0 = x[3] * inv, q1 = x[4] * inv, q2 = x[5] * inv, q3 = x[6] * inv;
    const T gamma = u[0] * c.scale[0], roll_des = u[1] * c.scale[1];
    const T pitch_des = u[2] * c.scale[2], wz = u[3] * c.scale[3];
    const T roll = atan2_(2.f * (q0 * q1 + q2 * q3), 1.f - 2.f * (q1 * q1 + q2 * q2));
    const T pitch = asin_clip_(2.f * (q0 * q2 - q3 * q1));
    const T dot_roll = (roll_des - roll) / TAU_ROLL;
    const T dot_pitch = (pitch_des - pitch) / TAU_PITCH;
    const T sr = sin_(roll), cr = cos_(roll), sp = sin_(pitch), cp = cos_(pitch);
    const T w0 = dot_roll + (sp * sr / cp) * dot_pitch;
    const T w1 = cr * dot_pitch;
    out[0] = x[7];
    out[1] = x[8];
    out[2] = x[9];
    out[3] = 0.5f * (-q1 * w0 - q2 * w1 - q3 * wz);
    out[4] = 0.5f * (q0 * w0 + q2 * wz - q3 * w1);
    out[5] = 0.5f * (q0 * w1 - q1 * wz + q3 * w0);
    out[6] = 0.5f * (q0 * wz + q1 * w1 - q2 * w0);
    out[7] = gamma * (2.f * (q1 * q3 + q0 * q2));
    out[8] = gamma * (2.f * (q2 * q3 - q0 * q1));
    out[9] = gamma * (q0 * q0 - q1 * q1 - q2 * q2 + q3 * q3) - GRAVITY;
  }

  template <typename T>
  static __device__ __forceinline__ void y(const T* x, const T* u, const float* qd,
                                           const ModelConsts& c, T* out) {
    const T inv = rsqrt_(x[3] * x[3] + x[4] * x[4] + x[5] * x[5] + x[6] * x[6]);
    const T q0 = x[3] * inv, q1 = x[4] * inv, q2 = x[5] * inv, q3 = x[6] * inv;
    const T gamma = u[0] * c.scale[0];
    out[0] = x[0];
    out[1] = x[1];
    out[2] = x[2];
    out[3] = qe3_of(q0, q1, q2, q3, qd);
    out[4] = x[7];
    out[5] = x[8];
    out[6] = x[9];
    out[7] = u[1] * c.scale[1];
    out[8] = u[2] * c.scale[2];
    out[9] = u[3] * c.scale[3];
    out[10] = gamma * (q0 * q0 - q1 * q1 - q2 * q2 + q3 * q3) - GRAVITY;
  }
};

}  // namespace

// RK4 step + exact discrete sensitivities + stage residual and its Jacobians
// for the models with a component-form residual (att, acc, att_tau).
//
// Replaces: sdf_nmpc_tpu/ops/lin_kernels.py _erk4_y_sens_kernel (:173).  For
// each point: x+ = RK4(f, x, u, dt), A = dx+/dx, B = dx+/du, res = y - yref,
// Jyx = dy/dx, Jyu = dy/du.  f and y are the component forms f_lanes /
// y_lanes of the model's module (models/quad_att.py, quad_acc.py,
// quad_att_tau.py), one struct each; the kernel is a template over it.  The
// tangents are the nx + nu = 14 unit sweeps of the TPU kernel, each carried
// as a forward-mode dual number (dual.cuh) through RK4 and y in registers.
//
// Bound on this card: bytes.  Per point the kernel reads 30 floats and writes
// 10 + 100 + 40 + 11 + 110 + 44 = 315 (226 MB at B=8192, N=20) against some
// 10^4 flops of register arithmetic.
//
// Design: one thread per point and pair of tangent directions.  A block
// takes PB = 16 consecutive points, 7 threads each (112 threads): thread t
// runs directions 2 (t % 7) and 2 (t % 7) + 1 of point t / 7 as one Dual2
// sweep (dual2.cuh: each tangent by the scalar Dual rule, in its order), and
// the point's first thread also stores x+ and res from the sweep's values,
// which are the float instance's expressions.  The block first loads its
// points' inputs into shared memory (coalesced); every thread writes its
// columns of A / B / Jyx / Jyu into a shared slab of the block's outputs, and
// after one barrier the block stores each output's contiguous chunk with
// consecutive threads on consecutive floats, as float4 where the chunk is
// 16-byte aligned (16 points align every output).  __launch_bounds__ asks
// for 5 blocks per SM: ptxas then spills a few hundred bytes for att and
// att_tau, and the kernel runs 8-14% faster than at its 124-155 registers
// and 3-4 blocks per SM (chip_smoke.py --lin-builds on an H100 80GB HBM3 at
// 700 W; PERF.md section 6).  One tangent per thread, with a separate
// float primal, was 40-55% slower for att and att_tau.

#include "dual2.cuh"

namespace {

constexpr int NU = 4, NY = 11;

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

constexpr int NX = 10, NDIR = NX + NU;  // every model here has nx = 10
constexpr int PB = 16;                    // points per block
constexpr int NL = NDIR / 2;              // lanes per point, two directions each
constexpr int NT = PB * NL;               // one thread per sweep pair
constexpr int IN = NX + NU + 4 + 1 + NY;  // x, u, q_d, dt, yref
constexpr int OUT = NX + NX * NX + NX * NU + NY + NY * NX + NY * NU;
constexpr size_t SMEM = sizeof(float) * PB * (IN + OUT);

template <class Model>
__global__ void __launch_bounds__(NT, 5) lin_y_sens_kernel(
    const float* __restrict__ X, const float* __restrict__ U, const float* __restrict__ dtv,
    const float* __restrict__ QD, const float* __restrict__ YREF, float* __restrict__ XN,
    float* __restrict__ A, float* __restrict__ Bm, float* __restrict__ RES,
    float* __restrict__ JYX, float* __restrict__ JYU, int M, ModelConsts c) {
  static_assert(Model::NX == NX, "lin_y_sens is laid out for nx = 10");
  extern __shared__ float smem[];
  // inputs, by array: x (PB x NX), u, q_d, dt, yref
  float* sx = smem;
  float* su = sx + PB * NX;
  float* sqd = su + PB * NU;
  float* sdt = sqd + PB * 4;
  float* syref = sdt + PB;
  // outputs, by array, each the block's chunk of it
  float* sxn = syref + PB * NY;
  float* sA = sxn + PB * NX;
  float* sB = sA + PB * NX * NX;
  float* sres = sB + PB * NX * NU;
  float* sJyx = sres + PB * NY;
  float* sJyu = sJyx + PB * NY * NX;

  const int t = threadIdx.x;
  const size_t p0 = size_t(blockIdx.x) * PB;
  const int np = min(PB, int(M - p0));
  for (int i = t; i < np * NX; i += NT) sx[i] = X[p0 * NX + i];
  for (int i = t; i < np * NU; i += NT) su[i] = U[p0 * NU + i];
  for (int i = t; i < np * 4; i += NT) sqd[i] = QD[p0 * 4 + i];
  for (int i = t; i < np; i += NT) sdt[i] = dtv[p0 + i];
  for (int i = t; i < np * NY; i += NT) syref[i] = YREF[p0 * NY + i];
  __syncthreads();

  const int q = t / NL, d0 = 2 * (t - q * NL);
  if (q < np) {
    Dual2 xd[NX], ud[NU], xn[NX], yd[NY];
#pragma unroll
    for (int i = 0; i < NX; ++i)
      xd[i] = {sx[q * NX + i], d0 == i ? 1.f : 0.f, d0 + 1 == i ? 1.f : 0.f};
#pragma unroll
    for (int i = 0; i < NU; ++i)
      ud[i] = {su[q * NU + i], d0 == NX + i ? 1.f : 0.f, d0 + 1 == NX + i ? 1.f : 0.f};
    erk4<Model>(xd, ud, sdt[q], c, xn);
    Model::y(xd, ud, sqd + q * 4, c, yd);
    if (d0 == 0) {
#pragma unroll
      for (int i = 0; i < NX; ++i) sxn[q * NX + i] = xn[i].v;
#pragma unroll
      for (int i = 0; i < NY; ++i) sres[q * NY + i] = yd[i].v - syref[q * NY + i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int dir = d0 + h;
      if (dir < NX) {
#pragma unroll
        for (int i = 0; i < NX; ++i) sA[(q * NX + i) * NX + dir] = h ? xn[i].d1 : xn[i].d0;
#pragma unroll
        for (int i = 0; i < NY; ++i) sJyx[(q * NY + i) * NX + dir] = h ? yd[i].d1 : yd[i].d0;
      } else {
        const int j = dir - NX;
#pragma unroll
        for (int i = 0; i < NX; ++i) sB[(q * NX + i) * NU + j] = h ? xn[i].d1 : xn[i].d0;
#pragma unroll
        for (int i = 0; i < NY; ++i) sJyu[(q * NY + i) * NU + j] = h ? yd[i].d1 : yd[i].d0;
      }
    }
  }
  __syncthreads();

  store_chunk<NT>(XN + p0 * NX, sxn, np * NX);
  store_chunk<NT>(A + p0 * NX * NX, sA, np * NX * NX);
  store_chunk<NT>(Bm + p0 * NX * NU, sB, np * NX * NU);
  store_chunk<NT>(RES + p0 * NY, sres, np * NY);
  store_chunk<NT>(JYX + p0 * NY * NX, sJyx, np * NY * NX);
  store_chunk<NT>(JYU + p0 * NY * NU, sJyu, np * NY * NU);
}

template <class Model>
cudaError_t launch(const float* X, const float* U, const float* dt, const float* qd,
                   const float* yref, float* xn, float* A, float* Bm, float* res, float* Jyx,
                   float* Jyu, int M, const ModelConsts& c, cudaStream_t stream) {
  lin_y_sens_kernel<Model><<<(M + PB - 1) / PB, NT, SMEM, stream>>>(
      X, U, dt, qd, yref, xn, A, Bm, res, Jyx, Jyu, M, c);
  return cudaGetLastError();
}

template <class Model>
int geometry(int* threads, int* smem, int* blocks_per_sm) {
  *threads = NT;
  *smem = int(SMEM);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, lin_y_sens_kernel<Model>, NT, SMEM));
}

}  // namespace

// Launch geometry of model's instance (0 att, 1 acc, 2 att_tau): threads per
// block, dynamic shared bytes per block and resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
SDF_NMPC_EXPORT int lin_y_sens_geometry(int model, int* threads, int* smem, int* blocks_per_sm) {
  switch (model) {
    case 0: return geometry<Att>(threads, smem, blocks_per_sm);
    case 1: return geometry<Acc>(threads, smem, blocks_per_sm);
    case 2: return geometry<AttTau>(threads, smem, blocks_per_sm);
    default: return int(cudaErrorInvalidValue);
  }
}

// model: 0 att, 1 acc, 2 att_tau (ModelSpec.kernel_model); consts:
// host pointer to the n_consts floats of models/base.py::kernel_consts.
SDF_NMPC_EXPORT int lin_y_sens_launch(const float* X, const float* U, const float* dt,
                                      const float* qd, const float* yref, float* xn, float* A,
                                      float* Bm, float* res, float* Jyx, float* Jyu, int M,
                                      int model, const float* consts, int n_consts,
                                      cudaStream_t stream) {
  ModelConsts c;
  if (M <= 0 || !load_consts(consts, n_consts, &c)) return int(cudaErrorInvalidValue);
  switch (model) {
    case 0: return int(launch<Att>(X, U, dt, qd, yref, xn, A, Bm, res, Jyx, Jyu, M, c, stream));
    case 1: return int(launch<Acc>(X, U, dt, qd, yref, xn, A, Bm, res, Jyx, Jyu, M, c, stream));
    case 2:
      return int(launch<AttTau>(X, U, dt, qd, yref, xn, A, Bm, res, Jyx, Jyu, M, c, stream));
    default: return int(cudaErrorInvalidValue);
  }
}

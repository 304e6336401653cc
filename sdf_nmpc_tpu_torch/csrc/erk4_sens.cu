// RK4 step + exact discrete sensitivities for the models without a
// component-form residual (rates, wrench, props).
//
// Replaces: sdf_nmpc_tpu/ops/lin_kernels.py _erk4_sens_kernel (:49).  For
// each (scenario, shooting node) point: x+ = RK4(f, x, u, dt), A = dx+/dx
// (nx x nx), B = dx+/du (nx x 4), in f32: kernel 1's first three outputs
// without the residual rows.  f is the model's component form f_lanes
// (models/quad_rates.py, quad_wrench.py, quad_props.py), one struct each; the
// kernel is a template over it.  The constants (input scales; props' mass,
// allocation and inertia) come by value in ModelConsts.
//
// Bound on this card: bytes.  Per point the kernel reads nx + 5 floats and
// writes nx (1 + nx + 4) (rates 15 and 150, wrench and props 18 and 234: 108
// and 165 MB at B=8192, N=20) against the register arithmetic of one primal
// RK4 and nx + 4 tangent sweeps through it (chip_smoke.py counts both).
//
// Design: kernel 1's (lin_y_sens.cu).  One thread per point and pair of
// tangent directions: a block takes PB consecutive points, NL = (nx + 5) / 2
// threads each (rates 7, wrench and props 9; the ninth carries direction 16
// and a zero second tangent), and thread t runs directions 2 (t % NL) and
// 2 (t % NL) + 1 of point t / NL as one Dual2 sweep (dual2.cuh: each tangent
// by dual.cuh's scalar rule, in its order); the point's first thread also
// stores x+ from the sweep's values, the float instance's expressions.  The
// block loads its points' inputs into shared memory (coalesced), every
// thread writes its columns of A and B into a shared slab of the block's
// outputs, and after one barrier the block stores each output's contiguous
// chunk with consecutive threads on consecutive floats, as float4 where the
// chunk is 16-byte aligned.  __launch_bounds__ asks for MIN_BLOCKS blocks
// per SM.  Measured (chip_smoke.py --erk4-builds, one B=8192 steady step's
// launch, H100 80GB HBM3 at 700 W): rates 0.16, wrench 0.19, props 0.34 ms,
// against 0.46-0.50, 0.78 and 0.77 for the first design (one thread per
// point, the nx + 4 scalar sweeps one after another, each recomputing the
// primal, the columns stored strided across the warp); 32 points a block or
// 2 or 6 blocks per SM were no faster for all three (PERF.md section 6).
// Its outputs differ from the first design's by nvcc's contractions alone
// (up to 9.5e-7).

#include "dual2.cuh"

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

constexpr int PB = 16;          // points per block
constexpr int MIN_BLOCKS = 4;   // __launch_bounds__' resident blocks per SM

template <class Model>
struct Geo {
  static constexpr int NX = Model::NX;
  static constexpr int NL = (NX + NU + 1) / 2;  // threads per point, two directions each
  static constexpr int NT = PB * NL;
  static constexpr int IN = NX + NU + 1;           // x, u, dt
  static constexpr int OUT = NX + NX * NX + NX * NU;  // x+, A, B
  static constexpr size_t SMEM = sizeof(float) * PB * (IN + OUT);
};

template <class Model>
__global__ void __launch_bounds__(Geo<Model>::NT, MIN_BLOCKS) erk4_sens_kernel(
    const float* __restrict__ X, const float* __restrict__ U, const float* __restrict__ dtv,
    float* __restrict__ XN, float* __restrict__ A, float* __restrict__ Bm, int M,
    ModelConsts c) {
  using G = Geo<Model>;
  constexpr int NX = G::NX, NL = G::NL, NT = G::NT;
  extern __shared__ float smem[];
  // inputs, by array: x (PB x NX), u, dt; then the outputs, each the block's chunk of it
  float* sx = smem;
  float* su = sx + PB * NX;
  float* sdt = su + PB * NU;
  float* sxn = sdt + PB;
  float* sA = sxn + PB * NX;
  float* sB = sA + PB * NX * NX;

  const int t = threadIdx.x;
  const size_t p0 = size_t(blockIdx.x) * PB;
  const int np = min(PB, int(M - p0));
  for (int i = t; i < np * NX; i += NT) sx[i] = X[p0 * NX + i];
  for (int i = t; i < np * NU; i += NT) su[i] = U[p0 * NU + i];
  for (int i = t; i < np; i += NT) sdt[i] = dtv[p0 + i];
  __syncthreads();

  const int q = t / NL, d0 = 2 * (t - q * NL);
  if (q < np) {
    Dual2 xd[NX], ud[NU], xn[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i)
      xd[i] = {sx[q * NX + i], d0 == i ? 1.f : 0.f, d0 + 1 == i ? 1.f : 0.f};
#pragma unroll
    for (int i = 0; i < NU; ++i)
      ud[i] = {su[q * NU + i], d0 == NX + i ? 1.f : 0.f, d0 + 1 == NX + i ? 1.f : 0.f};
    erk4<Model>(xd, ud, sdt[q], c, xn);
    if (d0 == 0) {
#pragma unroll
      for (int i = 0; i < NX; ++i) sxn[q * NX + i] = xn[i].v;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int dir = d0 + h;
      if (dir < NX) {
#pragma unroll
        for (int i = 0; i < NX; ++i) sA[(q * NX + i) * NX + dir] = h ? xn[i].d1 : xn[i].d0;
      } else if (dir < NX + NU) {
#pragma unroll
        for (int i = 0; i < NX; ++i) sB[(q * NX + i) * NU + dir - NX] = h ? xn[i].d1 : xn[i].d0;
      }
    }
  }
  __syncthreads();

  store_chunk<NT>(XN + p0 * NX, sxn, np * NX);
  store_chunk<NT>(A + p0 * NX * NX, sA, np * NX * NX);
  store_chunk<NT>(Bm + p0 * NX * NU, sB, np * NX * NU);
}

template <class Model>
cudaError_t launch(const float* X, const float* U, const float* dt, float* xn, float* A,
                   float* Bm, int M, const ModelConsts& c, cudaStream_t stream) {
  using G = Geo<Model>;
  erk4_sens_kernel<Model><<<(M + PB - 1) / PB, G::NT, G::SMEM, stream>>>(X, U, dt, xn, A, Bm,
                                                                          M, c);
  return cudaGetLastError();
}

template <class Model>
int geometry(int* threads, int* smem, int* blocks_per_sm) {
  using G = Geo<Model>;
  *threads = G::NT;
  *smem = int(G::SMEM);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, erk4_sens_kernel<Model>, G::NT, G::SMEM));
}

}  // namespace

// Launch geometry of model's instance (0 rates, 1 wrench, 2 props): threads
// per block, dynamic shared bytes per block and resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
SDF_NMPC_EXPORT int erk4_sens_geometry(int model, int* threads, int* smem, int* blocks_per_sm) {
  switch (model) {
    case 0: return geometry<Rates>(threads, smem, blocks_per_sm);
    case 1: return geometry<Wrench>(threads, smem, blocks_per_sm);
    case 2: return geometry<Props>(threads, smem, blocks_per_sm);
    default: return int(cudaErrorInvalidValue);
  }
}

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

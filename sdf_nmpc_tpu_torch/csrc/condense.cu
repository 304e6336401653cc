// Condensing recursion and the condensed cost/constraint rows, one thread
// block per scenario.
//
// Replaces: sdf_nmpc_tpu/ops/condense_kernel.py _condense_kernel (:38).
// dx_k = e_k + E_k dz through the horizon:
//   e_{k+1} = A_k e_k + d_k,   E_{k+1} = A_k E_k, then B_k ADDED into the
//   column block [k nu, (k+1) nu)  (S_k is a selection, not a product),
// writing e_k, E_k, eN, EN and the condensed rows
//   G_k = Jyx_k E_k (+ Jyu_k into block k), res_c_k = res_k + Jyx_k e_k,
//   C_k = Jhx_k E_k (+ Jhu_k into block k), c0_k = h_k + Jhx_k e_k.
//
// Bound on this card: bytes.  At B=8192, N=20 the outputs E (10x80), G
// (11x80) and C (3x80) per stage are ~1.3 GB against ~6 GFLOP.  Design: E
// (nx x nz floats, 3.2 KB at the production widths) and the stage's A_k,
// Jyx_k, Jhx_k live in shared memory; the threads walk the flattened (row, column) index of each output,
// so consecutive threads write consecutive columns and every store is
// coalesced.  Each output is written exactly once.

#include "common.cuh"

namespace {

constexpr int NT = 256;

struct CondenseArgs {
  const float *A, *Bm, *d, *e0, *Jyx, *Jyu, *res, *Jhx, *Jhu, *h;
  float *e_st, *E_st, *eN, *EN, *G, *resc, *C, *c0;
  int N, nx, nu, ny, nh;
};

__global__ void __launch_bounds__(NT) condense_kernel(CondenseArgs a) {
  extern __shared__ float smem[];
  const int N = a.N, nx = a.nx, nu = a.nu, ny = a.ny, nh = a.nh, nz = N * nu;
  const int b = blockIdx.x, t = threadIdx.x;
  float* E = smem;                // nx*nz
  float* En = E + nx * nz;        // nx*nz
  float* e = En + nx * nz;        // nx
  float* en = e + nx;             // nx
  float* sA = en + nx;            // nx*nx
  float* sJy = sA + nx * nx;      // ny*nx
  float* sJh = sJy + ny * nx;     // nh*nx

  for (int i = t; i < nx * nz; i += NT) E[i] = 0.f;
  for (int i = t; i < nx; i += NT) e[i] = a.e0[size_t(b) * nx + i];

  for (int k = 0; k < N; ++k) {
    const size_t bk = size_t(b) * N + k;
    for (int i = t; i < nx * nx; i += NT) sA[i] = a.A[bk * nx * nx + i];
    for (int i = t; i < ny * nx; i += NT) sJy[i] = a.Jyx[bk * ny * nx + i];
    for (int i = t; i < nh * nx; i += NT) sJh[i] = a.Jhx[bk * nh * nx + i];
    __syncthreads();

    for (int i = t; i < nx; i += NT) a.e_st[bk * nx + i] = e[i];
    for (int i = t; i < nx * nz; i += NT) a.E_st[bk * nx * nz + i] = E[i];

    // condensed cost rows
    for (int idx = t; idx < ny * nz; idx += NT) {
      const int r = idx / nz, c = idx % nz;
      float s = 0.f;
      for (int j = 0; j < nx; ++j) s += sJy[r * nx + j] * E[j * nz + c];
      const int cb = c - k * nu;
      if (cb >= 0 && cb < nu) s = s + a.Jyu[(bk * ny + r) * nu + cb];
      a.G[bk * ny * nz + idx] = s;
    }
    for (int r = t; r < ny; r += NT) {
      float s = 0.f;
      for (int j = 0; j < nx; ++j) s += sJy[r * nx + j] * e[j];
      a.resc[bk * ny + r] = a.res[bk * ny + r] + s;
    }
    // condensed constraint rows
    for (int idx = t; idx < nh * nz; idx += NT) {
      const int r = idx / nz, c = idx % nz;
      float s = 0.f;
      for (int j = 0; j < nx; ++j) s += sJh[r * nx + j] * E[j * nz + c];
      const int cb = c - k * nu;
      if (cb >= 0 && cb < nu) s = s + a.Jhu[(bk * nh + r) * nu + cb];
      a.C[bk * nh * nz + idx] = s;
    }
    for (int r = t; r < nh; r += NT) {
      float s = 0.f;
      for (int j = 0; j < nx; ++j) s += sJh[r * nx + j] * e[j];
      a.c0[bk * nh + r] = a.h[bk * nh + r] + s;
    }

    // recursion: e' = A e + d, E' = A E (+ B_k into block k)
    for (int idx = t; idx < nx * nz; idx += NT) {
      const int i = idx / nz, c = idx % nz;
      float s = 0.f;
      for (int j = 0; j < nx; ++j) s += sA[i * nx + j] * E[j * nz + c];
      const int cb = c - k * nu;
      if (cb >= 0 && cb < nu) s = s + a.Bm[(bk * nx + i) * nu + cb];
      En[idx] = s;
    }
    for (int i = t; i < nx; i += NT) {
      float s = 0.f;
      for (int j = 0; j < nx; ++j) s += sA[i * nx + j] * e[j];
      en[i] = s + a.d[bk * nx + i];
    }
    __syncthreads();
    float* tmp = E; E = En; En = tmp;
    tmp = e; e = en; en = tmp;
  }
  for (int i = t; i < nx; i += NT) a.eN[size_t(b) * nx + i] = e[i];
  for (int i = t; i < nx * nz; i += NT) a.EN[size_t(b) * nx * nz + i] = E[i];
}

}  // namespace

SDF_NMPC_EXPORT int condense_launch(const float* A, const float* Bm, const float* d,
                                    const float* e0, const float* Jyx, const float* Jyu,
                                    const float* res, const float* Jhx, const float* Jhu,
                                    const float* h, float* e_st, float* E_st, float* eN,
                                    float* EN, float* G, float* resc, float* C, float* c0,
                                    int B, int N, int nx, int nu, int ny, int nh,
                                    cudaStream_t stream) {
  if (B <= 0 || N <= 0 || nh < 1) return int(cudaErrorInvalidValue);
  const int nz = N * nu;
  const size_t smem = sizeof(float) * (2 * nx * nz + 2 * nx + nx * nx + ny * nx + nh * nx);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        condense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  CondenseArgs a{A, Bm, d, e0, Jyx, Jyu, res, Jhx, Jhu, h,
                 e_st, E_st, eN, EN, G, resc, C, c0, N, nx, nu, ny, nh};
  condense_kernel<<<B, NT, smem, stream>>>(a);
  return int(cudaGetLastError());
}

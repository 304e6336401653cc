// Condensing recursion and the condensed cost/constraint rows: one block per
// scenario, each thread four columns of E.
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
// (11x80) and C (3x80) per stage are ~1.3 GB against ~6 GFLOP.
//
// Design.  Thread t < ceil(nz / 4) owns columns 4t..4t+3 of E_k, 4 nx floats
// in registers, for the whole horizon; thread ceil(nz / 4) owns e_k, one more
// column whose update adds d_k where a column adds B_k's entries, and whose
// rows give res_c and c0.  A block is those threads rounded up to whole warps
// (one warp at nz = 80).  Per stage each thread stores its columns of E_k,
// forms its columns of G_k, C_k and E_{k+1}, each entry a sum over j =
// 0..nx-1 in order from s = 0, then the B / Jyu / Jhu entry added, and stores
// G_k and C_k: each row's columns leave as one float4 per thread, so the
// threads of a warp write consecutive 16-byte words.  The stage's matrices sit
// in shared memory with rows padded to a multiple of 4 floats and are read as
// float4 at an index every lane shares (a broadcast), each entry feeding the
// products of four columns.  E_k is zero beyond its first k nu columns: a
// thread whose columns all lie there stores zeros and skips the products, and
// in block k adds the B / Jyu / Jhu entry to +0, the bits the sum of zero
// products gives on finite inputs.  Stage k+1's matrices are copied by
// cp.async into the other of two shared buffers while stage k computes
// (16-byte copies where a slab is 16-byte aligned), so one barrier per stage
// remains and no load latency sits on the critical path.
//
// Non-finite inputs.  The skip is exact only while E's zero columns are
// zeros and the rows multiplying them are finite: the JAX kernel's products
// give 0 * NaN = NaN there.  After the stage's barrier each thread scans its
// float4 chunks of the stage's A, Jyx and Jhx rows, and a second barrier
// votes (__syncthreads_or); from the first stage with a non-finite entry on,
// every column takes the products, so NaN reaches the columns the JAX
// kernel's products reach.  On finite inputs the flag stays down and every
// output keeps its bits.
//
// Instances: nx = 10 and nx = 13 (the quad families) with compile-time
// loops, and any nx <= NX_MAX with the runtime nx as the loop bound.

#include "async_copy.cuh"
#include "common.cuh"

namespace {

constexpr int NX_MAX = 16;
constexpr int CPT = 4;  // columns of E per thread
constexpr int MAX_THREADS = 128;

struct CondenseArgs {
  const float *A, *Bm, *d, *e0, *Jyx, *Jyu, *res, *Jhx, *Jhu, *h;
  float *e_st, *E_st, *eN, *EN, *G, *resc, *C, *c0;
  int N, nx, nu, ny, nh;
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Offsets (floats) of one stage's slabs in a shared buffer; A, Jyx and Jhx
// by rows of stride ld = round4(nx), every slab starting 16-byte aligned.
struct Layout {
  int ld, A, Jyx, Jhx, Bm, Jyu, Jhu, d, res, h, size;
  __host__ __device__ Layout(int nx, int nu, int ny, int nh) {
    ld = round4(nx);
    A = 0;
    Jyx = A + nx * ld;
    Jhx = Jyx + ny * ld;
    Bm = Jhx + nh * ld;
    Jyu = Bm + round4(nx * nu);
    Jhu = Jyu + round4(ny * nu);
    d = Jhu + round4(nh * nu);
    res = d + round4(nx);
    h = res + round4(ny);
    size = h + round4(nh);
  }
};

size_t condense_smem(int nx, int nu, int ny, int nh) {
  return sizeof(float) * 2 * size_t(Layout(nx, nu, ny, nh).size);
}

int block_threads(int nz) { return ((nz + CPT - 1) / CPT + 1 + 31) / 32 * 32; }

// rows x cols, row-major in device memory, into rows of stride ld
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int rows, int cols,
                                          int ld, int t, int nt) {
  for (int i = t; i < rows * cols; i += nt) {
    const int r = i / cols;
    acp::copy4(dst + r * ld + (i - r * cols), src + i);
  }
}

// n contiguous floats; dst is 16-byte aligned
__device__ __forceinline__ void copy_flat(float* dst, const float* src, int n, int t, int nt) {
  int i0 = 0;
  if ((reinterpret_cast<size_t>(src) & 15) == 0) {
    for (int i = t; i < n / 4; i += nt) acp::copy16(dst + 4 * i, src + 4 * i);
    i0 = n / 4 * 4;
  }
  for (int i = i0 + t; i < n; i += nt) acp::copy4(dst + i, src + i);
}

// Whether the stage in S holds a non-finite entry in A, Jyx or Jhx (the
// matrices that multiply E's zero columns): this thread's float4 chunks of
// their rows (contiguous, stride ld), the pad lanes past nx left out.  Read
// after a barrier, so every thread's copies are in.
template <int NXT, bool EXACT>
__device__ __forceinline__ bool nonfinite_scan(const CondenseArgs& a, const Layout& L,
                                               const float* S, int t, int nt) {
  const int nx = EXACT ? NXT : a.nx, q4 = L.ld / 4;
  bool bad = false;
  for (int c = t; c < (nx + a.ny + a.nh) * q4; c += nt) {
    const int j = 4 * (c % q4);
    const float4 v = *reinterpret_cast<const float4*>(S + L.A + 4 * c);
    bad |= (!isfinite(v.x)) | (j + 1 < nx && !isfinite(v.y)) | (j + 2 < nx && !isfinite(v.z)) |
           (j + 3 < nx && !isfinite(v.w));
  }
  return bad;
}

__device__ __forceinline__ void load_stage(const CondenseArgs& a, const Layout& L, size_t bk,
                                           float* S, int t, int nt) {
  const int nx = a.nx, nu = a.nu, ny = a.ny, nh = a.nh;
  copy_rows(S + L.A, a.A + bk * nx * nx, nx, nx, L.ld, t, nt);
  copy_rows(S + L.Jyx, a.Jyx + bk * ny * nx, ny, nx, L.ld, t, nt);
  copy_rows(S + L.Jhx, a.Jhx + bk * nh * nx, nh, nx, L.ld, t, nt);
  copy_flat(S + L.Bm, a.Bm + bk * nx * nu, nx * nu, t, nt);
  copy_flat(S + L.Jyu, a.Jyu + bk * ny * nu, ny * nu, t, nt);
  copy_flat(S + L.Jhu, a.Jhu + bk * nh * nu, nh * nu, t, nt);
  copy_flat(S + L.d, a.d + bk * nx, nx, t, nt);
  copy_flat(S + L.res, a.res + bk * ny, ny, t, nt);
  copy_flat(S + L.h, a.h + bk * nh, nh, t, nt);
}

// s[m] = 0; s[m] += row[j] * x[m][j] for j = 0..nx-1, for each of the CPT
// columns m: the parent's order.  row is a 16-byte aligned shared row, read
// by float4 broadcasts; each entry feeds CPT products.
template <int NXT, bool EXACT>
__device__ __forceinline__ void dot(const float* row, const float (&x)[CPT][NXT], int nx,
                                   float (&s)[CPT]) {
#pragma unroll
  for (int m = 0; m < CPT; ++m) s[m] = 0.f;
#pragma unroll
  for (int q = 0; q < round4(NXT) / 4; ++q) {
    if (!EXACT && 4 * q >= nx) break;
    const float4 w = *reinterpret_cast<const float4*>(row + 4 * q);
    const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int j = 4 * q + l;
      if (j < NXT && (EXACT || j < nx)) {
#pragma unroll
        for (int m = 0; m < CPT; ++m) s[m] += wv[l] * x[m][j];
      }
    }
  }
}

// v[0..n) to p[0..n): one float4 where vec (n == CPT, p 16-byte aligned)
__device__ __forceinline__ void store_cols(float* p, const float (&v)[CPT], int n, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = float4{v[0], v[1], v[2], v[3]};
  } else {
#pragma unroll
    for (int m = 0; m < CPT; ++m)
      if (m < n) p[m] = v[m];
  }
}

template <int NXT, bool EXACT>
__global__ void __launch_bounds__(MAX_THREADS) condense_kernel(CondenseArgs a) {
  extern __shared__ float smem[];
  const int N = a.N, nx = EXACT ? NXT : a.nx, nu = a.nu, ny = a.ny, nh = a.nh, nz = N * nu;
  const Layout L(nx, nu, ny, nh);
  const int b = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const int ncol = (nz + CPT - 1) / CPT;  // threads holding columns of E
  const bool col = t < ncol, is_e = t == ncol;
  const int c = t * CPT, n = min(CPT, nz - c);  // first column, columns held
  // one float4 store per row: 4 columns, 16-byte aligned rows
  const bool vec = col && n == CPT && nz % 4 == 0 &&
                   ((reinterpret_cast<size_t>(a.E_st) | reinterpret_cast<size_t>(a.G) |
                     reinterpret_cast<size_t>(a.C) | reinterpret_cast<size_t>(a.EN)) & 15) == 0;

  float E[CPT][NXT];  // columns c..c+3 of E_k, or e_k in E[0]
#pragma unroll
  for (int m = 0; m < CPT; ++m)
#pragma unroll
    for (int i = 0; i < NXT; ++i)
      E[m][i] = is_e && m == 0 && i < nx ? a.e0[size_t(b) * nx + i] : 0.f;

  load_stage(a, L, size_t(b) * N, smem, t, nt);
  acp::wait_all();
  __syncthreads();
  bool dense = __syncthreads_or(nonfinite_scan<NXT, EXACT>(a, L, smem, t, nt));

  for (int k = 0; k < N; ++k) {
    const size_t bk = size_t(b) * N + k;
    const float* S = smem + (k & 1) * L.size;
    if (k + 1 < N) load_stage(a, L, bk + 1, smem + ((k + 1) & 1) * L.size, t, nt);
    const int cb = c - k * nu;  // column c's place in block k
    const bool live = is_e || (col && (cb < 0 || dense));  // a column here may be nonzero
    // column m lies in block k: add B_k / Jyu_k / Jhu_k's column cb + m
    bool blk[CPT];
#pragma unroll
    for (int m = 0; m < CPT; ++m) blk[m] = col && m < n && cb + m >= 0 && cb + m < nu;

    float v[CPT];
    if (col) {
#pragma unroll
      for (int i = 0; i < NXT; ++i) {
        if (!EXACT && i >= nx) break;
#pragma unroll
        for (int m = 0; m < CPT; ++m) v[m] = E[m][i];
        store_cols(a.E_st + (bk * nx + i) * nz + c, v, n, vec);
      }
    } else if (is_e) {
#pragma unroll
      for (int i = 0; i < NXT; ++i)
        if (EXACT || i < nx) a.e_st[bk * nx + i] = E[0][i];
    }

    // condensed cost rows, then constraint rows
    for (int r = 0; r < ny; ++r) {
      if (live) {
        dot<NXT, EXACT>(S + L.Jyx + L.ld * r, E, nx, v);
      } else {
#pragma unroll
        for (int m = 0; m < CPT; ++m) v[m] = 0.f;
      }
      if (col) {
#pragma unroll
        for (int m = 0; m < CPT; ++m)
          if (blk[m]) v[m] = v[m] + S[L.Jyu + r * nu + cb + m];
        store_cols(a.G + (bk * ny + r) * nz + c, v, n, vec);
      } else if (is_e) {
        a.resc[bk * ny + r] = S[L.res + r] + v[0];
      }
    }
    for (int r = 0; r < nh; ++r) {
      if (live) {
        dot<NXT, EXACT>(S + L.Jhx + L.ld * r, E, nx, v);
      } else {
#pragma unroll
        for (int m = 0; m < CPT; ++m) v[m] = 0.f;
      }
      if (col) {
#pragma unroll
        for (int m = 0; m < CPT; ++m)
          if (blk[m]) v[m] = v[m] + S[L.Jhu + r * nu + cb + m];
        store_cols(a.C + (bk * nh + r) * nz + c, v, n, vec);
      } else if (is_e) {
        a.c0[bk * nh + r] = S[L.h + r] + v[0];
      }
    }

    // recursion: e' = A e + d, E' = A E (+ B_k into block k)
    float En[CPT][NXT];
#pragma unroll
    for (int i = 0; i < NXT; ++i) {
      if (!EXACT && i >= nx) {
#pragma unroll
        for (int m = 0; m < CPT; ++m) En[m][i] = 0.f;
        continue;
      }
      if (live) {
        dot<NXT, EXACT>(S + L.A + L.ld * i, E, nx, v);
      } else {
#pragma unroll
        for (int m = 0; m < CPT; ++m) v[m] = 0.f;
      }
      if (is_e) v[0] = v[0] + S[L.d + i];
#pragma unroll
      for (int m = 0; m < CPT; ++m) {
        if (blk[m]) v[m] = v[m] + S[L.Bm + i * nu + cb + m];
        En[m][i] = v[m];
      }
    }
#pragma unroll
    for (int m = 0; m < CPT; ++m)
#pragma unroll
      for (int i = 0; i < NXT; ++i) E[m][i] = En[m][i];

    acp::wait_all();  // stage k+1 landed (this thread's copies) ...
    __syncthreads();  // ... everyone's, and stage k's buffer is free
    if (k + 1 < N)
      dense = __syncthreads_or(
                  nonfinite_scan<NXT, EXACT>(a, L, smem + ((k + 1) & 1) * L.size, t, nt)) ||
              dense;
  }
  if (col) {
    float v[CPT];
#pragma unroll
    for (int i = 0; i < NXT; ++i) {
      if (!EXACT && i >= nx) break;
#pragma unroll
      for (int m = 0; m < CPT; ++m) v[m] = E[m][i];
      store_cols(a.EN + (size_t(b) * nx + i) * nz + c, v, n, vec);
    }
  } else if (is_e) {
#pragma unroll
    for (int i = 0; i < NXT; ++i)
      if (EXACT || i < nx) a.eN[size_t(b) * nx + i] = E[0][i];
  }
}

using Kernel = void (*)(CondenseArgs);

// The instance for nx, or nullptr beyond NX_MAX.
Kernel pick(int nx) {
  if (nx == 10) return condense_kernel<10, true>;
  if (nx == 13) return condense_kernel<13, true>;
  if (nx >= 1 && nx <= NX_MAX) return condense_kernel<NX_MAX, false>;
  return nullptr;
}

bool bad_sizes(int B, int N, int nx, int nu, int ny, int nh) {
  return B <= 0 || N <= 0 || nu <= 0 || ny <= 0 || nh < 1 || pick(nx) == nullptr ||
         block_threads(N * nu) > MAX_THREADS || condense_smem(nx, nu, ny, nh) > 227 * 1024;
}

int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return int(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

}  // namespace

// Launch geometry at (N, nx, nu, ny, nh): threads per block, dynamic shared
// bytes per block and resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
SDF_NMPC_EXPORT int condense_geometry(int N, int nx, int nu, int ny, int nh, int* threads,
                                      int* smem, int* blocks_per_sm) {
  if (bad_sizes(1, N, nx, nu, ny, nh)) return int(cudaErrorInvalidValue);
  const Kernel kernel = pick(nx);
  const size_t bytes = condense_smem(nx, nu, ny, nh);
  if (int err = allow_smem(kernel, bytes)) return err;
  *threads = block_threads(N * nu);
  *smem = int(bytes);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, *threads,
                                                           bytes));
}

SDF_NMPC_EXPORT int condense_launch(const float* A, const float* Bm, const float* d,
                                    const float* e0, const float* Jyx, const float* Jyu,
                                    const float* res, const float* Jhx, const float* Jhu,
                                    const float* h, float* e_st, float* E_st, float* eN,
                                    float* EN, float* G, float* resc, float* C, float* c0,
                                    int B, int N, int nx, int nu, int ny, int nh,
                                    cudaStream_t stream) {
  if (bad_sizes(B, N, nx, nu, ny, nh)) return int(cudaErrorInvalidValue);
  const Kernel kernel = pick(nx);
  const size_t smem = condense_smem(nx, nu, ny, nh);
  if (int err = allow_smem(kernel, smem)) return err;
  CondenseArgs a{A, Bm, d, e0, Jyx, Jyu, res, Jhx, Jhu, h,
                 e_st, E_st, eN, EN, G, resc, C, c0, N, nx, nu, ny, nh};
  kernel<<<B, block_threads(N * nu), smem, stream>>>(a);
  return int(cudaGetLastError());
}

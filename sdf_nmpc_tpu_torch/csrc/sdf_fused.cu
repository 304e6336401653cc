// NeuralDF value + position gradient in one pass over stacked rows
// [primal; d/dx; d/dy; d/dz]: 4 dense layers + head, res='full' re-concat,
// act' taken from the primal rows.
//
// Replaces: sdf_nmpc_tpu/ops/sdf_fused.py _kernel (:154) in its exact-f32
// mode.  Each layer is Z = rows @ W for all four row groups; the primal rows
// add the bias and give H = act(Z_p), the tangent rows give act'(Z_p) * Z_t.
// After the second layer the original input rows (embedding | latent, and
// their tangents) are re-concatenated for primal and tangent rows alike.
//
// Bound on this card: operations.  Per point the four row groups cost
// 4 x 304,896 multiply-adds at the production widths (211 -> 256 -> 256 ->
// 467 -> 256 -> 256 -> 1), 4.0e11 FLOP per step at B=8192, N=20: over the
// FP32 (non-tensor-core) peak that takes ~20x longer than the ~0.3 GB the
// kernel moves takes over the memory rate.  The products are computed in the
// kernel body in FP32 FMAs: no TF32, no library GEMM.
//
// Design: one thread block per tile of 16 points (64 stacked rows).  The
// tile's input rows (64 x in1p) and current activations (64 x 256) stay in
// shared memory through all five layers, so nothing but the inputs and the
// 16 x 4 outputs touches device memory; the weights stream from L2 through a
// 32 x 256 shared-memory chunk.  Each of the 256 threads owns 2 points x 4
// row groups x 8 columns (64 accumulators), so the activation derivative of
// a column is in the same thread as the tangent rows it scales.  Tensor-core
// 3xTF32 and a deeper shared-memory pipeline are later levers.

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int TP = 16;        // points per tile
constexpr int ROWS = 4 * TP;  // stacked rows per tile
constexpr int HID = 256;      // hidden width (layers are zero-padded to it)
constexpr int KC = 32;        // weight rows per shared-memory chunk

struct SdfArgs {
  const float *emb, *demb, *lat;
  const float *W1, *b1, *W2, *b2, *W3, *b3, *W4, *b4, *w5, *b5;
  float *df, *grad;
  int P, nemb, L, in1p, act;
  float w0;
};

__device__ __forceinline__ void act_pair(float z, int act, float w0, float& h, float& hp) {
  if (act == 0) {
    h = sinf(w0 * z);
    hp = w0 * cosf(w0 * z);
  } else if (act == 1) {
    h = fmaxf(z, 0.f);
    hp = z > 0.f ? 1.f : 0.f;
  } else {
    h = fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
    hp = 1.f / (1.f + expf(-z));
  }
}

// acc[g][pp][j] = sum_k src(row(g, pp), k) W[k][c_j] over the rows the
// thread owns; the first KA reduction indices come from srcA (row stride
// sA), the next KB from srcB.  KA and KB are multiples of KC.
__device__ __forceinline__ void gemm_rows(float (&acc)[4][2][8], const float* srcA, int KA,
                                          int sA, const float* srcB, int KB, int sB,
                                          const float* __restrict__ W, float* Ws) {
  const int t = threadIdx.x, cg = t & 31, pg = t >> 5;
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int pp = 0; pp < 2; ++pp)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[g][pp][j] = 0.f;

  for (int k0 = 0; k0 < KA + KB; k0 += KC) {
    __syncthreads();  // previous chunk fully consumed
    const float4* W4 = reinterpret_cast<const float4*>(W + size_t(k0) * HID);
    float4* Ws4 = reinterpret_cast<float4*>(Ws);
#pragma unroll
    for (int i = t; i < KC * HID / 4; i += NT) Ws4[i] = W4[i];
    __syncthreads();
    const float* src = k0 < KA ? srcA + k0 : srcB + (k0 - KA);
    const int stride = k0 < KA ? sA : sB;
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float av[4][2], wv[8];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) av[g][pp] = src[(g * TP + 2 * pg + pp) * stride + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) wv[j] = Ws[kk * HID + cg + 32 * j];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int pp = 0; pp < 2; ++pp)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[g][pp][j] = fmaf(av[g][pp], wv[j], acc[g][pp][j]);
    }
  }
}

// bias + activation on the primal rows, act' times the tangent rows, into Hs
__device__ __forceinline__ void epilogue(float (&acc)[4][2][8], const float* __restrict__ bias,
                                         int act, float w0, float* Hs) {
  const int t = threadIdx.x, cg = t & 31, pg = t >> 5;
  __syncthreads();  // every thread is done reading Hs as a layer input
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = cg + 32 * j;
    const float bc = bias[c];
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) {
      const int pt = 2 * pg + pp;
      float h, hp;
      act_pair(acc[0][pp][j] + bc, act, w0, h, hp);
      Hs[pt * HID + c] = h;
#pragma unroll
      for (int g = 1; g < 4; ++g) Hs[(g * TP + pt) * HID + c] = hp * acc[g][pp][j];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT) sdf_fused_kernel(SdfArgs a) {
  extern __shared__ float4 smem4[];
  float* X0 = reinterpret_cast<float*>(smem4);  // ROWS x in1p
  float* Hs = X0 + ROWS * a.in1p;               // ROWS x HID
  float* Ws = Hs + ROWS * HID;                  // KC x HID
  const int t = threadIdx.x;
  const int p0 = blockIdx.x * TP;
  const int nemb = a.nemb, L = a.L, in1p = a.in1p;

  // stacked input rows: primal [emb | latent | 0], tangent g [demb_g | 0 | 0]
  for (int idx = t; idx < ROWS * in1p; idx += NT) {
    const int row = idx / in1p, k = idx % in1p;
    const int g = row / TP, p = p0 + row % TP;
    float v = 0.f;
    if (p < a.P) {
      if (k < nemb)
        v = g == 0 ? a.emb[size_t(p) * nemb + k] : a.demb[(size_t(p) * 3 + g - 1) * nemb + k];
      else if (k < nemb + L && g == 0)
        v = a.lat[size_t(p) * L + (k - nemb)];
    }
    X0[idx] = v;
  }

  float acc[4][2][8];
  gemm_rows(acc, X0, in1p, in1p, nullptr, 0, 0, a.W1, Ws);
  epilogue(acc, a.b1, a.act, a.w0, Hs);
  gemm_rows(acc, Hs, HID, HID, nullptr, 0, 0, a.W2, Ws);
  epilogue(acc, a.b2, a.act, a.w0, Hs);
  // res='full': [h | original input rows] for primal and tangent rows alike
  gemm_rows(acc, Hs, HID, HID, X0, in1p, in1p, a.W3, Ws);
  epilogue(acc, a.b3, a.act, a.w0, Hs);
  gemm_rows(acc, Hs, HID, HID, nullptr, 0, 0, a.W4, Ws);
  epilogue(acc, a.b4, a.act, a.w0, Hs);

  // head: one warp per 8 rows, lanes split the 256 columns
  const int lane = t & 31, warp = t >> 5;
  for (int r = warp * (ROWS / (NT / 32)); r < (warp + 1) * (ROWS / (NT / 32)); ++r) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < HID / 32; ++i) s += Hs[r * HID + lane + 32 * i] * a.w5[lane + 32 * i];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const int g = r / TP, p = p0 + r % TP;
    if (lane == 0 && p < a.P) {
      if (g == 0)
        a.df[p] = s + a.b5[0];
      else
        a.grad[size_t(p) * 3 + g - 1] = s;
    }
  }
}

}  // namespace

SDF_NMPC_EXPORT size_t sdf_fused_smem_bytes(int in1p) {
  return sizeof(float) * (size_t(ROWS) * in1p + ROWS * HID + KC * HID);
}

SDF_NMPC_EXPORT int sdf_fused_launch(const float* emb, const float* demb, const float* lat,
                                     const float* W1, const float* b1, const float* W2,
                                     const float* b2, const float* W3, const float* b3,
                                     const float* W4, const float* b4, const float* w5,
                                     const float* b5, float* df, float* grad, int P, int nemb,
                                     int L, int in1p, int act, float w0, cudaStream_t stream) {
  if (P <= 0 || in1p % KC != 0 || nemb + L > in1p || act < 0 || act > 2)
    return int(cudaErrorInvalidValue);
  SdfArgs a{emb, demb, lat, W1, b1, W2, b2, W3, b3, W4, b4, w5, b5, df, grad,
            P, nemb, L, in1p, act, w0};
  const size_t smem = sdf_fused_smem_bytes(in1p);
  cudaError_t err = cudaFuncSetAttribute(
      sdf_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  sdf_fused_kernel<<<(P + TP - 1) / TP, NT, smem, stream>>>(a);
  return int(cudaGetLastError());
}

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
// Bound on this card: operations.  Per point the primal row costs 304,896
// multiply-adds at the production widths (211 -> 256 -> 256 -> 467 -> 256 ->
// 256 -> 1) and each tangent row 239,360, since a tangent row's latent
// columns are zero: 3.35e11 FLOP per step at B=8192, N=20, 5.0 ms at the
// FP32 (non-tensor-core) peak, against ~0.3 GB of inputs (0.09 ms at the
// memory rate).  The products are IEEE f32 FMAs on the CUDA cores, the JAX
// mode's HIGHEST: no TF32 (the f32x3 route, sdf_fused_x3.cu, is the
// tensor-core counterpart), no library GEMM, no fast math.
//
// Design: one 256-thread block (8 warps) per tile of TP = 16 points, 64
// stacked rows; two blocks per SM, whose barriers are independent, so one
// block's products run while the other waits at a barrier or in an epilogue.
//   - The activations stay in shared memory k-major, per column k the 64 rows
//     point-major (row 4 p + g, g the row group), padded to RS = 68 words, so
//     that one 16-byte load brings a point's four rows at one k (and the
//     epilogue's 16-byte stores, 4 columns apart, fall on both bank halves).
//   - The weights of all four layers stream from L2 as one sequence of
//     16-row chunks (layer 1: the input chunks; 2: 16; 3: 16 and the input
//     chunks again; 4: 16) through a ring of 2 stages filled by cp.async
//     (async_copy.cuh), one barrier per chunk: the copies of chunk c + 1
//     overlap the products of chunk c.  The input columns (embedding, its
//     tangents, latent) come through the same ring, 16 columns a chunk, for
//     layer 1 and again for layer 3's re-concat, so they are never resident.
//   - The products run on ffma_tile.cuh's register tile.  Warp w owns points
//     8 (w % 2) .. + 7 and columns 64 (w / 2) .. + 63; lane l owns points
//     p = 8 (w % 2) + l % 4 and p + 4, all four row groups of each (8 rows),
//     and columns c = 64 (w / 2) + 4 (l / 4) + {0..3} and c + 32 + {0..3}:
//     64 accumulators, so act' of an output sits in the same thread as the
//     three tangent outputs it scales.  Per k a thread makes two 16-byte
//     loads of rows and two of weights for 64 FMAs, and per warp each load
//     is one wavefront (4 points x 16 B of rows, 8 runs x 16 B of weights):
//     4 shared-memory wavefronts per 64 FFMA warp-instructions (the first
//     design: 16).
//   - A chunk of input columns that holds no embedding column multiplies the
//     primal rows alone (a tangent row's latent columns are zero).
//   - bias, activation (sincosf: one range reduction for both) and act' in
//     IEEE f32; layer 4's rows go to shared memory and the head reduces each
//     row with one warp, lanes over the columns, then shuffles.
//
// Numerics: every output of a layer is one FMA chain over k in increasing
// order (a skipped column multiplies a zero: fma(0, w, a) = a), bias and
// activation as the plain loop, the head's order as the first design's: the
// outputs equal the first design's bit for bit (chip_smoke.py --sdf-builds).
//
// Shared memory per block: activations 69,632 B + 2 stages x (weights 16 KB
// + inputs 16 x 68 words) 41,472 B = 111,104 B; L2 reads per B=8192 step:
// 10,240 tiles x 1.25 MB of weights = 12.7 GB.  Measured (chip_smoke.py
// --sdf-builds, H100 80GB HBM3 at 700 W): 8.9-9.0 ms per B=8192 steady step,
// 55-56% of the bound, against 18.0-18.2 ms for the first design (16 points
// on 256 threads, the weights copied through registers between two
// barriers, 64 scalar loads per k).  Measured there too (PERF.md section 6):
// the same tile at 32 points on 512 threads, one block per SM, 9.1-9.2 ms;
// 16 columns a thread on 256 threads, 11.7-11.9 ms.

#include "async_copy.cuh"
#include "common.cuh"
#include "ffma_tile.cuh"

namespace {

constexpr int NT = 256;
constexpr int TP = 16;          // points per tile
constexpr int ROWS = 4 * TP;    // stacked rows, point-major: row 4 p + g
constexpr int HID = 256;        // hidden width (layers are zero-padded to it)
constexpr int KC = 16;          // weight rows (and input columns) per chunk
constexpr int RS = ROWS + 4;    // words per k of the activations and input chunks
constexpr int WCH = KC * HID;   // words of a weight chunk
constexpr int STAGE = WCH + KC * RS;
constexpr int NSTAGE = 2;
constexpr int NCOL = 8;         // columns per thread: NCOL / 4 runs of four, 32 apart
constexpr int NPO = TP / 8;     // point octets: warps per column group of 8 NCOL
constexpr int SMEM_WORDS = HID * RS + NSTAGE * STAGE;
constexpr size_t SMEM_BYTES = sizeof(float) * SMEM_WORDS;
static_assert(NT == 32 * NPO * (HID / (8 * NCOL)), "warps: point octets x column groups");

struct SdfArgs {
  const float *emb, *demb, *lat;  // (P, nemb), (P, 3, nemb), (P, L)
  const float *W1, *b1, *W2, *b2, *W3, *b3, *W4, *b4, *w5, *b5;
  float *df, *grad;               // (P,), (P, 3)
  int P, nemb, L, in1p, act;
  float w0;
};

__device__ __forceinline__ void act_pair(float z, int act, float w0, float& h, float& hp) {
  if (act == 0) {
    float c;
    sincosf(w0 * z, &h, &c);  // one range reduction for both
    hp = w0 * c;
  } else if (act == 1) {
    h = fmaxf(z, 0.f);
    hp = z > 0.f ? 1.f : 0.f;
  } else {
    h = fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
    hp = 1.f / (1.f + expf(-z));
  }
}

// Chunk c of the sequence: its weight rows, what it multiplies (kind 0 =
// activation columns [k0, k0 + KC); 1 = input columns [k0, k0 + KC) that
// hold embedding columns, all four row groups; 2 = input columns without,
// primal rows only), and the bias of the layer it ends (else null).
struct Chunk {
  const float *w, *bias;
  int kind, k0;
};

__device__ __forceinline__ Chunk chunk_of(const SdfArgs& a, int c, int nx, int nxe) {
  constexpr int NH = HID / KC;
  const int l3 = nx + NH, l3x = l3 + NH, l4 = l3x + nx;
  if (c < nx)
    return {a.W1 + size_t(c) * WCH, c == nx - 1 ? a.b1 : nullptr, c < nxe ? 1 : 2, c * KC};
  if (c < l3)
    return {a.W2 + size_t(c - nx) * WCH, c == l3 - 1 ? a.b2 : nullptr, 0, (c - nx) * KC};
  if (c < l3x) return {a.W3 + size_t(c - l3) * WCH, nullptr, 0, (c - l3) * KC};
  if (c < l4) {
    const int j = c - l3x;
    return {a.W3 + size_t(c - l3) * WCH, c == l4 - 1 ? a.b3 : nullptr, j < nxe ? 1 : 2, j * KC};
  }
  return {a.W4 + size_t(c - l4) * WCH, c == l4 + NH - 1 ? a.b4 : nullptr, 0, (c - l4) * KC};
}

// Start the copies of chunk c into ring stage st (every thread takes part):
// the weight rows as they lie in device memory, the input columns (if any)
// k-major at st + WCH, rows point-major, zero where a row has no value.
// Thread t copies input column kk = t % KC of the rows t / KC + m NT / KC: one
// row group g and source row stride for all its copies of a chunk.
__device__ __forceinline__ void load_chunk(const SdfArgs& a, const Chunk& ch, int p0, float* st) {
  static_assert(NT % (4 * KC) == 0 && TP * KC % NT == 0 && WCH % (4 * NT) == 0,
                "a thread's input rows keep their row group; whole copies per thread");
  const int t = threadIdx.x, kk = t % KC, row = t / KC, k = ch.k0 + kk;
#pragma unroll
  for (int m = 0; m < WCH / (4 * NT); ++m) {
    const int i = 4 * (t + m * NT);
    acp::copy16(st + i, ch.w + i);
  }
  float* xs = st + WCH + kk * RS;
  const int nemb = a.nemb, L = a.L;
  if (ch.kind == 0) return;
  // the source of (point p, row group g, column k): base + p * stride
  const int g = ch.kind == 1 ? row % 4 : 0;
  const float* base = a.emb;
  int stride = 0;
  bool has = true;
  if (k < nemb) {
    base = g == 0 ? a.emb + k : a.demb + (g - 1) * nemb + k;
    stride = g == 0 ? nemb : 3 * nemb;
  } else if (g == 0 && k < nemb + L) {
    base = a.lat + (k - nemb);
    stride = L;
  } else {
    has = false;
  }
  if (ch.kind == 1) {  // all four row groups: rows 4 p + g
#pragma unroll
    for (int m = 0; m < ROWS * KC / NT; ++m) {
      const int r = row + m * (NT / KC), p = p0 + r / 4;
      const bool valid = has && p < a.P;
      acp::copy4(xs + r, valid ? base + size_t(p) * stride : a.emb, valid);
    }
  } else {  // the primal rows: rows 4 p
#pragma unroll
    for (int m = 0; m < TP * KC / NT; ++m) {
      const int pt = row + m * (NT / KC), p = p0 + pt;
      const bool valid = has && p < a.P;
      acp::copy4(xs + 4 * pt, valid ? base + size_t(p) * stride : a.emb, valid);
    }
  }
}

__global__ void __launch_bounds__(NT, 2) sdf_fused_kernel(SdfArgs a) {
  extern __shared__ float4 smem4[];
  float* Hs = reinterpret_cast<float*>(smem4);  // HID x RS: activations, k-major
  float* ring = Hs + HID * RS;                  // NSTAGE x STAGE
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int pt0 = 8 * (warp % NPO) + (lane & 3);         // points pt0, pt0 + 4
  const int col0 = 8 * NCOL * (warp / NPO) + 4 * (lane >> 2);  // col0 + 32 q + {0..3}
  const int p0 = blockIdx.x * TP;
  const int nx = a.in1p / KC, nxe = (a.nemb + KC - 1) / KC;
  const int n_chunks = 2 * nx + 3 * (HID / KC);

  // acc[4 i + g][4 q + e]: point pt0 + 4 i, row group g, column col0 + 32 q + e
  float acc[8][NCOL];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < NCOL; ++j) acc[r][j] = 0.f;

#pragma unroll
  for (int c = 0; c < NSTAGE - 1; ++c) {
    load_chunk(a, chunk_of(a, c, nx, nxe), p0, ring + c * STAGE);
    acp::commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    acp::wait<NSTAGE - 2>();  // this thread's copies of chunk c have landed
    __syncthreads();          // everyone's; and chunk c - 1's stage is free
    if (c + NSTAGE - 1 < n_chunks)
      load_chunk(a, chunk_of(a, c + NSTAGE - 1, nx, nxe), p0,
                 ring + ((c + NSTAGE - 1) % NSTAGE) * STAGE);
    acp::commit();
    const float* st = ring + (c % NSTAGE) * STAGE;
    const Chunk ch = chunk_of(a, c, nx, nxe);
    const float* w = st + col0;
    if (ch.kind == 0) {
      ffma_tile::chunk<KC, HID>(acc, ffma_tile::KMajor<8, RS, 16>{Hs + ch.k0 * RS + 4 * pt0}, w);
    } else if (ch.kind == 1) {
      ffma_tile::chunk<KC, HID>(acc, ffma_tile::KMajor<8, RS, 16>{st + WCH + 4 * pt0}, w);
    } else {  // primal rows only: acc[0] and acc[4]
      float pacc[2][NCOL];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NCOL; ++j) pacc[i][j] = acc[4 * i][j];
      ffma_tile::chunk<KC, HID>(pacc, ffma_tile::KMajorScalar<2, RS, 16>{st + WCH + 4 * pt0}, w);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NCOL; ++j) acc[4 * i][j] = pacc[i][j];
    }
    if (ch.bias == nullptr) continue;
    // the layer's epilogue into Hs: bias + activation on the primal rows,
    // act' times the tangent rows; after the last reads of Hs as this
    // layer's input (layers 2 and 4 end on an activation chunk)
    if (ch.kind == 0) __syncthreads();
    const float* b = ch.bias;
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      const int col = col0 + 32 * (j >> 2) + (j & 3);
      const float bc = b[col];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float h, hp;
        act_pair(acc[4 * i][j] + bc, a.act, a.w0, h, hp);
        *reinterpret_cast<float4*>(Hs + col * RS + 4 * (pt0 + 4 * i)) =
            make_float4(h, hp * acc[4 * i + 1][j], hp * acc[4 * i + 2][j], hp * acc[4 * i + 3][j]);
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[4 * i + g][j] = 0.f;
      }
    }
  }
  __syncthreads();  // layer 4's rows are in Hs

  // head: one warp per 8 rows (row r = g TP + p), lanes split the 256 columns
  for (int r = warp * (ROWS / (NT / 32)); r < (warp + 1) * (ROWS / (NT / 32)); ++r) {
    const int g = r / TP, pt = r % TP, p = p0 + pt;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < HID / 32; ++i)
      s += Hs[(lane + 32 * i) * RS + 4 * pt + g] * a.w5[lane + 32 * i];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0 && p < a.P) {
      if (g == 0)
        a.df[p] = s + a.b5[0];
      else
        a.grad[size_t(p) * 3 + g - 1] = s;
    }
  }
}

cudaError_t configure() {
  static bool set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && set[dev])) return err;
  err = cudaFuncSetAttribute(sdf_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(SMEM_BYTES));
  if (err == cudaSuccess && dev < 64) set[dev] = true;
  return err;
}

}  // namespace

// Launch geometry: threads per block, dynamic shared bytes per block and
// resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
SDF_NMPC_EXPORT int sdf_fused_geometry(int* threads, int* smem, int* blocks_per_sm) {
  const cudaError_t err = configure();
  if (err != cudaSuccess) return int(err);
  *threads = NT;
  *smem = int(SMEM_BYTES);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, sdf_fused_kernel, NT,
                                                           SMEM_BYTES));
}

SDF_NMPC_EXPORT int sdf_fused_launch(const float* emb, const float* demb, const float* lat,
                                     const float* W1, const float* b1, const float* W2,
                                     const float* b2, const float* W3, const float* b3,
                                     const float* W4, const float* b4, const float* w5,
                                     const float* b5, float* df, float* grad, int P, int nemb,
                                     int L, int in1p, int act, float w0, cudaStream_t stream) {
  if (P <= 0 || nemb <= 0 || L < 0 || in1p % KC != 0 || nemb + L > in1p || act < 0 || act > 2)
    return int(cudaErrorInvalidValue);
  const cudaError_t err = configure();
  if (err != cudaSuccess) return int(err);
  SdfArgs a{emb, demb, lat, W1, b1, W2, b2, W3, b3, W4, b4, w5, b5, df, grad,
            P, nemb, L, in1p, act, w0};
  sdf_fused_kernel<<<(P + TP - 1) / TP, NT, SMEM_BYTES, stream>>>(a);
  return int(cudaGetLastError());
}

// NeuralDF value + position gradient on the tensor cores, in 3xTF32: the
// solver's default mode, sdf_fused_dtype 'f32x3'.
//
// Replaces: sdf_nmpc_tpu/ops/sdf_fused.py _kernel (:154) in its f32x3 mode,
// where _dot3 (:180) splits both operands into a bf16 high part and a bf16
// residual and sums three MXU passes, hi*hi + (hi*lo + lo*hi).  Here the
// split is into TF32 parts, Hopper's tensor-core type: hi = tf32(a) and lo =
// tf32(a - hi), each rounded to nearest with ties away (as cvt.rna), so hi + lo
// carries a to about 2^-22 and the dropped lo*lo term is as small; the JAX
// mode's bf16 parts carry 16 bits.  The stacked rows are as in sdf_fused.cu:
// [primal; d/dx; d/dy; d/dz] through four dense layers, H = act(Z_p + b) and
// dH = act'(Z_p + b) * Z_t, the res='full' re-concat of the input rows for
// primal and tangent rows alike.
//
// Numerics, which ops/sdf_fused.py::sdf_value_grad_x3_plain repeats:
//   - the activations are split on the fly as they are read; the weights
//     were split once on the host (ops/sdf_fused.py::_x3_weights, the same
//     rounding) and arrive as W_hi and W_lo;
//   - at every 8-deep step of a layer's sum the tensor core forms, from
//     zero, the small terms lo*W_hi + hi*W_lo and apart the large one
//     hi*W_hi, and the step adds big + small to the f32 accumulator in IEEE
//     f32: _dot3's grouping, hi*hi + (hi*lo + lo*hi), step by step.  The
//     tensor core's own f32 additions truncate: summing the whole 467-deep
//     products there (one accumulator on the tensor core) put the kernel
//     4.7e-6 (value) and 1.2e-5 (gradient) from its plain version on
//     chip_smoke.py's check inputs (sdf_fused.cu: 3.6e-7) and moved the
//     dual-warm-started accuracy tick (11, 1) from 1.39e-2 to 1.41e-2,
//     beyond its limit; step by step the kernel lies closer to f64 than the
//     IEEE kernel does;
//   - bias, activation, act' and the 256-wide head (value and gradient) in
//     IEEE f32 on the CUDA cores.
//
// Bound on this card: operations.  4 x 1.02 M multiply-adds per point at the
// production widths (211 -> 256 -> 256 -> 467 -> 256 -> 256 -> 1), three
// TF32 passes each: 1.0e12 FLOP per B=8192, N=20 step, 2.03 ms at the 495
// TFLOP/s dense TF32 peak, against 0.3 GB of inputs (0.1 ms at 3.35 TB/s).
//
// Design: one 512-thread block (16 warps) per tile of TP = 32 points, 128
// stacked rows.  The activations stay in shared memory (128 x 256, rows
// padded to 264 words, and each 8-column block stored in the order 0 4 1 5
// 2 6 3 7: a lane's two A-fragment entries are one 8-byte load, free of
// bank conflicts).  The weights of all four layers, hi and lo, stream from
// L2 as one sequence of 16-row chunks through a ring of 2 stages filled by
// cp.async while the tensor cores work on the other stage (the next layer's
// first chunk loads during an epilogue), laid out so that a lane's B
// fragments, hi and lo, are one 16-byte load; the input rows (embedding, its
// tangents, latent) come through the same ring as 16-column chunks, for
// layer 1 and again for layer 3's re-concat, so they are never resident.
// Warp w owns points 16 (w % 2) .. + 15 and columns 32 (w / 2) .. + 31, as
// four 16-row M tiles, one per row group of the same 16 points
// (mma.sync.m16n8k8, 4 N tiles), so act' of an output sits in the same
// thread as the three tangent outputs it scales.  A tangent row's latent
// columns are zero, so latent chunks multiply the primal rows alone.  The
// head reduces each warp's 32 columns with shuffles and the 8 column groups
// through shared memory.
//
// Shared memory per block: activations 135,168 B + 2 stages x (weights
// 32 KB + inputs 128 x 24 words) 90,112 B + head partials 4,096 B = 229,376
// B: one block (16 warps) per SM; ptxas: 128 registers.  L2 reads per step:
// 5,120 tiles x 2.49 MB of weights (hi and lo) = 12.7 GB at the production
// widths.
//
// Measured (chip_smoke.py, H100 80GB HBM3 at 700 W): 9.4-9.6 ms per B=8192
// steady step, 21% of the bound, against 17.9-18.1 ms for the IEEE kernel
// sdf_fused.cu; against the f64 network 7.2e-7 (value) and 1.6e-6
// (gradient) at most on the main path's inputs (--sdf-builds), closer than
// the IEEE kernel.  Alternatives measured there (PERF.md section 6): 8
// warps of 64 columns (255 registers) slower; cvt.rna in place of the two
// integer operations of tf32.cuh slower, the same bits; one tensor-core chain
// per step, large term first, 0.9 ms faster; the whole layer on the tensor
// core 1.5 ms faster and 10x further from f64.  Without the products the
// kernel still took about 6 ms: the instruction stream around them
// (fragment loads, splits, epilogues) with one block per SM is what holds
// it; a wgmma version, correct, ran slower (ptxas serialized its products).

#include "common.cuh"
#include "tf32.cuh"

namespace {

constexpr int NT = 512;
constexpr int NQ = NT / 64;    // column groups: warps per point half
constexpr int NJ = 32 / NQ;    // 8-column N tiles per warp
constexpr int TP = 32;         // points per tile
constexpr int ROWS = 4 * TP;   // stacked rows per tile
constexpr int HID = 256;       // hidden width (layers are zero-padded to it)
constexpr int KC = 16;         // weight rows (and input columns) per chunk
constexpr int HS = HID + 8;    // activation row stride (words; 8 mod 32)
constexpr int XS = KC + 8;     // input-chunk row stride (8 mod 32)
constexpr int WCH = HID * 2 * KC;  // words of a weight chunk, hi and lo interleaved
constexpr int STAGE = WCH + ROWS * XS;  // words per ring stage
constexpr int NSTAGE = 2;
constexpr int SMEM_WORDS = ROWS * HS + NSTAGE * STAGE + NQ * ROWS;
constexpr size_t SMEM_BYTES = sizeof(float) * SMEM_WORDS;

struct X3Args {
  const float *emb, *demb, *lat;  // (P, nemb), (P, 3, nemb), (P, L)
  const float *W;                 // (n_chunks, WCH): the four layers' chunks, in order
  const float *bias;              // (4, HID)
  const float *w5, *b5;           // (HID,), (1,)
  float *df, *grad;               // (P,), (P, 3)
  int P, nemb, L, nxe, nxl;       // input chunks: embedding, latent
  int act;
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

// Where column c of a row lies in shared memory: within each 8-column block
// the order is 0 4 1 5 2 6 3 7, so that the two A-fragment entries of a lane
// (columns t and t + 4) are adjacent and load as one 8-byte word.
__device__ __forceinline__ int kpos(int c) { return (c & ~7) | ((c & 3) << 1) | ((c >> 2) & 1); }

// What chunk c of the sequence multiplies: kind 0 = activation columns
// [k0, k0 + KC) of the resident rows, 1 = embedding columns (all four row
// groups), 2 = latent columns (primal rows only).  The sequence: layer 1 =
// nx input chunks, layer 2 = 16 activation chunks, layer 3 = 16 activation
// chunks then nx input chunks, layer 4 = 16 activation chunks.
struct Chunk {
  int kind, k0;
};

__device__ __forceinline__ Chunk chunk_of(int c, int nxe, int nx) {
  const int l3x = nx + 2 * (HID / KC);  // first input chunk of layer 3
  int j;
  if (c < nx) {
    j = c;
  } else if (c < l3x) {
    return {0, ((c - nx) % (HID / KC)) * KC};
  } else if (c < l3x + nx) {
    j = c - l3x;
  } else {
    return {0, (c - l3x - nx) * KC};
  }
  return j < nxe ? Chunk{1, j * KC} : Chunk{2, (j - nxe) * KC};
}

// Start the copies of chunk c into ring stage st (every thread takes part):
// the weight chunk as it lies in device memory, the input columns (if any)
// to their kpos places.
__device__ __forceinline__ void load_chunk(const X3Args& a, int c, int p0, float* st) {
  const int t = threadIdx.x;
  const float* gw = a.W + size_t(c) * WCH;
  float* xs = st + WCH;
#pragma unroll
  for (int i = 4 * t; i < WCH; i += 4 * NT) tf32::copy16(st + i, gw + i);
  const Chunk ch = chunk_of(c, a.nxe, a.nxe + a.nxl);
  if (ch.kind == 1) {
#pragma unroll
    for (int i = t; i < ROWS * KC; i += NT) {
      const int row = i / KC, col = i % KC;
      const int g = row / TP, p = p0 + row % TP, k = ch.k0 + col;
      const bool valid = p < a.P && k < a.nemb;
      const float* src = g == 0 ? a.emb + size_t(p) * a.nemb + k
                                : a.demb + (size_t(p) * 3 + g - 1) * a.nemb + k;
      tf32::copy4(xs + row * XS + kpos(col), valid ? src : a.emb, valid);
    }
  } else if (ch.kind == 2) {
#pragma unroll
    for (int i = t; i < TP * KC; i += NT) {
      const int row = i / KC, col = i % KC;
      const int p = p0 + row, k = ch.k0 + col;
      const bool valid = p < a.P && k < a.L;
      tf32::copy4(xs + row * XS + kpos(col), valid ? a.lat + size_t(p) * a.L + k : a.lat,
                  valid);
    }
  }
}

// The TF32 split of one operand: hi = tf32(v), lo = tf32(v - hi).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32::rna(v);
  lo = tf32::rna(v - __uint_as_float(hi));
}

// acc[g][j] += rows(g) (16 x KC from A: group g at A + g * gstride, row
// stride lda, columns in kpos order) times the chunk's weight columns of N
// tile j, in 3xTF32, for the first NG row groups.  The weight chunk w holds,
// for each output column n, 32 words: per 8-row block kb (at slot kb ^ (n &
// 1), against bank conflicts) and lane t of a quad, [hi(t), hi(t + 4),
// lo(t), lo(t + 4)], so that a lane's B fragments, hi and lo, are one
// 16-byte load.
template <int NG>
__device__ __forceinline__ void mma_chunk(float (&acc)[4][NJ][4], const float* A, int lda,
                                          int gstride, const float* w, int n0) {
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int kb = 0; kb < KC / 8; ++kb) {
    uint32_t bh[NJ][2], bl[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = n0 + 8 * j + g8;
      const float4 b =
          *reinterpret_cast<const float4*>(w + n * 2 * KC + ((kb ^ (n & 1)) * 16) + 4 * t4);
      bh[j][0] = __float_as_uint(b.x);
      bh[j][1] = __float_as_uint(b.y);
      bl[j][0] = __float_as_uint(b.z);
      bl[j][1] = __float_as_uint(b.w);
    }
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float* r0 = A + g * gstride + g8 * lda + 8 * kb + 2 * t4;
      const float2 x0 = *reinterpret_cast<const float2*>(r0);
      const float2 x1 = *reinterpret_cast<const float2*>(r0 + 8 * lda);
      uint32_t ahi[4], alo[4];  // A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]
      split(x0.x, ahi[0], alo[0]);
      split(x1.x, ahi[1], alo[1]);
      split(x0.y, ahi[2], alo[2]);
      split(x1.y, ahi[3], alo[3]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float small[4], big[4];  // _dot3's grouping: hi*hi + (hi*lo + lo*hi)
        tf32::mma_zero(small, alo, bh[j]);
        tf32::mma(small, ahi, bl[j]);
        tf32::mma_zero(big, ahi, bh[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][j][e] += big[e] + small[e];
      }
    }
  }
}

__global__ void __launch_bounds__(NT, 1) sdf_fused_x3_kernel(X3Args a) {
  extern __shared__ float4 smem4[];
  float* Hs = reinterpret_cast<float*>(smem4);  // ROWS x HS: activations
  float* ring = Hs + ROWS * HS;                 // NSTAGE x STAGE
  float* red = ring + NSTAGE * STAGE;           // NQ x ROWS: head partials
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g8 = lane >> 2, t4 = lane & 3;
  const int ph = warp & 1, n0 = (warp >> 1) * 8 * NJ;  // point half, first column
  const int p0 = blockIdx.x * TP;
  const int nx = a.nxe + a.nxl;
  const int l3x = nx + 2 * (HID / KC);
  const int n_chunks = l3x + nx + HID / KC;

  float acc[4][NJ][4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][j][e] = 0.f;

  load_chunk(a, 0, p0, ring);
  tf32::commit();
  int layer = 0;
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) load_chunk(a, c + 1, p0, ring + ((c + 1) % NSTAGE) * STAGE);
    tf32::commit();
    tf32::wait<1>();  // this thread's copies of chunk c have landed
    __syncthreads();  // and everyone's
    const float* st = ring + (c % NSTAGE) * STAGE;
    const Chunk ch = chunk_of(c, a.nxe, nx);
    const float* xs = st + WCH + ph * 16 * XS;
    if (ch.kind == 0)
      mma_chunk<4>(acc, Hs + ph * 16 * HS + ch.k0, HS, TP * HS, st, n0);
    else if (ch.kind == 1)
      mma_chunk<4>(acc, xs, XS, TP * XS, st, n0);
    else
      mma_chunk<1>(acc, xs, XS, TP * XS, st, n0);
    __syncthreads();  // stage c % NSTAGE and (at a layer's end) Hs are free
    const bool last = c == nx - 1 || c == l3x - HID / KC - 1 || c == l3x + nx - 1 ||
                      c == n_chunks - 1;
    if (!last) continue;
    if (layer < 3) {
      // bias + activation on the primal rows, act' times the tangent rows
      const float* bias = a.bias + layer * HID;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * j + 2 * t4 + e, pos = kpos(col);
          const float bc = bias[col];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int pt = ph * 16 + g8 + 8 * hf;
            float h, hp;
            act_pair(acc[0][j][2 * hf + e] + bc, a.act, a.w0, h, hp);
            Hs[pt * HS + pos] = h;
#pragma unroll
            for (int g = 1; g < 4; ++g) Hs[(g * TP + pt) * HS + pos] = hp * acc[g][j][2 * hf + e];
          }
        }
      }
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][j][e] = 0.f;
      ++layer;
      continue;
    }
    // layer 4's epilogue and the head: each thread's 8 rows (4 groups x 2
    // halves) against its 2 NJ columns, then the quad, then the NQ groups
    const float* bias = a.bias + 3 * HID;
    float part[4][2] = {};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + 8 * j + 2 * t4 + e;
        const float bc = bias[col], wc = a.w5[col];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float h, hp;
          act_pair(acc[0][j][2 * hf + e] + bc, a.act, a.w0, h, hp);
          part[0][hf] += h * wc;
#pragma unroll
          for (int g = 1; g < 4; ++g) part[g][hf] += hp * acc[g][j][2 * hf + e] * wc;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float s = part[g][hf];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (t4 == 0) red[(warp >> 1) * ROWS + g * TP + ph * 16 + g8 + 8 * hf] = s;
      }
    __syncthreads();
    if (t < ROWS) {
      float s = red[t];
#pragma unroll
      for (int q = 1; q < NQ; ++q) s += red[q * ROWS + t];
      const int g = t / TP, p = p0 + t % TP;
      if (p < a.P) {
        if (g == 0)
          a.df[p] = s + a.b5[0];
        else
          a.grad[size_t(p) * 3 + g - 1] = s;
      }
    }
  }
}

cudaError_t configure() {
  static bool set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && set[dev])) return err;
  err = cudaFuncSetAttribute(sdf_fused_x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(SMEM_BYTES));
  if (err == cudaSuccess && dev < 64) set[dev] = true;
  return err;
}

}  // namespace

// Launch geometry: threads per block, dynamic shared bytes per block and
// resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
SDF_NMPC_EXPORT int sdf_fused_x3_geometry(int* threads, int* smem, int* blocks_per_sm) {
  const cudaError_t err = configure();
  if (err != cudaSuccess) return int(err);
  *threads = NT;
  *smem = int(SMEM_BYTES);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, sdf_fused_x3_kernel,
                                                           NT, SMEM_BYTES));
}

SDF_NMPC_EXPORT int sdf_fused_x3_launch(const float* emb, const float* demb, const float* lat,
                                        const float* W, const float* bias, const float* w5,
                                        const float* b5, float* df, float* grad, int P, int nemb,
                                        int L, int nxe, int nxl, int act, float w0,
                                        cudaStream_t stream) {
  if (P <= 0 || nemb <= 0 || L < 0 || nxe * KC < nemb || nxl * KC < L || nxe <= 0 ||
      act < 0 || act > 2)
    return int(cudaErrorInvalidValue);
  const cudaError_t err = configure();
  if (err != cudaSuccess) return int(err);
  X3Args a{emb, demb, lat, W, bias, w5, b5, df, grad, P, nemb, L, nxe, nxl, act, w0};
  sdf_fused_x3_kernel<<<(P + TP - 1) / TP, NT, SMEM_BYTES, stream>>>(a);
  return int(cudaGetLastError());
}

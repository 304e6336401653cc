// NeuralDF value + position gradient on the bf16 tensor cores: the solver's
// sdf_fused_dtype modes 'bf16' and 'mixed'.
//
// Replaces: sdf_nmpc_tpu/ops/sdf_fused.py _kernel (:154) in its bf16 and
// mixed modes (:193-197).  The stacked rows are as in sdf_fused.cu:
// [primal; d/dx; d/dy; d/dz] through four dense layers, H = act(Z_p + b) and
// dH = act'(Z_p + b) * Z_t, the res='full' re-concat of the input rows for
// primal and tangent rows alike, then the head.
//
// Numerics, which ops/sdf_fused.py::sdf_value_grad_bf16_plain and
// ::sdf_value_grad_mixed_plain repeat:
//   - 'bf16': both operands of every product, the head's included, are
//     rounded to bf16 to nearest even (the rounding of JAX's astype): the
//     weights once on the host (ops/sdf_fused.py::_bf16_weights), the
//     activations and inputs as they are read into the fragments.  The
//     products run on mma.sync m16n8k16 bf16 with f32 results;
//   - 'mixed': the primal rows' products, head included, are IEEE f32 FMAs
//     on the CUDA cores (JAX's HIGHEST), the three tangent row groups' one
//     bf16 pass on the tensor cores, on weights rounded to bf16 on the host
//     (JAX casts them per use, with the same rounding);
//   - each 16-deep step of a tensor-core sum starts from zero and is added
//     to the f32 accumulator in IEEE f32, as in sdf_fused_x3.cu: the tensor
//     core's own additions truncate.  A bf16 product is exact in f32, so the
//     steps differ from the plain version's f32 matmul only in the order and
//     rounding of the sums;
//   - bias, activation and act' in IEEE f32; in 'mixed' act'(z_p) of a layer
//     scales that layer's tangent outputs, so the primal products (CUDA cores,
//     one mapping) and the tangent products (tensor cores, another) of a
//     layer meet in shared memory at a barrier.
//
// Bound on this card at the production widths (211 -> 256 -> 256 -> 467 ->
// 256 -> 256 -> 1; a tangent row's latent columns are zero): 'bf16' 3.35e11
// FLOP per B=8192, N=20 step, 0.34 ms at the 989 TFLOP/s dense bf16 peak,
// against 0.3 GB of inputs (0.09 ms at 3.35 TB/s): operations.  'mixed':
// the primal quarter, 1.0e11 FLOP at the 67 TFLOP/s FP32 peak, 1.49 ms, sets
// the bound; its tangents take 0.24 ms at the bf16 peak.
//
// Design: sdf_fused_x3.cu's tiling.  One 512-thread block (16 warps) per tile
// of TP = 32 points, 128 stacked rows.  The activations stay in shared memory
// in f32 (128 x 256, rows padded to 264 words: a lane's two k-adjacent
// fragment entries are one 8-byte load, free of bank conflicts) and are
// rounded to bf16 as they are read.  The weights of all four layers stream
// from L2 as one sequence of 16-row chunks through a ring of 2 stages filled
// by cp.async while the tensor cores work on the other stage: per column the
// 16 bf16 rows in the order 0 1 8 9 2 3 10 11 4 5 12 13 6 7 14 15, so that a
// lane's B fragment is one 8-byte load; 'mixed' streams beside them the f32
// chunk, row-major, for the primal FMAs.  The input rows (embedding, its
// tangents, latent) come through the same ring as 16-column f32 chunks, for
// layer 1 and again for layer 3's re-concat.  Warp w owns points 16 (w % 2)
// .. + 15 and columns 32 (w / 2) .. + 31, as one 16-row M tile per row group
// of the same 16 points (4 N tiles), so act' of an output sits in the same
// thread as the three tangent outputs it scales.  A tangent row's latent
// columns are zero, so latent chunks multiply the primal rows alone ('mixed':
// no tensor-core work at all).  'mixed''s primal FMAs run on ffma_tile.cuh's
// register tile in the same warps, over the same points and columns (lane l:
// 4 points l % 4 + 4 i, 4 columns 4 (l / 4) + e; see mixed_chunk), their
// 4-deep blocks interleaved with the tangent groups' mma.sync, and leave the
// layer's z_p in the primal rows of the activations for the epilogue.  The head
// reduces each warp's 32 columns with shuffles and the 8 column groups
// through shared memory.
//
// Shared memory per block: activations 135,168 B + 2 stages x (bf16 weights
// 8 KB, 'mixed' f32 weights 16 KB, inputs 128 x 24 words) + head partials
// 4,096 B: 180,224 B ('bf16') and 212,992 B ('mixed'), one block per SM.

#include "bf16.cuh"
#include "common.cuh"
#include "ffma_tile.cuh"
#include "tf32.cuh"  // tf32::copy16, copy4, commit, wait: the ring's cp.async copies

namespace {

constexpr int NT = 512;
constexpr int NQ = NT / 64;   // column groups: warps per point half
constexpr int NJ = 32 / NQ;   // 8-column N tiles per warp
constexpr int TP = 32;        // points per tile
constexpr int ROWS = 4 * TP;  // stacked rows per tile
constexpr int HID = 256;      // hidden width (layers are zero-padded to it)
constexpr int KC = 16;        // weight rows (and input columns) per chunk
constexpr int HS = HID + 8;   // activation row stride (words; 8 mod 32)
constexpr int XS = KC + 8;    // input-chunk row stride (8 mod 32)
constexpr int WB = HID * KC / 2;  // words of a bf16 weight chunk
constexpr int NSTAGE = 2;

template <bool MIXED>
struct Layout {
  static constexpr int WF = MIXED ? HID * KC : 0;  // words of the f32 weight chunk
  static constexpr int STAGE = WB + WF + ROWS * XS;
  static constexpr int WORDS = ROWS * HS + NSTAGE * STAGE + NQ * ROWS;
  static constexpr size_t BYTES = sizeof(float) * WORDS;
};

struct Bf16Args {
  const float *emb, *demb, *lat;  // (P, nemb), (P, 3, nemb), (P, L)
  const uint32_t* Wb;             // (n_chunks, WB): bf16 weight chunks, in order
  const float* Wf;                // (n_chunks, KC, HID) f32 ('mixed'), else null
  const float* bias;              // (4, HID)
  const float *w5, *w5r, *b5;     // head (HID,), the head rounded to bf16, (1,)
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
// the weight chunks as they lie in device memory, the input columns (if any)
// row-major with row stride XS.
template <bool MIXED>
__device__ __forceinline__ void load_chunk(const Bf16Args& a, int c, int p0, float* st) {
  const int t = threadIdx.x;
  const float* gw = reinterpret_cast<const float*>(a.Wb) + size_t(c) * WB;
#pragma unroll
  for (int i = 4 * t; i < WB; i += 4 * NT) tf32::copy16(st + i, gw + i);
  if constexpr (MIXED) {
    const float* gf = a.Wf + size_t(c) * Layout<true>::WF;
#pragma unroll
    for (int i = 4 * t; i < Layout<true>::WF; i += 4 * NT) tf32::copy16(st + WB + i, gf + i);
  }
  float* xs = st + WB + Layout<MIXED>::WF;
  const Chunk ch = chunk_of(c, a.nxe, a.nxe + a.nxl);
  if (ch.kind == 1) {
#pragma unroll
    for (int i = t; i < ROWS * KC; i += NT) {
      const int row = i / KC, col = i % KC;
      const int g = row / TP, p = p0 + row % TP, k = ch.k0 + col;
      const bool valid = p < a.P && k < a.nemb;
      const float* src = g == 0 ? a.emb + size_t(p) * a.nemb + k
                                : a.demb + (size_t(p) * 3 + g - 1) * a.nemb + k;
      tf32::copy4(xs + row * XS + col, valid ? src : a.emb, valid);
    }
  } else if (ch.kind == 2) {
#pragma unroll
    for (int i = t; i < TP * KC; i += NT) {
      const int row = i / KC, col = i % KC;
      const int p = p0 + row, k = ch.k0 + col;
      const bool valid = p < a.P && k < a.L;
      tf32::copy4(xs + row * XS + col, valid ? a.lat + size_t(p) * a.L + k : a.lat, valid);
    }
  }
}

// A lane's B fragments of the chunk's N tiles j (NJ of 8 columns from n0):
// the chunk wb holds per output column n 8 words: word 2t = rows (2t, 2t +
// 1), word 2t + 1 = rows (2t + 8, 2t + 9), so that a fragment is one 8-byte
// load.
__device__ __forceinline__ void load_b(uint32_t (&b)[NJ][2], const uint32_t* wb, int n0) {
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const uint2 v = *reinterpret_cast<const uint2*>(wb + (n0 + 8 * j + g8) * 8 + 2 * t4);
    b[j][0] = v.x;
    b[j][1] = v.y;
  }
}

// acc[g][j] += bf16(rows(g)) (16 x KC from A: group g at A + g * gstride,
// row stride lda) times the chunk's bf16 weight columns of N tile j (the
// fragments b), for the row groups G0 .. G0 + NG - 1.
template <int G0, int NG>
__device__ __forceinline__ void mma_groups(float (&acc)[4][NJ][4], const float* A, int lda,
                                           int gstride, const uint32_t (&b)[NJ][2]) {
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int g = G0; g < G0 + NG; ++g) {
    const float* r0 = A + g * gstride + g8 * lda + 2 * t4;
    const float2 x00 = *reinterpret_cast<const float2*>(r0);
    const float2 x10 = *reinterpret_cast<const float2*>(r0 + 8 * lda);
    const float2 x01 = *reinterpret_cast<const float2*>(r0 + 8);
    const float2 x11 = *reinterpret_cast<const float2*>(r0 + 8 * lda + 8);
    const uint32_t af[4] = {bf16::pack(x00.x, x00.y), bf16::pack(x10.x, x10.y),
                            bf16::pack(x01.x, x01.y), bf16::pack(x11.x, x11.y)};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float d[4];
      bf16::mma_zero(d, af, b[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][j][e] += d[e];
    }
  }
}

// 'bf16': the chunk's products of row groups G0 .. G0 + NG - 1.
template <int G0, int NG>
__device__ __forceinline__ void mma_chunk(float (&acc)[4][NJ][4], const float* A, int lda,
                                          int gstride, const uint32_t* wb, int n0) {
  uint32_t b[NJ][2];
  load_b(b, wb, n0);
  mma_groups<G0, NG>(acc, A, lda, gstride, b);
}

// 'mixed': the chunk's products of a warp (point half ph, columns n0 ..
// n0 + 31).  The primal rows' IEEE FMAs run on ffma_tile.cuh's tile: lane l
// owns points 16 ph + l % 4 + 4 i (i < 4) and columns n0 + 4 (l / 4) + e
// (e < 4), pacc[i][e], read as 16-byte loads: four k of a row (rows l % 4
// apart lie 8 banks apart at both strides, HS and XS) and four columns of
// the chunk's f32 weights (the warp's 32 columns, 128 contiguous bytes), 8
// shared-memory wavefronts per 64 FFMA warp-instructions.  With TANGENTS
// the three tangent row groups' bf16 mma.sync come between its 4-deep
// blocks, one group after each of the first three: measured on the H100
// 80GB HBM3 at 700 W (chip_smoke.py --sdf-builds), faster in each of six
// rounds than all FFMAs first (by 0.7-3.6%), with 24 B of spills against 44.
// src: the chunk's rows (row stride LDA, the primal rows first, group g at
// src + g TP LDA).
template <int LDA, bool TANGENTS>
__device__ __forceinline__ void mixed_chunk(float (&acc)[4][NJ][4], float (&pacc)[4][4],
                                            const float* src, const float* wf,
                                            const uint32_t* wb, int ph, int n0) {
  const int lane = threadIdx.x & 31;
  const ffma_tile::RowMajor<4, LDA, 4> rows{src + (ph * 16 + (lane & 3)) * LDA};
  const float* w = wf + n0 + 4 * (lane >> 2);
  static_assert(KC == 16, "four 4-deep blocks, three tangent groups between them");
  if constexpr (TANGENTS) {
    const float* tile = src + ph * 16 * LDA;
    uint32_t b[NJ][2];
    load_b(b, wb, n0);
    ffma_tile::block4<HID>(pacc, rows, w, 0);
    mma_groups<1, 1>(acc, tile, LDA, TP * LDA, b);
    ffma_tile::block4<HID>(pacc, rows, w, 4);
    mma_groups<2, 1>(acc, tile, LDA, TP * LDA, b);
    ffma_tile::block4<HID>(pacc, rows, w, 8);
    mma_groups<3, 1>(acc, tile, LDA, TP * LDA, b);
    ffma_tile::block4<HID>(pacc, rows, w, 12);
  } else {
    ffma_tile::chunk<KC, HID>(pacc, rows, w);
  }
}

template <bool MIXED>
__device__ __forceinline__ void run(const Bf16Args& a) {
  using Lay = Layout<MIXED>;
  extern __shared__ float4 smem4[];
  float* Hs = reinterpret_cast<float*>(smem4);  // ROWS x HS: activations
  float* ring = Hs + ROWS * HS;                 // NSTAGE x STAGE
  float* red = ring + NSTAGE * Lay::STAGE;      // NQ x ROWS: head partials
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g8 = lane >> 2, t4 = lane & 3;
  const int ph = warp & 1, n0 = (warp >> 1) * 8 * NJ;  // point half, first column
  const int p0 = blockIdx.x * TP;
  const int nx = a.nxe + a.nxl;
  const int l3x = nx + 2 * (HID / KC);
  const int n_chunks = l3x + nx + HID / KC;

  float acc[4][NJ][4];
  float pacc[4][4];  // 'mixed': primal rows (see mixed_chunk)
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) pacc[i][e] = 0.f;

  load_chunk<MIXED>(a, 0, p0, ring);
  tf32::commit();
  int layer = 0;
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) load_chunk<MIXED>(a, c + 1, p0, ring + ((c + 1) % NSTAGE) * Lay::STAGE);
    tf32::commit();
    tf32::wait<1>();  // this thread's copies of chunk c have landed
    __syncthreads();  // and everyone's
    const float* st = ring + (c % NSTAGE) * Lay::STAGE;
    const uint32_t* wb = reinterpret_cast<const uint32_t*>(st);
    const float* xs = st + WB + Lay::WF;
    const Chunk ch = chunk_of(c, a.nxe, nx);
    // the chunk's rows: activations, or the input chunk (both row-major)
    const float* src = ch.kind == 0 ? Hs + ch.k0 : xs;
    const int lda = ch.kind == 0 ? HS : XS;
    const float* tile = src + ph * 16 * lda;
    if constexpr (MIXED) {
      if (ch.kind == 0)
        mixed_chunk<HS, true>(acc, pacc, src, st + WB, wb, ph, n0);
      else if (ch.kind == 1)
        mixed_chunk<XS, true>(acc, pacc, src, st + WB, wb, ph, n0);
      else
        mixed_chunk<XS, false>(acc, pacc, src, st + WB, wb, ph, n0);
    } else {
      if (ch.kind != 2)
        mma_chunk<0, 4>(acc, tile, lda, TP * lda, wb, n0);
      else
        mma_chunk<0, 1>(acc, tile, lda, TP * lda, wb, n0);
    }
    __syncthreads();  // stage c % NSTAGE and (at a layer's end) Hs are free
    const bool last = c == nx - 1 || c == l3x - HID / KC - 1 || c == l3x + nx - 1 ||
                      c == n_chunks - 1;
    if (!last) continue;
    if constexpr (MIXED) {
      // z_p of the layer into the primal rows, where the epilogue reads it
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float4*>(Hs + (ph * 16 + (lane & 3) + 4 * i) * HS + n0 +
                                   4 * (lane >> 2)) =
            make_float4(pacc[i][0], pacc[i][1], pacc[i][2], pacc[i][3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) pacc[i][e] = 0.f;
      }
      __syncthreads();
    }
    // z_p of output (point pt, column col) of this thread, before the bias
    auto zp = [&](int j, int hf, int e, int pt, int col) {
      if constexpr (MIXED) return Hs[pt * HS + col];
      return acc[0][j][2 * hf + e];
    };
    if (layer < 3) {
      // bias + activation on the primal rows, act' times the tangent rows
      const float* bias = a.bias + layer * HID;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * j + 2 * t4 + e;
          const float bc = bias[col];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int pt = ph * 16 + g8 + 8 * hf;
            float h, hp;
            act_pair(zp(j, hf, e, pt, col) + bc, a.act, a.w0, h, hp);
            Hs[pt * HS + col] = h;
#pragma unroll
            for (int g = 1; g < 4; ++g) Hs[(g * TP + pt) * HS + col] = hp * acc[g][j][2 * hf + e];
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
    // halves) against its 2 NJ columns, then the quad, then the NQ groups.
    // The head's operands: 'bf16' both rounded to bf16; 'mixed' the primal
    // row in f32, the tangent rows rounded.
    const float* bias = a.bias + 3 * HID;
    float part[4][2] = {};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + 8 * j + 2 * t4 + e;
        const float bc = bias[col], wr = a.w5r[col];
        const float wp = MIXED ? a.w5[col] : wr;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int pt = ph * 16 + g8 + 8 * hf;
          float h, hp;
          act_pair(zp(j, hf, e, pt, col) + bc, a.act, a.w0, h, hp);
          part[0][hf] += (MIXED ? h : bf16::rn(h)) * wp;
#pragma unroll
          for (int g = 1; g < 4; ++g) part[g][hf] += bf16::rn(hp * acc[g][j][2 * hf + e]) * wr;
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

__global__ void __launch_bounds__(NT, 1) sdf_fused_bf16_kernel(Bf16Args a) { run<false>(a); }

__global__ void __launch_bounds__(NT, 1) sdf_fused_mixed_kernel(Bf16Args a) { run<true>(a); }

template <class K>
cudaError_t configure(K kernel, size_t bytes, bool (&set)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && set[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err == cudaSuccess && dev < 64) set[dev] = true;
  return err;
}

cudaError_t configure(bool mixed) {
  static bool set_bf16[64] = {}, set_mixed[64] = {};
  return mixed ? configure(sdf_fused_mixed_kernel, Layout<true>::BYTES, set_mixed)
               : configure(sdf_fused_bf16_kernel, Layout<false>::BYTES, set_bf16);
}

}  // namespace

// Launch geometry of the 'bf16' (mixed = 0) or 'mixed' kernel: threads per
// block, dynamic shared bytes per block and resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
SDF_NMPC_EXPORT int sdf_fused_bf16_geometry(int mixed, int* threads, int* smem,
                                            int* blocks_per_sm) {
  const cudaError_t err = configure(mixed != 0);
  if (err != cudaSuccess) return int(err);
  *threads = NT;
  if (mixed) {
    *smem = int(Layout<true>::BYTES);
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, sdf_fused_mixed_kernel, NT, Layout<true>::BYTES));
  }
  *smem = int(Layout<false>::BYTES);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, sdf_fused_bf16_kernel,
                                                           NT, Layout<false>::BYTES));
}

SDF_NMPC_EXPORT int sdf_fused_bf16_launch(const float* emb, const float* demb, const float* lat,
                                          const void* Wb, const float* Wf, const float* bias,
                                          const float* w5, const float* w5r, const float* b5,
                                          float* df, float* grad, int P, int nemb, int L, int nxe,
                                          int nxl, int mixed, int act, float w0,
                                          cudaStream_t stream) {
  if (P <= 0 || nemb <= 0 || L < 0 || nxe * KC < nemb || nxl * KC < L || nxe <= 0 ||
      act < 0 || act > 2 || (mixed && Wf == nullptr))
    return int(cudaErrorInvalidValue);
  const cudaError_t err = configure(mixed != 0);
  if (err != cudaSuccess) return int(err);
  Bf16Args a{emb, demb, lat, static_cast<const uint32_t*>(Wb), Wf, bias, w5, w5r, b5,
             df, grad, P, nemb, L, nxe, nxl, act, w0};
  const int grid = (P + TP - 1) / TP;
  if (mixed)
    sdf_fused_mixed_kernel<<<grid, NT, Layout<true>::BYTES, stream>>>(a);
  else
    sdf_fused_bf16_kernel<<<grid, NT, Layout<false>::BYTES, stream>>>(a);
  return int(cudaGetLastError());
}

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
//     activations as the epilogue stores them, the inputs as they are
//     staged.  The products run on mma.sync m16n8k16 bf16 with
//     f32 results;
//   - 'mixed': the primal rows' products, head included, are IEEE f32 FMAs
//     on the CUDA cores (JAX's HIGHEST), the three tangent row groups' one
//     bf16 pass on the tensor cores, on weights rounded to bf16 on the host
//     (JAX casts them per use, with the same rounding);
//   - each 16-deep step of a tensor-core sum starts from zero and is added
//     to the f32 accumulator in IEEE f32, in k order, as in sdf_fused_x3.cu:
//     the tensor core's own additions truncate.  A bf16 product is exact in
//     f32, so the steps differ from the plain version's f32 matmul only in
//     the order and rounding of the sums;
//   - bias, activation and act' in IEEE f32; act'(z_p) of a layer scales
//     that layer's tangent outputs.
// The first design (x3's tiling) kept the activations and inputs in f32 and
// rounded them at every read; a stored bf16(h), bf16(act' z_t) or bf16(x)
// is the same rounding of the same f32 value, and every sum keeps its order,
// so the outputs of both modes equal the first design's bit for bit.
//
// Bound on this card at the production widths (211 -> 256 -> 256 -> 467 ->
// 256 -> 256 -> 1; a tangent row's latent columns are zero): 'bf16' 3.35e11
// FLOP per B=8192, N=20 step, 0.34 ms at the 989 TFLOP/s dense bf16 peak,
// against 0.3 GB of inputs (0.09 ms at 3.35 TB/s): operations.  'mixed':
// the primal quarter, 1.0e11 FLOP at the 67 TFLOP/s FP32 peak, 1.49 ms, sets
// the bound; its tangents take 0.24 ms at the bf16 peak.  Fixed costs beside
// the bound: the IEEE f32 add of every 16-deep step's 4 results per lane is
// 1.05e10 FADDs per step ('bf16'; 'mixed' three quarters of it), 0.31 ms of
// the FP32 pipe at its peak, issued by the same warps as the mma.sync (a
// lane's 16 mma.sync of a step come with 64 FADDs); the design spends
// nothing else per product: one ldmatrix.x4 per 16 x 16 A fragment, one
// 8-byte load per B fragment pair, no conversion in the loop.
//
// Design.
//   - Weights: the four layers' weights as one sequence of 16-row chunks
//     (layer 1: the input chunks, embedding then latent; 2: 16; 3: 16 then
//     the input chunks again; 4: 16), per column the 16 bf16 rows in the
//     order 0 1 8 9 2 3 10 11 4 5 12 13 6 7 14 15, so that a lane's B
//     fragment pair is one 8-byte load; 'mixed' has beside them the f32
//     chunks, row-major, for the primal FMAs.  A stage of the ring holds CPS
//     consecutive chunks of one segment (a layer's input or activation
//     chunks); thread 0 has the TMA engine copy a stage (cp.async.bulk, one
//     per array) onto the stage's mbarrier, NSTAGE - 1 stages ahead, and one
//     block barrier per stage frees the slot it refills.
//   - Inputs: the tile's rows of embedding, tangents and latent are each one
//     contiguous block of device memory; three bulk copies stage them (in
//     the activations' space, still empty in layer 1), and one pass rounds
//     them into resident input rows, zero-padded per chunk: bf16 ('mixed':
//     the primal rows f32), read by layers 1 and 3.  Rows the bulk copies
//     cannot take (the last tile's, an array off 16-byte alignment) are read
//     from device memory in that pass.
//   - Activations: in shared memory as bf16, rows of 256 padded to 264 (528
//     B: 33 16-byte units, so that ldmatrix's 8-row phases are free of bank
//     conflicts; the input rows likewise, 2 (16 nx) + 1 units); 'mixed' keeps
//     its primal rows in f32 (264 words) for the FMAs.
//   - 'bf16': one block of NT = 16 TP threads per tile of TP points (4 TP
//     stacked rows); warp w owns points 16 (w % (TP / 16)) .. + 15 of all
//     four row groups and columns 32 (w / (TP / 16)) .. + 31 (4 N tiles): 16
//     mma.sync per 16-deep step, and act' of an output sits in the same
//     thread as the three tangent outputs it scales.  A latent chunk
//     multiplies the primal rows alone (a tangent row's latent columns are
//     zero).
//   - 'mixed': the warps split by role, so that the FP32 pipe (the primal
//     FMAs) and the tensor pipe (the tangent mma.sync) run at once on the
//     same stage.  8 (TP / 16) tangent warps run the 'bf16' mapping on the
//     three tangent groups alone (12 mma.sync per step, 48 accumulators);
//     4 (TP / 16) primal warps run ffma_tile.cuh's tile on the f32 primal
//     rows: warp v owns points 16 (v % (TP / 16)) .. + 15 and columns
//     64 (v / (TP / 16)) .. + 63, lane l 4 points l % 4 + 4 i and 8 columns
//     4 (l / 4) + e + 32 q (32 accumulators).  They meet at the layer's end:
//     the primal warps store z_p in the primal rows, and after a barrier the
//     tangent warps take act(z_p + b) and act'(z_p + b) for each of their
//     outputs, write h over z_p and act' z_t into the tangent rows, and in
//     layer 4 form the head.
//   - The head: each thread's rows against its columns, the quad by
//     shuffles, then the 8 groups of 32 columns through shared memory, in
//     the first design's order.
//
// Shared memory per block at the production widths: 'bf16' (TP 16, CPS 2, 3
// stages) 100,416 B, two blocks per SM; 'mixed' (TP 32, CPS 1, 3 stages, 768
// threads) 207,936 B, one block per SM.  Wider inputs take more (the launch
// refuses more than the 227 KB a block may have).
//
// Measured (chip_smoke.py --sdf-builds, one B=8192 steady step's launch, H100
// 80GB HBM3 at 700 W): 'bf16' 3.15-3.42 ms, 'mixed' 6.26-6.58, against
// 4.53-4.71 and 7.71-7.79 for the first design in the same call; the outputs
// equal its bits.  Measured and dropped on the way (PERF.md section 6): the
// input columns by 4-byte cp.async through the ring (2,048 copies per block
// and input stage; a third of each thread's time, 3.8 ms), clusters of 2 or 4
// blocks sharing each weight stage by TMA multicast (4.7 and 5.0 ms: the
// cross-block release of a slot costs more than the L2 reads it saves), 32
// points on 512 threads (4.1-4.4 ms), and for 'mixed' every warp doing both
// kinds of work (7.6 ms at 32 points, 6.8 at 16).

#include "async_copy.cuh"
#include "bf16.cuh"
#include "common.cuh"
#include "ffma_tile.cuh"

namespace {

constexpr int HID = 256;          // hidden width (layers are zero-padded to it)
constexpr int KC = 16;            // weight rows (and input columns) per chunk
constexpr int NQ = HID / 32;      // column groups of the head's sums
constexpr int NJ = 4;             // 8-column N tiles per mma warp
constexpr int HSB = HID + 8;      // bf16 activation row stride (elements)
constexpr int HSF = HID + 8;      // f32 primal row stride ('mixed'; words, 8 mod 32)
constexpr int WB = HID * KC / 2;  // words of a bf16 weight chunk
constexpr int WF = HID * KC;      // words of an f32 weight chunk ('mixed')

// points per tile, chunks per stage, stages, __launch_bounds__' blocks per SM
template <bool MIXED>
struct Cfg;
template <>
struct Cfg<false> {
  static constexpr int TP = 16, CPS = 2, NSTAGE = 3, MINB = 2;
};
template <>
struct Cfg<true> {
  static constexpr int TP = 32, CPS = 1, NSTAGE = 3, MINB = 1;
};

template <bool MIXED>
struct Layout {
  static constexpr int TP = Cfg<MIXED>::TP, CPS = Cfg<MIXED>::CPS;
  static constexpr int NSTAGE = Cfg<MIXED>::NSTAGE;
  static constexpr int PH = TP / 16;              // 16-point halves of the tile
  static constexpr int ROWS = 4 * TP;             // stacked rows
  static constexpr int NMW = 8 * PH;              // mma warps ('mixed': tangent)
  static constexpr int NPW = MIXED ? 4 * PH : 0;  // primal FMA warps
  static constexpr int NT = 32 * (NMW + NPW);
  static constexpr int G0 = MIXED ? 1 : 0;         // first row group in bf16 rows
  static constexpr int BROWS = (4 - G0) * TP;      // bf16 activation rows
  static constexpr int HB_WORDS = BROWS * HSB / 2;
  static constexpr int H_WORDS = HB_WORDS + (MIXED ? TP * HSF : 0);
  static constexpr int STAGE = CPS * (WB + (MIXED ? WF : 0));  // weight words of a stage
  // after the ring its mbarriers, 8 bytes each: one per stage, one for the
  // inputs (then 16-byte aligned for the input rows)
  static constexpr int FIXED = (H_WORDS + NSTAGE * STAGE + 2 * (NSTAGE + 1) + 3) / 4 * 4;
  static_assert(NSTAGE >= 2 && NSTAGE * STAGE >= NQ * ROWS, "the head's sums reuse the ring");
};

// The tile's input rows, resident for layers 1 and 3 after the activations,
// the ring and its mbarriers: the primal rows [embedding | latent], each part
// zero-padded to its chunks (XP = 16 nx + 8: bf16 elements, 'mixed' f32
// words), then the three tangent rows' embedding, bf16 (XT = 16 nxe + 8).  A
// row stride of an odd number of 16-byte units keeps ldmatrix free of bank
// conflicts, and of 8 mod 32 words the f32 rows' 16-byte loads.  They are
// staged by the TMA engine as the device arrays lie (TP rows of embedding,
// of its tangents, of latent: contiguous blocks) in the activations' space,
// or past the input rows where they do not fit there.
template <bool MIXED>
struct Inputs {
  int XP, XT, xp_words, words, raw, raw_words, bytes;
  __device__ __host__ Inputs(int nemb, int L, int nxe, int nxl) {
    using Lay = Layout<MIXED>;
    XP = 16 * (nxe + nxl) + 8;
    XT = 16 * nxe + 8;
    xp_words = MIXED ? Lay::TP * XP : Lay::TP * XP / 2;
    words = xp_words + 3 * Lay::TP * XT / 2;
    raw_words = Lay::TP * (4 * nemb + L);
    raw = raw_words <= Lay::H_WORDS ? 0 : Lay::FIXED + words;
    bytes = int(sizeof(float)) * (Lay::FIXED + words + (raw ? raw_words : 0));
  }
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

// Stage s of the ring: chunks [c0, c0 + n) of one segment (layer 1's inputs,
// layer 2, layer 3's activation chunks, layer 3's inputs, layer 4), CPS a
// stage, the last one of a segment possibly fewer; last: it ends a layer.
struct Stage {
  int c0, n;
  bool last;
};

template <int CPS>
__device__ __forceinline__ Stage stage_of(int s, int nx) {
  const int len[5] = {nx, HID / KC, HID / KC, nx, HID / KC};
  int c0 = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int ns = (len[i] + CPS - 1) / CPS;
    if (s < ns) return {c0 + s * CPS, min(CPS, len[i] - s * CPS), i != 2 && s == ns - 1};
    s -= ns;
    c0 += len[i];
  }
  return {c0, 0, false};
}

template <int CPS>
__device__ __forceinline__ int n_stages(int nx) {
  return 2 * ((nx + CPS - 1) / CPS) + 3 * ((HID / KC + CPS - 1) / CPS);
}

// Start the weight copies of stage s into ring slot st (nothing past the
// last stage): thread 0 arms the slot's mbarrier full for the weight bytes
// and has the TMA engine copy the weight chunks, as they lie in device
// memory, into the slot.
template <bool MIXED>
__device__ __forceinline__ void load_weights(const Bf16Args& a, int s, float* st,
                                             uint64_t* full) {
  using Lay = Layout<MIXED>;
  if (threadIdx.x != 0 || s >= n_stages<Lay::CPS>(a.nxe + a.nxl)) return;
  const Stage sg = stage_of<Lay::CPS>(s, a.nxe + a.nxl);
  const unsigned wb = sg.n * WB * 4, wf = MIXED ? sg.n * WF * 4 : 0;
  uint64_t* bar = full + s % Lay::NSTAGE;
  acp::mbar_expect_tx(bar, wb + wf);
  acp::bulk_copy(st, reinterpret_cast<const float*>(a.Wb) + size_t(sg.c0) * WB, wb, bar);
  if (MIXED) acp::bulk_copy(st + Lay::CPS * WB, a.Wf + size_t(sg.c0) * WF, wf, bar);
}

// Stage the tile's inputs (thread 0: three bulk copies of whole rows, as
// many rows as keep each copy a multiple of 16 bytes) and, once they have
// landed, every thread rounds its share into the resident input rows; a row
// the copies left out (the last tile's, or every row where an array is not
// 16-byte aligned) is read from device memory, a padding column or point is
// zero.
template <bool MIXED>
__device__ __forceinline__ void load_inputs(const Bf16Args& a, const Inputs<MIXED>& in, int p0,
                                            float* sm, uint64_t* bar) {
  using Lay = Layout<MIXED>;
  constexpr int TP = Lay::TP;
  const int np = min(TP, a.P - p0);
  auto rows16 = [&](const float* base) {  // rows a bulk copy takes: whole 16-byte units
    return (reinterpret_cast<size_t>(base) & 15) == 0 ? np / 4 * 4 : 0;
  };
  const int ne = rows16(a.emb), nd = rows16(a.demb), nl = rows16(a.lat);
  float* raw = sm + in.raw;
  float* r_emb = raw;
  float* r_demb = r_emb + TP * a.nemb;
  float* r_lat = r_demb + 3 * TP * a.nemb;
  if (threadIdx.x == 0) {
    const unsigned be = ne * a.nemb * 4, bd = nd * 3 * a.nemb * 4, bl = nl * a.L * 4;
    acp::mbar_expect_tx(bar, be + bd + bl);
    if (be) acp::bulk_copy(r_emb, a.emb + size_t(p0) * a.nemb, be, bar);
    if (bd) acp::bulk_copy(r_demb, a.demb + size_t(p0) * 3 * a.nemb, bd, bar);
    if (bl) acp::bulk_copy(r_lat, a.lat + size_t(p0) * a.L, bl, bar);
  }
  acp::mbar_wait(bar, 0);
  uint16_t* xb = reinterpret_cast<uint16_t*>(sm + Lay::FIXED);  // bf16 rows
  float* xf = sm + Lay::FIXED;                                  // 'mixed': f32 primal rows
  uint16_t* xt = reinterpret_cast<uint16_t*>(sm + Lay::FIXED + in.xp_words);
  const int ke = 16 * a.nxe;
  for (int e = threadIdx.x; e < TP * in.XP; e += Lay::NT) {  // primal rows
    const int p = e / in.XP, j = e % in.XP;
    float x = 0.f;
    if (p < np && j < ke && j < a.nemb)
      x = p < ne ? r_emb[p * a.nemb + j] : __ldg(a.emb + size_t(p0 + p) * a.nemb + j);
    else if (p < np && j >= ke && j - ke < a.L)
      x = p < nl ? r_lat[p * a.L + j - ke] : __ldg(a.lat + size_t(p0 + p) * a.L + j - ke);
    if constexpr (MIXED)
      xf[e] = x;
    else
      xb[e] = bf16::bits16(x);
  }
  for (int e = threadIdx.x; e < 3 * TP * in.XT; e += Lay::NT) {  // tangent rows
    const int r = e / in.XT, j = e % in.XT, g = r / TP, p = r % TP;
    float x = 0.f;
    if (p < np && j < a.nemb)
      x = p < nd ? r_demb[(p * 3 + g) * a.nemb + j]
                 : __ldg(a.demb + (size_t(p0 + p) * 3 + g) * a.nemb + j);
    xt[e] = bf16::bits16(x);
  }
}

// A lane's B fragments of the chunk's N tiles j (NJ of 8 columns from n0):
// the chunk wb holds per output column n 8 words: word 2t = rows (2t, 2t +
// 1), word 2t + 1 = rows (2t + 8, 2t + 9), so that a fragment pair is one
// 8-byte load (a warp's: 256 contiguous bytes).
__device__ __forceinline__ void load_b(uint32_t (&b)[NJ][2], const uint32_t* wb, int n0) {
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const uint2 v = *reinterpret_cast<const uint2*>(wb + (n0 + 8 * j + g8) * 8 + 2 * t4);
    b[j][0] = v.x;
    b[j][1] = v.y;
  }
}

// acc[j] += A (16 x 16 bf16 fragment af) times the chunk's N tile j, each
// 16-deep product from zero, added in IEEE f32.
__device__ __forceinline__ void mma_add(float (&acc)[NJ][4], const uint32_t (&af)[4],
                                        const uint32_t (&b)[NJ][2]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float d[4];
    bf16::mma_zero(d, af, b[j]);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += d[e];
  }
}

// The A fragment of 16 bf16 rows (row stride ld elements) at 16 columns from
// rows: lane l gives row l % 16's columns 8 (l / 16) .. + 7.
__device__ __forceinline__ void frag(uint32_t (&af)[4], const uint16_t* rows, int ld) {
  const int lane = threadIdx.x & 31;
  bf16::ldsm_x4(af, rows + (lane & 15) * ld + 8 * (lane >> 4));
}

// The roles of a thread: ALL ('bf16': every warp runs the mma on the four
// row groups), PRIMAL and TANGENT ('mixed').
enum Role { ALL, PRIMAL, TANGENT };

// One tile: the stage loop, the epilogues and the head, as the role's share.
// Every role meets the same barriers in the same order.
template <bool MIXED, int ROLE>
__device__ __forceinline__ void run(const Bf16Args& a) {
  using Lay = Layout<MIXED>;
  constexpr int TP = Lay::TP, CPS = Lay::CPS, NSTAGE = Lay::NSTAGE;
  constexpr int G0 = Lay::G0;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  uint16_t* Hb = reinterpret_cast<uint16_t*>(sm);  // BROWS x HSB bf16: row (g - G0) TP + p
  float* Hp = sm + Lay::HB_WORDS;                  // 'mixed': TP x HSF f32 primal rows
  float* ring = sm + Lay::H_WORDS;                 // NSTAGE x STAGE
  float* red = ring;                               // NQ x ROWS: the head's sums, at the end
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NSTAGE * Lay::STAGE);  // one per stage
  uint64_t* in_bar = full + NSTAGE;                 // the inputs' bulk copies
  const Inputs<MIXED> in(a.nemb, a.L, a.nxe, a.nxl);
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(sm + Lay::FIXED);  // bf16 primal rows
  const float* xf = sm + Lay::FIXED;                // 'mixed': f32 primal rows
  const uint16_t* xt = reinterpret_cast<const uint16_t*>(sm + Lay::FIXED + in.xp_words);
  const int t = threadIdx.x, lane = t & 31, g8 = lane >> 2, t4 = lane & 3;
  const int w = (t >> 5) - (ROLE == TANGENT ? Lay::NPW : 0);  // warp index within the role
  const int ph = w % Lay::PH;                                  // 16-point half
  const int n0 = (ROLE == PRIMAL ? 64 : 32) * (w / Lay::PH);  // first column
  const int p0 = blockIdx.x * TP;
  const int nx = a.nxe + a.nxl;
  const int ns = n_stages<CPS>(nx);

  float acc[4][NJ][4];  // ALL, TANGENT: row group g, N tile j
  float pacc[4][8];     // PRIMAL: points l % 4 + 4 i, columns 4 (l / 4) + e + 32 q
  auto zero_acc = [&] {
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][j][e] = 0.f;
  };
  auto zero_pacc = [&] {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) pacc[i][e] = 0.f;
  };
  zero_acc();
  zero_pacc();

  if (t == 0) {
#pragma unroll
    for (int k = 0; k <= NSTAGE; ++k) acp::mbar_init(full + k, 1);  // and in_bar
    acp::fence_mbar_init();
  }
  __syncthreads();
#pragma unroll 1
  for (int s = 0; s < NSTAGE - 1; ++s) load_weights<MIXED>(a, s, ring + s * Lay::STAGE, full);
  load_inputs<MIXED>(a, in, p0, sm, in_bar);
  int layer = 0;
#pragma unroll 1
  for (int s = 0; s < ns; ++s) {
    acp::mbar_wait(full + s % NSTAGE, (s / NSTAGE) & 1);  // stage s's weights have landed
    __syncthreads();  // the input rows are in, and stage s - 1's slot is free in this block
    load_weights<MIXED>(a, s + NSTAGE - 1, ring + ((s + NSTAGE - 1) % NSTAGE) * Lay::STAGE, full);
    const float* st = ring + (s % NSTAGE) * Lay::STAGE;
    const Stage sg = stage_of<CPS>(s, nx);
#pragma unroll 1
    for (int i = 0; i < sg.n; ++i) {
      const Chunk ch = chunk_of(sg.c0 + i, a.nxe, nx);
      const int xc = ch.kind == 1 ? ch.k0 : 16 * a.nxe + ch.k0;  // its column of the input rows
      const float* wf = st + CPS * WB + i * WF + n0 + 4 * (lane >> 2);
      const int r0 = ph * 16 + (lane & 3);  // the lane's first primal row
      // the A fragment of row group g's 16 points at the chunk's columns
      auto a_frag = [&](uint32_t(&af)[4], int g) {
        if (ch.kind == 0)
          frag(af, Hb + ((g - G0) * TP + ph * 16) * HSB + ch.k0, HSB);
        else if (g == 0)
          frag(af, xb + ph * 16 * in.XP + xc, in.XP);
        else
          frag(af, xt + ((g - 1) * TP + ph * 16) * in.XT + ch.k0, in.XT);
      };
      if constexpr (ROLE == PRIMAL) {
        if (ch.kind == 0)
          ffma_tile::chunk<KC, HID>(pacc, ffma_tile::RowMajor<4, HSF, 4>{Hp + r0 * HSF + ch.k0},
                                    wf);
        else
          ffma_tile::chunk<KC, HID>(pacc, ffma_tile::RowMajorDyn<4, 4>{xf + r0 * in.XP + xc, in.XP},
                                    wf);
      } else {
        if (MIXED && ch.kind == 2) continue;  // latent columns: primal rows only
        uint32_t b[NJ][2];
        load_b(b, reinterpret_cast<const uint32_t*>(st) + i * WB, n0);
        const int g1 = ch.kind == 2 ? 1 : 4;  // row groups G0 .. g1 - 1
#pragma unroll
        for (int g = G0; g < 4; ++g) {
          if (g >= g1) break;
          uint32_t af[4];
          a_frag(af, g);
          mma_add(acc[g], af, b);
        }
      }
    }
    if (!sg.last) continue;
    __syncthreads();  // every read of this layer's rows is done
    if constexpr (MIXED) {
      if constexpr (ROLE == PRIMAL) {  // z_p of the layer into the primal rows
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            *reinterpret_cast<float4*>(Hp + (ph * 16 + (lane & 3) + 4 * i) * HSF + n0 +
                                       4 * (lane >> 2) + 32 * q) =
                make_float4(pacc[i][4 * q], pacc[i][4 * q + 1], pacc[i][4 * q + 2],
                            pacc[i][4 * q + 3]);
        zero_pacc();
      }
      __syncthreads();
    }
    // z_p of output (point pt, column col) of this thread, before the bias
    auto zp = [&](int j, int hf, int e, int pt, int col) {
      if constexpr (MIXED) return Hp[pt * HSF + col];
      return acc[0][j][2 * hf + e];
    };
    if (layer < 3) {
      // bias + activation on the primal rows, act' times the tangent rows
      if constexpr (ROLE != PRIMAL) {
        const float* bias = a.bias + layer * HID;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = n0 + 8 * j + 2 * t4;
          const float bc[2] = {bias[col], bias[col + 1]};
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int pt = ph * 16 + g8 + 8 * hf;
            float h[2], hp[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) act_pair(zp(j, hf, e, pt, col + e) + bc[e], a.act, a.w0,
                                                 h[e], hp[e]);
            if constexpr (MIXED) {
              Hp[pt * HSF + col] = h[0];
              Hp[pt * HSF + col + 1] = h[1];
            } else {
              *reinterpret_cast<uint32_t*>(Hb + pt * HSB + col) = bf16::pack(h[0], h[1]);
            }
#pragma unroll
            for (int g = 1; g < 4; ++g)
              *reinterpret_cast<uint32_t*>(Hb + ((g - G0) * TP + pt) * HSB + col) =
                  bf16::pack(hp[0] * acc[g][j][2 * hf], hp[1] * acc[g][j][2 * hf + 1]);
          }
        }
        zero_acc();
      }
      ++layer;
      continue;
    }
    // layer 4's epilogue and the head: each thread's 8 rows (4 groups x 2
    // halves) against its 2 NJ columns, then the quad, then the NQ groups.
    // The head's operands: 'bf16' both rounded to bf16; 'mixed' the primal
    // row in f32, the tangent rows rounded.
    if constexpr (ROLE != PRIMAL) {
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
          float v = part[g][hf];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (t4 == 0) red[(n0 / 32) * Lay::ROWS + g * TP + ph * 16 + g8 + 8 * hf] = v;
        }
    }
    __syncthreads();
    if (t < Lay::ROWS) {
      float v = red[t];
#pragma unroll
      for (int q = 1; q < NQ; ++q) v += red[q * Lay::ROWS + t];
      const int g = t / TP, p = p0 + t % TP;
      if (p < a.P) {
        if (g == 0)
          a.df[p] = v + a.b5[0];
        else
          a.grad[size_t(p) * 3 + g - 1] = v;
      }
    }
  }
}

__global__ void __launch_bounds__(Layout<false>::NT, Cfg<false>::MINB)
    sdf_fused_bf16_kernel(Bf16Args a) {
  run<false, ALL>(a);
}

__global__ void __launch_bounds__(Layout<true>::NT, Cfg<true>::MINB)
    sdf_fused_mixed_kernel(Bf16Args a) {
  if (int(threadIdx.x) < 32 * Layout<true>::NPW)
    run<true, PRIMAL>(a);
  else
    run<true, TANGENT>(a);
}

// The most dynamic shared memory a block may opt in to on sm_90 (227 KB): the
// kernels' share of it grows with the input widths.
constexpr int MAX_SMEM = 232448;

template <class K>
cudaError_t configure(K kernel, bool (&set)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && set[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err == cudaSuccess && dev < 64) set[dev] = true;
  return err;
}

cudaError_t configure(bool mixed) {
  static bool set_bf16[64] = {}, set_mixed[64] = {};
  return mixed ? configure(sdf_fused_mixed_kernel, set_mixed)
               : configure(sdf_fused_bf16_kernel, set_bf16);
}

int chunks(int width) { return (width + KC - 1) / KC; }

}  // namespace

// Launch geometry of the 'bf16' (mixed = 0) or 'mixed' kernel for a network
// with nemb embedding and L latent columns: threads per block, dynamic
// shared bytes per block and resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
SDF_NMPC_EXPORT int sdf_fused_bf16_geometry(int mixed, int nemb, int L, int* threads, int* smem,
                                            int* blocks_per_sm) {
  const cudaError_t err = configure(mixed != 0);
  if (err != cudaSuccess) return int(err);
  if (mixed) {
    *threads = Layout<true>::NT;
    *smem = Inputs<true>(nemb, L, chunks(nemb), chunks(L)).bytes;
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, sdf_fused_mixed_kernel,
                                                             Layout<true>::NT, *smem));
  }
  *threads = Layout<false>::NT;
  *smem = Inputs<false>(nemb, L, chunks(nemb), chunks(L)).bytes;
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, sdf_fused_bf16_kernel,
                                                           Layout<false>::NT, *smem));
}

SDF_NMPC_EXPORT int sdf_fused_bf16_launch(const float* emb, const float* demb, const float* lat,
                                          const void* Wb, const float* Wf, const float* bias,
                                          const float* w5, const float* w5r, const float* b5,
                                          float* df, float* grad, int P, int nemb, int L, int nxe,
                                          int nxl, int mixed, int act, float w0,
                                          cudaStream_t stream) {
  const int bytes = mixed ? Inputs<true>(nemb, L, nxe, nxl).bytes
                          : Inputs<false>(nemb, L, nxe, nxl).bytes;
  if (P <= 0 || nemb <= 0 || L < 0 || nxe * KC < nemb || nxl * KC < L || nxe <= 0 ||
      act < 0 || act > 2 || (mixed && Wf == nullptr) || bytes > MAX_SMEM)
    return int(cudaErrorInvalidValue);
  const cudaError_t err = configure(mixed != 0);
  if (err != cudaSuccess) return int(err);
  Bf16Args a{emb, demb, lat, static_cast<const uint32_t*>(Wb), Wf, bias, w5, w5r, b5,
             df, grad, P, nemb, L, nxe, nxl, act, w0};
  using M = Layout<true>;
  using B = Layout<false>;
  if (mixed)
    sdf_fused_mixed_kernel<<<(P + M::TP - 1) / M::TP, M::NT, bytes, stream>>>(a);
  else
    sdf_fused_bf16_kernel<<<(P + B::TP - 1) / B::TP, B::NT, bytes, stream>>>(a);
  return int(cudaGetLastError());
}

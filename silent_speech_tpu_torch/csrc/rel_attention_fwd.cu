// Relative-position attention forward for Hopper (sm_90a), float32, with
// the probability dropout of training: one kernel whose three band products
// are register-tiled FP32 FMA on the CUDA cores (no TF32, no tensor cores).
//
// Replaces, for float32 inputs, the forward of the TPU kernel
// `fused_rel_attention` (silent_speech_tpu/ops/pallas/rel_attention.py,
// `_fwd` -> pl.pallas_call at :386, body `_fwd_kernel` at :251); bfloat16
// inputs, the training step's and serving's, run rel_attention_fwd_wmma.cu
// on the tensor cores. For query q and key k of one (batch b, head h),
// scale = 1/sqrt(d_h):
//
//   s[q,k] = (q.k) * scale + q . E_h[k - q + m - 1]
//            when |k - q| <= m - 1 and (k < L) == (q < L), else masked
//   P[q]   = softmax_k(s[q, :])                 (row max subtracted)
//   P'     = P * keep * drop_scale,  keep = hash(q, k, cell) >= t
//            (the cell of rel_attention.cuh)
//   O[q]   = P'[q] . V
//
// L is the utterance's valid length inside a bucket-padded sequence (serving;
// L == T in training). t = 0 turns dropout off. The hash is the one the JAX
// kernel runs off the TPU, so the mask is bit-identical to the JAX kernel's
// in interpret mode and to the plain PyTorch version.
//
// Design: the backward's stage A (rel_attention_bwd.cu) up to the softmax,
// then P'.V, on the band machinery of f32_band.cuh. One CTA of 256 threads
// per (32-query tile, h, b). The tile sees the keys [kb, kb + nb): kb is
// its first visible key rounded down to 16 and nb = band_cols(T, m), at
// most round16(32 + 2(m-1) + 15) whatever T is. In order:
//   1. R = Q.E^T over the slots [r_lo, r_hi) that the tile reaches, by
//      band_product in panels of NCOLS = 256 slots; each slot's value goes
//      onto its band cell of the score buffer (col = c + shift + row).
//   2. S = scale * Q.K^T + R at the skew over the band, masked, in panels
//      of 256 keys. From here each thread touches only its own cells (rows
//      ly + 4i, columns p0 + 32 warp + lx + 8j), so the softmax needs no
//      barrier but its two reductions: the row max and the row sum, each
//      over the thread's cells, the 8 lanes of a row (xor shuffles), then
//      the 8 warps through a small shared array in warp order.
//   3. One pass over the thread's cells: e = exp(s - max), the sum of e,
//      and keep ? e : 0 (the dropout hash) written back in place. A masked
//      cell and a cell past T get 0 exactly. The first V chunk is in
//      flight meanwhile.
//   4. O = P'.V over the band in KV = 32-key chunks of V, staged by
//      cp.async on a double buffer. The 32 x d_h output is small (12
//      outputs a thread at d_h = 96 if all 8 warps shared it), so each
//      chunk's keys are split between NGROUPS = 4 warp pairs: a thread
//      keeps an 8 x d_h/16 register tile (rows 16 w + half + 2i, the
//      columns of Cols<NC>) over KG = 8 keys of each chunk, reading 8 rows
//      of P' as one 128-bit load per 4 keys and V as 8- or 16-byte vectors:
//      5 loads per key for 48 FMAs at d_h = 96, where 12 outputs a thread
//      (4 x 3) would take 7 for 12. A warp whose 16 rows lie past T skips
//      its FMAs. Groups 1-3 leave their partial tiles in shared memory and
//      group 0 adds them in group order, then multiplies each row by
//      drop_scale / its sum and stores the rows below T.
// Every output element has one owner and every sum a fixed order, so two
// calls on the same inputs give bit-equal outputs. Shared memory: Q and the
// E/K slices (46 KB, V's chunks reuse the slices' buffers), the scores
// (32 x (round32(nb) + 8) floats) and the two reductions; ~82 KB at m =
// 100 and T >= 256, so two CTAs an SM. Past m = 105 the band takes
// several 256-column panels and the score buffer grows with m (96 KB at
// m = 163): it needs no more than the card's 227 KB up to m = 681 at any T
// and d_h.
//
// What bounds it on the card. At the training shape in f32 (B=120, H=8,
// T=200, d_h=96, m=100) the function moves ~295 MB (~88 us at 3.35 TB/s)
// and needs ~16.5 GFLOP of band work (~0.25 ms at the 67 TFLOP/s f32 peak
// outside the tensor cores), so operations bound it. The tiles issue ~24
// GFLOP (R 7.5 and S 8.1 over whole 32-column warps of the slots and the
// band, P'.V 8.6 over whole 32-key chunks), against the parent design's
// 28.7.

#include "f32_band.cuh"
#include "rel_attention.cuh"

namespace {

using namespace f32band;
using relattn::hash_bits;

constexpr int KV = 32;               // keys of a V chunk
constexpr int NGROUPS = 4;           // warp pairs splitting a chunk's keys
constexpr int KG = KV / NGROUPS;     // keys of a chunk a group takes
constexpr int MIN_LDS = 40;          // score_ld at the narrowest band

__host__ __device__ inline int round32(int x) { return (x + 31) & ~31; }

// Row stride of the score buffer: the band in whole V chunks, plus 8 (so
// the 4 rows of a warp's cell tile start 8 banks apart).
__host__ __device__ inline int score_ld(int T, int m) {
  return round32(band_cols(T, m)) + 8;
}

// Shared memory of one CTA, in floats: Q, E/K (then V), the scores, the
// row max and sum partials.
__host__ __device__ inline int fwd_floats(int T, int m) {
  return NBUF * (QA + NCOLS) * LDK + QA * score_ld(T, m) + 2 * NWARPS * QA;
}

static_assert(NBUF * KV * (MAX_DH + 4) <= NBUF * NCOLS * LDK,
              "V's chunks fit the E/K buffers");
static_assert((NGROUPS - 1) * 8 * (MAX_DH / 16) * 64 <=
                  NBUF * (QA + NCOLS) * LDK + QA * MIN_LDS,
              "the groups' partial tiles fit below the reductions");

template <int NC>
__global__ void __launch_bounds__(NTHREADS, 2)
fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ e,
        float* __restrict__ o, int H, int T, int m, int valid_len,
        float scale, unsigned seed, unsigned drop_threshold,
        float drop_scale, int b_offset, int h_offset, int H_total) {
  using C = Cols<NC>;
  constexpr int DH = C::DH;
  constexpr int LDV = C::LDH;            // row stride of a V chunk
  extern __shared__ __align__(16) float smem[];
  const int lds = score_ld(T, m);
  float* sA = smem;                      // NBUF x QA x LDK: Q
  float* sB = sA + NBUF * QA * LDK;      // NBUF x NCOLS x LDK: E or K
  float* sV = sB;                        // NBUF x KV x LDV: V, over E/K
  float* sS = sB + NBUF * NCOLS * LDK;   // QA x lds: scores, then P'
  float* sMax = sS + QA * lds;           // NWARPS x QA: row max partials
  float* sSum = sMax + NWARPS * QA;      // NWARPS x QA: row sum partials
  float* part = smem;                    // groups 1-3's tiles, at the end

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ly = lane >> 3;              // rows ly + 4i
  const int lx = lane & 7;               // columns p0 + 32 warp + lx + 8j
  const int W = 2 * m - 1;
  const int q0 = blockIdx.x * QA;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = ((size_t)b * H + h) * (size_t)T * DH;
  const int kb = imax(0, q0 - (m - 1)) & ~15;
  const int nb = band_cols(T, m);
  const int ncp = round32(nb);           // band columns of P'.V
  const int ns = imin(nb, T - kb);       // band columns with a key < T
  const int r_lo = imax(0, m - QA - q0);
  const int r_hi = imin(W, T + m - 1 - q0);
  const int shift = r_lo + q0 - (m - 1) - kb;
  float acc[8][4];

  // 1. R over the slots the tile reaches, scattered onto the band cells
  for (int p0 = 0; p0 < r_hi - r_lo; p0 += NCOLS) {
    band_product(acc, q + head, e + (size_t)h * W * DH, q0, T, r_lo + p0,
                 imin(NCOLS, r_hi - r_lo - p0), r_hi, DH, sA, sB);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = ly + 4 * i;
        const int c = p0 + 32 * warp + lx + 8 * j;
        const int col = c + shift + row;
        if (c < r_hi - r_lo && col >= 0 && col < nb)
          sS[row * lds + col] = acc[i][j];
      }
  }

  // 2. S = scale * Q.K^T + R, masked, and the thread's row maxima; the
  // product's barriers order the cells written above before these reads.
  // A panel past the keys < T holds masked cells only.
  float mx[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) mx[i] = -INFINITY;
  for (int p0 = 0; p0 < ncp; p0 += NCOLS) {
    if (p0 < ns)
      band_product(acc, q + head, k + head, q0, T, kb + p0,
                   imin(NCOLS, ns - p0), T, DH, sA, sB);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = ly + 4 * i;
        const int c = p0 + 32 * warp + lx + 8 * j;
        if (c < ncp) {
          const int qi = q0 + row;
          const int kj = kb + c;
          const int rel = kj - qi;
          const bool visible = qi < T && kj < T && rel >= 1 - m &&
                               rel <= m - 1 &&
                               ((kj < valid_len) == (qi < valid_len));
          float* s = sS + row * lds + c;
          const float x = visible ? fmaf(acc[i][j], scale, *s) : -INFINITY;
          *s = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
  }

  // The first V chunk, in flight through the softmax (the E/K buffers are
  // free after the last product's barrier); the P'.V ring commits it with
  // its chunk 0.
  const float* vh = v + head;
  stage_async<DH>(sV, LDV, vh, DH, kb, KV, T, 0, DH);

  // Row max: the thread's cells, the row's 8 lanes, then the warps in order
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float x = mx[i];
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
    if (lx == 0) sMax[warp * QA + ly + 4 * i] = x;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float x = sMax[ly + 4 * i];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) x = fmaxf(x, sMax[w * QA + ly + 4 * i]);
    mx[i] = x;
  }

  // 3. e = exp(s - max) and its sums; keep ? e : 0 in place. A masked cell
  // gives 0 exactly, as exp(-1e8 - max) underflows to 0 in the reference;
  // rows at or past T are all zero.
  const unsigned cell_seed =
      seed + (unsigned)((b_offset + b) * H_total + h_offset + h);
  float sum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) sum[i] = 0.f;
  for (int p0 = 0; p0 < ncp; p0 += NCOLS) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = ly + 4 * i;
        const int c = p0 + 32 * warp + lx + 8 * j;
        if (c < ncp) {
          float* s = sS + row * lds + c;
          const float x = *s;
          const float ex = x == -INFINITY ? 0.f : expf(x - mx[i]);
          sum[i] += ex;
          const bool keep = drop_threshold == 0u ||
                            hash_bits(q0 + row, kb + c, cell_seed) >=
                                drop_threshold;
          *s = keep ? ex : 0.f;
        }
      }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float x = sum[i];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    x += __shfl_xor_sync(0xffffffffu, x, 4);
    if (lx == 0) sSum[warp * QA + ly + 4 * i] = x;
  }

  // 4. O = P'.V; the ring's first barrier orders the writes above before
  // the reads below
  const int grp = warp >> 1;             // keys KG grp .. of each chunk
  const int half = lane >> 4;
  const int tx = lane & 15;
  const int row0 = 16 * (warp & 1) + half;   // rows row0 + 2i
  const bool live = q0 + 16 * (warp & 1) < T;
  float oacc[8][NC];
  zero(oacc);
  pipeline(
      ncp / KV,
      [&](int c, int buf) {
        if (c > 0)
          stage_async<DH>(sV + buf * KV * LDV, LDV, vh, DH, kb + c * KV, KV,
                          T, 0, DH);
      },
      [&](int c, int buf) {
        if (!live) return;
        const float* a = sS + row0 * lds + c * KV + KG * grp;
        const float* x = sV + buf * KV * LDV + KG * grp * LDV;
#pragma unroll
        for (int kk = 0; kk < KG; kk += 4) {
          float4 av[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            av[i] = *reinterpret_cast<const float4*>(a + 2 * i * lds + kk);
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            float xv[NC];
#pragma unroll
            for (int g = 0; g < C::G; ++g)
              load_vec<C::VW>(x + (kk + s) * LDV + g * 16 * C::VW +
                                  tx * C::VW,
                              xv + g * C::VW);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float p = s == 0 ? av[i].x : s == 1 ? av[i].y
                              : s == 2 ? av[i].z : av[i].w;
#pragma unroll
              for (int n = 0; n < NC; ++n)
                oacc[i][n] = fmaf(p, xv[n], oacc[i][n]);
            }
          }
        }
      });

  // The groups' tiles summed in group order by group 0, each row times
  // drop_scale / its sum (the warps' partial sums in warp order)
  const int t64 = threadIdx.x & 63;
  if (grp > 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int n = 0; n < NC; ++n)
        part[(((grp - 1) * 8 + i) * NC + n) * 64 + t64] = oacc[i][n];
  }
  __syncthreads();
  if (grp > 0) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + 2 * i;
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) tot += sSum[w * QA + row];
    const float mult = tot > 0.f ? (1.f / tot) * drop_scale : 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      float x = oacc[i][n];
#pragma unroll
      for (int g = 1; g < NGROUPS; ++g)
        x += part[(((g - 1) * 8 + i) * NC + n) * 64 + t64];
      oacc[i][n] = x * mult;
    }
  }
  store_rows(o + head, oacc, q0 + row0, 2, T, tx, 1.f);
}

}  // namespace

extern "C" {

// Shared memory one CTA takes, in bytes, for T frames, head width dh and
// window m (dh does not change it).
int rel_attention_fwd_smem_bytes(int T, int dh, int m) {
  (void)dh;
  return (int)(sizeof(float) * (size_t)fwd_floats(T, m));
}

// q, k, v, o: (B, H, T, dh) contiguous f32; e: (H, 2m-1, dh) contiguous
// f32. drop_threshold 0 = no dropout; drop_scale is 1 / (1 -
// drop_threshold / 2^32). is_bf16 must be 0: bf16 inputs go to
// rel_attention_fwd_wmma. Launches on `stream` and returns the cudaError_t
// of the launch (0 on success).
int rel_attention_fwd(const void* q, const void* k, const void* v,
                      const void* e, void* o, int B, int H, int T_len, int dh,
                      int m, int valid_len, float scale, unsigned seed,
                      unsigned drop_threshold, float drop_scale,
                      int b_offset, int h_offset, int H_total,
                      int is_bf16,
                      void* stream) {
  if (is_bf16 || B < 1 || H < 1 || T_len < 1 || m < 1 || dh < 16 ||
      dh > MAX_DH || dh % 16 != 0 || valid_len < 0 || valid_len > T_len ||
      relattn::bad_cells(B, H, b_offset, h_offset, H_total))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)fwd_floats(T_len, m);
  return (int)by_width(dh, [&](auto nc) {
    constexpr int NC = decltype(nc)::value;
    cudaError_t err = prepare(fwd_f32<NC>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(ceil_div(T_len, QA), H, B);
    fwd_f32<NC><<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(e),
        static_cast<float*>(o), H, T_len, m, valid_len, scale, seed,
        drop_threshold, drop_scale, b_offset, h_offset, H_total);
    return cudaGetLastError();
  });
}

const char* rel_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

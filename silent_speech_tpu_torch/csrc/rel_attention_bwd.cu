// Relative-position attention backward for Hopper (sm_90a), float32: four
// staged kernels whose products are register-tiled FP32 FMA on the CUDA
// cores, with no atomics.
//
// Replaces, for float32 inputs, the backward of the TPU kernel
// `fused_rel_attention` (silent_speech_tpu/ops/pallas/rel_attention.py,
// `_bwd` -> pl.pallas_call at :414, body `_bwd_kernel` at :267); bfloat16
// inputs, the training step's, run the staged WMMA kernels of
// rel_attention_bwd_wmma.cu, whose stage structure this file shares. For
// one (b, h), with scale = 1/sqrt(d_h), P the softmax of the masked scores
// and P' = P * keep * drop_scale (keep: the forward's counter hash of
// (query, key, cell), the cell of rel_attention.cuh):
//
//   dP = dO . V^T,  D = rowsum(P' (.) dP),  dS = P' (.) dP - P (.) D
//   dR[q, r] = dS[q, q + r - (m-1)], 0 where that key lies outside [0, T)
//   dQ = dR . E + scale * dS . K,  dK = scale * dS^T . Q,  dV = P'^T . dO
//   dE_h = sum_b dR_b^T . Q_b
//
// (rel_attention_bwd_staged_plain in ops/rel_attention.py spells the same
// stages out in PyTorch.) Stages, launched in this order on one stream:
//   A  bwd_f32_scores, one CTA per (QA-query tile, h, b): R = Q.E^T over
//      the tile's slots, S = Q.K^T and dP = dO.V^T over its key band, the
//      skew, the masks, the softmax, D and dS. Writes P', dS (B, H, Tp, Tp)
//      and dR (B, H, Tp, Wp) as f32 scratch, zero outside the band and in
//      the padding (Tp, Wp: T and 2m-1 rounded up to 16).
//   B  bwd_f32_dkdv, one CTA per (TILE-key tile, h, b) for dK and another
//      for dV: walks the queries that see the tile in KC-row slices.
//   C  bwd_f32_dq, one CTA per (TILE-query tile, h, b): dS.K over the band,
//      then dR.E over the slots.
//   D  bwd_f32_de_partial, one CTA per (TILE-slot tile, h, group of batch
//      rows), writes f32 partials (G, H, Wp, d_h); bwd_f32_de_reduce sums
//      the G partials in group order.
// Every output element has a single owner and every sum a fixed order, so
// two calls on the same inputs give bit-equal results.
//
// Products. Every product is FP32 FMA on the CUDA cores (no TF32), so the
// route keeps full f32 precision (1e-4 x max|ref| against autograd). Each
// thread owns a register tile of outputs and reads its operands from
// shared memory as 16- or 8-byte vectors:
//   A  8 query rows x 4 band columns a thread; a warp covers all QA = 32
//      rows and 32 columns, so a 4-float step along d_h takes 12 128-bit
//      loads for 128 FMAs. Both operands are staged with d_h contiguous and
//      a row stride of LDK = 20 floats (5 x 16 B, odd), so the 8 rows a
//      quarter-warp reads fall in 8 different bank groups.
//   B-D  8 output rows x d_h/16 columns a thread (8 x 6 at d_h = 96), 16 x
//      16 threads over a TILE x d_h block. Stages B and D read their
//      transposed operand (dS, P' or dR, queries x keys) as it lies in the
//      scratch, rows along the contraction: two 128-bit loads give a
//      thread's 8 rows, and the d_h/16 columns come as 8- or 16-byte
//      vectors, 5 loads for 48 FMAs a step. Stage C reads dS and dR with
//      the contraction contiguous, a 128-bit load a row per 4 steps;
//      its two half-warps take neighbouring rows (LDC = 36, 9 x 16 B).
// Every operand is staged by cp.async, 16 bytes a lane, into a double
// buffer: the next slice is in flight while the current one is multiplied.
// A warp whose rows or columns all lie past the data skips the FMAs.
//
// What bounds it on the card. At the training shape (B=120, H=8, T=200,
// d_h=96, m=100) the function reads Q, K, V, E, dO and writes dQ, dK, dV,
// dE, ~516 MB (0.154 ms at 3.35 TB/s), and needs ~44 GFLOP of band
// products (0.66 ms at the 67 TFLOP/s FP32 peak), so operations bound it.
// The tiles pad that to ~70 GFLOP (R over 256 slot columns, 128-row tiles
// of 200 rows, the band's rectangles), and the f32 scratch adds ~500 MB
// written by stage A and ~0.8 GB read back by stages B-D, mostly overlapped
// with other CTAs' products. Stage A takes ~81 KB of shared memory and
// stages B-D ~60-68 KB, so two CTAs of 8 warps share an SM.

#include "f32_band.cuh"
#include "rel_attention.cuh"

namespace {

using namespace f32band;
using relattn::hash_bits;
using relattn::warp_max;
using relattn::warp_sum;

// stage A (its tile, products and staging: f32_band.cuh)
constexpr int LDS = NCOLS + 8;  // row stride of the band scores
// stages B-D
constexpr int TILE = 128;       // output rows of a CTA: keys, queries, slots
constexpr int KC = 32;          // contraction slice: queries, keys or slots
constexpr int LDT = TILE + 4;   // row stride of a KC x TILE slice
constexpr int LDC = KC + 4;     // row stride of a TILE x KC slice

// True when a stage A tile's band or its slots exceed NCOLS columns.
__host__ __device__ inline bool too_wide(int T, int m) {
  return band_cols(T, m) > NCOLS || imin(2 * m - 1, T + QA - 1) > NCOLS;
}

// Stage A.
__global__ void __launch_bounds__(NTHREADS, 2)
bwd_f32_scores(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ e,
               const float* __restrict__ dout, float* __restrict__ pp,
               float* __restrict__ ds, float* __restrict__ dr, int H, int T,
               int dh, int m, int valid_len, float scale, unsigned seed,
               unsigned drop_threshold, float drop_scale, int b_offset,
               int h_offset, int H_total) {
  extern __shared__ __align__(16) float smem[];
  float* sS = smem;                    // QA x LDS: scores, then exp
  float* sA = sS + QA * LDS;           // NBUF x QA x LDK: Q or dO
  float* sB = sA + NBUF * QA * LDK;    // NBUF x NCOLS x LDK: E, K or V
  float* sD = sB + NBUF * NCOLS * LDK; // NWARPS x QA: D's partial sums
  float* sInv = sD + NWARPS * QA;      // QA: 1 / the softmax sum

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ly = lane >> 3;            // rows ly + 4i
  const int lx = lane & 7;             // columns 32 warp + lx + 8j
  const int Tp = round16(T);
  const int W = 2 * m - 1;
  const int Wp = round16(W);
  const int q0 = blockIdx.x * QA;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = ((size_t)b * H + h) * (size_t)T * dh;
  const int kb = imax(0, q0 - (m - 1)) & ~15;
  const int nb = band_cols(T, m);
  const int ns = imin(nb, T - kb);     // band columns with a key < T
  const int r_lo = imax(0, m - QA - q0);
  const int r_hi = imin(W, T + m - 1 - q0);
  float acc[8][4];

  // R over the slots [r_lo, r_hi) the tile reaches, then each slot's value
  // onto its band cell of sS (c + shift + row, one cell a slot and row)
  band_product(acc, q + head, e + (size_t)h * W * dh, q0, T, r_lo,
               r_hi - r_lo, r_hi, dh, sA, sB);
  const int shift = r_lo + q0 - (m - 1) - kb;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = ly + 4 * i;
      const int c = 32 * warp + lx + 8 * j;
      const int col = c + shift + row;
      if (c < r_hi - r_lo && col >= 0 && col < nb)
        sS[row * LDS + col] = acc[i][j];
    }

  // S = scale * Q.K^T + R at the skew, masked; the barriers of the product
  // order the cells written above before these reads
  band_product(acc, q + head, k + head, q0, T, kb, ns, T, dh, sA, sB);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = ly + 4 * i;
      const int c = 32 * warp + lx + 8 * j;
      if (c < nb) {
        const int qi = q0 + row;
        const int kj = kb + c;
        const int rel = kj - qi;
        const bool visible = qi < T && kj < T && rel >= 1 - m &&
                             rel <= m - 1 &&
                             ((kj < valid_len) == (qi < valid_len));
        float* s = sS + row * LDS + c;
        *s = visible ? fmaf(acc[i][j], scale, *s) : -INFINITY;
      }
    }
  __syncthreads();

  // Row softmax, one warp a row: exp(s - max) in place and 1 / the sum.
  // Cells that are not visible get P = 0 exactly, as exp(-1e8 - max)
  // underflows to 0 in the reference; rows at or past T are all zero.
  for (int i = warp; i < QA; i += NWARPS) {
    float* srow = sS + i * LDS;
    float mx = -INFINITY;
    for (int j = lane; j < nb; j += 32) mx = fmaxf(mx, srow[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < nb; j += 32) {
      const float p = srow[j] == -INFINITY ? 0.f : expf(srow[j] - mx);
      srow[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) sInv[i] = sum > 0.f ? 1.f / sum : 0.f;
  }

  // dP = dO . V^T over the band (the product's first barrier orders the
  // softmax before the reads below), then P' (.) dP in acc and D's partial
  // sums: over the thread's columns, its warp's 8 lanes of a row, then the
  // warps in order
  band_product(acc, dout + head, v + head, q0, T, kb, ns, T, dh, sA, sB);
  const unsigned cell_seed =
      seed + (unsigned)((b_offset + b) * H_total + h_offset + h);
  unsigned keep_bits = 0u;  // bit 4i + j: the thread's cell (i, j) is kept
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = ly + 4 * i;
    const float inv = sInv[row];
    float dsum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 32 * warp + lx + 8 * j;
      const bool keep = drop_threshold == 0u ||
                        hash_bits(q0 + row, kb + c, cell_seed) >=
                            drop_threshold;
      keep_bits |= (unsigned)keep << (4 * i + j);
      const float p = c < nb ? sS[row * LDS + c] * inv : 0.f;
      const float prod = keep ? p * drop_scale * acc[i][j] : 0.f;
      acc[i][j] = prod;
      dsum += prod;
    }
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 4);
    if (lx == 0) sD[warp * QA + row] = dsum;
  }
  __syncthreads();

  // dS = P' (.) dP - P (.) D; P', dS and dR into the scratch
  const size_t row0 = ((size_t)b * H + h) * Tp;  // first scratch row
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = ly + 4 * i;
    const int qi = q0 + row;
    if (qi >= Tp) continue;
    float d = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) d += sD[w * QA + row];
    const float inv = sInv[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 32 * warp + lx + 8 * j;
      const int kj = kb + c;
      if (c >= nb || kj >= Tp) continue;
      const float p = sS[row * LDS + c] * inv;
      const float dsv = acc[i][j] - p * d;
      pp[(row0 + qi) * Tp + kj] =
          (keep_bits >> (4 * i + j)) & 1u ? p * drop_scale : 0.f;
      ds[(row0 + qi) * Tp + kj] = dsv;
      const int r = kj - qi + m - 1;
      if (kj < T && r >= 0 && r < W) dr[(row0 + qi) * Wp + r] = dsv;
    }
  }
  // the zeros: P' and dS outside [kb, kb + nb), dR where r >= 2m-1 or its
  // key lies outside [0, T); one warp a row
  for (int i = warp; i < QA; i += NWARPS) {
    const int qi = q0 + i;
    if (qi >= Tp) break;
    for (int c = lane; c < Tp; c += 32) {
      if (c < kb || c >= kb + nb) {
        pp[(row0 + qi) * Tp + c] = 0.f;
        ds[(row0 + qi) * Tp + c] = 0.f;
      }
    }
    for (int r = lane; r < Wp; r += 32) {
      const int kj = qi + r - (m - 1);
      if (r >= W || kj < 0 || kj >= T) dr[(row0 + qi) * Wp + r] = 0.f;
    }
  }
}

// Stages B and D's product step over one KC slice: acc[i][n] += sum over
// the slice's rows kk of A[kk][row0 + i] * X[kk][col(n)], A a KC x TILE
// slice (row stride LDT) read as two 128-bit loads a row, X a KC x d_h
// slice.
template <int NC>
__device__ __forceinline__ void mma_rows(float (&acc)[8][NC], const float* a,
                                         const float* x, int row0, int tx) {
  using C = Cols<NC>;
#pragma unroll 4
  for (int kk = 0; kk < KC; ++kk) {
    float av[8], xv[NC];
    load_vec<4>(a + kk * LDT + row0, av);
    load_vec<4>(a + kk * LDT + row0 + 4, av + 4);
#pragma unroll
    for (int g = 0; g < C::G; ++g)
      load_vec<C::VW>(x + kk * C::LDH + g * 16 * C::VW + tx * C::VW,
                      xv + g * C::VW);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(av[i], xv[n], acc[i][n]);
  }
}

// Stage B: dK = scale * dS^T . Q (even blockIdx.x) or dV = P'^T . dO (odd)
// for one key tile; thread rows 8 ty + i.
template <int NC>
__global__ void __launch_bounds__(NTHREADS, 2)
bwd_f32_dkdv(const float* __restrict__ q, const float* __restrict__ dout,
             const float* __restrict__ pp, const float* __restrict__ ds,
             float* __restrict__ dk, float* __restrict__ dv, int H, int T,
             int m, float scale) {
  using C = Cols<NC>;
  extern __shared__ __align__(16) float smem[];
  float* sM = smem;                  // NBUF x KC x LDT: dS or P', queries x keys
  float* sN = sM + NBUF * KC * LDT;  // NBUF x KC x LDH: Q or dO

  const int Tp = round16(T);
  const int warp = threadIdx.x >> 5;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const bool is_dv = blockIdx.x & 1;
  const int k0 = (blockIdx.x >> 1) * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = ((size_t)b * H + h) * (size_t)T * C::DH;
  const float* mat = (is_dv ? pp : ds) + ((size_t)b * H + h) * Tp * Tp;
  const float* rows = (is_dv ? dout : q) + head;
  // the queries that see a key of the tile
  const int q_lo = imax(0, k0 - (m - 1));
  const int q_hi = imin(T, k0 + TILE + m - 1);
  const bool live = k0 + 16 * warp < T;

  float acc[8][NC];
  zero(acc);
  pipeline(
      ceil_div(q_hi - q_lo, KC),
      [&](int c, int buf) {
        const int qc = q_lo + c * KC;
        stage_async<TILE>(sM + buf * KC * LDT, LDT, mat, Tp, qc, KC, q_hi, k0,
                          Tp);
        stage_async<C::DH>(sN + buf * KC * C::LDH, C::LDH, rows, C::DH, qc,
                           KC, q_hi, 0, C::DH);
      },
      [&](int, int buf) {
        if (live)
          mma_rows(acc, sM + buf * KC * LDT, sN + buf * KC * C::LDH, 8 * ty,
                   tx);
      });
  store_rows((is_dv ? dv : dk) + head, acc, k0 + 8 * ty, 1, T, tx,
             is_dv ? 1.f : scale);
}

// Stage C: dQ = scale * dS . K + dR . E for one query tile. Thread rows
// 16 warp + (ty & 1) + 2i: a warp's two half-warps read neighbouring rows
// of the TILE x KC slices.
template <int NC>
__global__ void __launch_bounds__(NTHREADS, 2)
bwd_f32_dq(const float* __restrict__ k, const float* __restrict__ e,
           const float* __restrict__ ds, const float* __restrict__ dr,
           float* __restrict__ dq, int H, int T, int m, float scale) {
  using C = Cols<NC>;
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;                  // NBUF x TILE x LDC: dS or dR
  float* sX = sA + NBUF * TILE * LDC;  // NBUF x KC x LDH: K or E

  const int Tp = round16(T);
  const int W = 2 * m - 1;
  const int Wp = round16(W);
  const int warp = threadIdx.x >> 5;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int q0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const size_t head = bh * (size_t)T * C::DH;
  const int row0 = 16 * warp + (ty & 1);
  const bool live = q0 + 16 * warp < T;

  float acc[8][NC];
  zero(acc);
  // acc += (the slice in sA) . (the slice in sX)
  auto product = [&](int buf) {
    if (!live) return;
    const float* a = sA + buf * TILE * LDC;
    const float* x = sX + buf * KC * C::LDH;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(a + (row0 + 2 * i) * LDC +
                                                 kk);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float xv[NC];
#pragma unroll
        for (int g = 0; g < C::G; ++g)
          load_vec<C::VW>(x + (kk + s) * C::LDH + g * 16 * C::VW + tx * C::VW,
                          xv + g * C::VW);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a_is = s == 0 ? av[i].x : s == 1 ? av[i].y
                             : s == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(a_is, xv[n], acc[i][n]);
        }
      }
    }
  };
  // dS . K over the band's keys
  const int k_lo = imax(0, q0 - (m - 1)) & ~3;
  const int k_hi = imin(T, q0 + TILE + m - 1);
  pipeline(
      ceil_div(k_hi - k_lo, KC),
      [&](int c, int buf) {
        const int c0 = k_lo + c * KC;
        stage_async<KC>(sA + buf * TILE * LDC, LDC, ds + bh * Tp * Tp, Tp, q0,
                        TILE, Tp, c0, Tp);
        stage_async<C::DH>(sX + buf * KC * C::LDH, C::LDH, k + head, C::DH,
                           c0, KC, T, 0, C::DH);
      },
      [&](int, int buf) { product(buf); });
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] *= scale;
  // dR . E over the slots that reach a key in [0, T) from this tile
  const int s_lo = imax(0, (m - 1) - (q0 + TILE - 1)) & ~3;
  const int s_hi = imin(W, T + m - 1 - q0);
  pipeline(
      ceil_div(s_hi - s_lo, KC),
      [&](int c, int buf) {
        const int s0 = s_lo + c * KC;
        stage_async<KC>(sA + buf * TILE * LDC, LDC, dr + bh * Tp * Wp, Wp, q0,
                        TILE, Tp, s0, Wp);
        stage_async<C::DH>(sX + buf * KC * C::LDH, C::LDH,
                           e + (size_t)h * W * C::DH, C::DH, s0, KC, W, 0,
                           C::DH);
      },
      [&](int, int buf) { product(buf); });
  store_rows(dq + head, acc, q0 + row0, 2, T, tx, 1.f);
}

// Stage D, first kernel: the dR^T . Q partial of one slot tile over one
// group of batch rows, into part (G, H, Wp, d_h); thread rows 8 ty + i.
template <int NC>
__global__ void __launch_bounds__(NTHREADS, 2)
bwd_f32_de_partial(const float* __restrict__ q, const float* __restrict__ dr,
                   float* __restrict__ part, int B, int H, int T, int m,
                   int rows_per_group) {
  using C = Cols<NC>;
  extern __shared__ __align__(16) float smem[];
  float* sM = smem;                  // NBUF x KC x LDT: dR, queries x slots
  float* sN = sM + NBUF * KC * LDT;  // NBUF x KC x LDH: Q

  const int Tp = round16(T);
  const int Wp = round16(2 * m - 1);
  const int warp = threadIdx.x >> 5;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int s0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int g = blockIdx.z;
  const int b_lo = g * rows_per_group;
  const int b_hi = imin(B, b_lo + rows_per_group);
  // the queries for which a slot of the tile reaches a key in [0, T); the
  // slices walk them for each batch row of the group in turn
  const int q_lo = imax(0, (m - 1) - (s0 + TILE - 1));
  const int q_hi = imin(T, T + m - 1 - s0);
  const int nq = q_hi > q_lo ? ceil_div(q_hi - q_lo, KC) : 0;
  const bool live = s0 + 16 * warp < 2 * m - 1;

  float acc[8][NC];
  zero(acc);
  pipeline(
      b_hi > b_lo ? (b_hi - b_lo) * nq : 0,
      [&](int c, int buf) {
        const size_t bh = (size_t)(b_lo + c / nq) * H + h;
        const int qc = q_lo + (c % nq) * KC;
        stage_async<TILE>(sM + buf * KC * LDT, LDT, dr + bh * Tp * Wp, Wp, qc,
                          KC, q_hi, s0, Wp);
        stage_async<C::DH>(sN + buf * KC * C::LDH, C::LDH,
                           q + bh * T * C::DH, C::DH, qc, KC, q_hi, 0, C::DH);
      },
      [&](int, int buf) {
        if (live)
          mma_rows(acc, sM + buf * KC * LDT, sN + buf * KC * C::LDH, 8 * ty,
                   tx);
      });
  store_rows(part + ((size_t)g * H + h) * Wp * C::DH, acc, s0 + 8 * ty, 1,
             Wp, tx, 1.f);
}

// Stage D, second kernel: dE = the sum of the G partials, in group order.
__global__ void bwd_f32_de_reduce(const float* __restrict__ part,
                                  float* __restrict__ de, int G, int H, int W,
                                  int Wp, int dh) {
  const int n = H * W * dh;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += gridDim.x * blockDim.x) {
    const int h = idx / (W * dh);
    const int rc = idx - h * W * dh;  // r * dh + c, r < W
    float sum = 0.f;
    for (int g = 0; g < G; ++g)
      sum += part[((size_t)g * H + h) * Wp * dh + rc];
    de[idx] = sum;
  }
}

// Shared memory of each stage, in bytes.
__host__ __device__ inline size_t scores_smem() {
  return sizeof(float) * (QA * LDS + NBUF * (QA + NCOLS) * LDK +
                          NWARPS * QA + QA);
}
__host__ __device__ inline size_t dkdv_smem(int dh) {
  return sizeof(float) * NBUF * KC * (LDT + dh + 4);
}
__host__ __device__ inline size_t dq_smem(int dh) {
  return sizeof(float) * NBUF * (TILE * LDC + KC * (dh + 4));
}
__host__ __device__ inline size_t de_smem(int dh) { return dkdv_smem(dh); }

bool bad_shape(int B, int H, int T, int dh, int m) {
  return B < 1 || H < 1 || T < 1 || m < 1 || dh < 16 || dh > MAX_DH ||
         dh % 16 != 0;
}

}  // namespace

extern "C" {

// Shared memory one CTA of stage `stage` (0-3 = A-D) takes, in bytes.
int rel_attention_bwd_smem_bytes(int stage, int T, int dh, int m) {
  (void)T;
  (void)m;
  switch (stage) {
    case 0: return (int)scores_smem();
    case 1: return (int)dkdv_smem(dh);
    case 2: return (int)dq_smem(dh);
    default: return (int)de_smem(dh);
  }
}

// All tensors contiguous f32. q, k, v, dout, dq, dk, dv: (B, H, T, dh); e,
// de: (H, 2m-1, dh). Scratch, written by stage A and read by the others:
// pp and ds (B, H, Tp, Tp), dr (B, H, Tp, Wp), Tp and Wp being T and 2m-1
// rounded up to 16; part: (groups, H, Wp, dh). Each function launches on
// `stream` and returns the cudaError_t of its launches.

// Stage A: P', dS and dR into the scratch. is_bf16 must be 0: bf16 inputs
// go to the rel_attention_bwd_wmma stages. A tile's band and slots must
// fit NCOLS = 256 columns: m <= 105 at any T (too_wide).
int rel_attention_bwd_scores(const void* q, const void* k, const void* v,
                             const void* e, const void* dout, void* pp,
                             void* ds, void* dr, int B, int H, int T, int dh,
                             int m, int valid_len, float scale, unsigned seed,
                             unsigned drop_threshold, float drop_scale,
                             int b_offset, int h_offset, int H_total,
                             int is_bf16, void* stream) {
  if (is_bf16 || bad_shape(B, H, T, dh, m) || valid_len < 0 ||
      valid_len > T || relattn::bad_cells(B, H, b_offset, h_offset, H_total) ||
      too_wide(T, m))
    return (int)cudaErrorInvalidValue;
  const size_t smem = scores_smem();
  cudaError_t err = prepare(bwd_f32_scores, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ceil_div(round16(T), QA), H, B);
  bwd_f32_scores<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(e),
      static_cast<const float*>(dout), static_cast<float*>(pp),
      static_cast<float*>(ds), static_cast<float*>(dr), H, T, dh, m,
      valid_len, scale, seed, drop_threshold, drop_scale, b_offset, h_offset,
      H_total);
  return (int)cudaGetLastError();
}

// Stage B: dK and dV.
int rel_attention_bwd_dkdv(const void* q, const void* dout, const void* pp,
                           const void* ds, void* dk, void* dv, int B, int H,
                           int T, int dh, int m, float scale, void* stream) {
  if (bad_shape(B, H, T, dh, m)) return (int)cudaErrorInvalidValue;
  return (int)by_width(dh, [&](auto nc) {
    constexpr int NC = decltype(nc)::value;
    const size_t smem = dkdv_smem(16 * NC);
    cudaError_t err = prepare(bwd_f32_dkdv<NC>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(2 * ceil_div(T, TILE), H, B);
    bwd_f32_dkdv<NC>
        <<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(q), static_cast<const float*>(dout),
            static_cast<const float*>(pp), static_cast<const float*>(ds),
            static_cast<float*>(dk), static_cast<float*>(dv), H, T, m, scale);
    return cudaGetLastError();
  });
}

// Stage C: dQ.
int rel_attention_bwd_dq(const void* k, const void* e, const void* ds,
                         const void* dr, void* dq, int B, int H, int T,
                         int dh, int m, float scale, void* stream) {
  if (bad_shape(B, H, T, dh, m)) return (int)cudaErrorInvalidValue;
  return (int)by_width(dh, [&](auto nc) {
    constexpr int NC = decltype(nc)::value;
    const size_t smem = dq_smem(16 * NC);
    cudaError_t err = prepare(bwd_f32_dq<NC>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(ceil_div(T, TILE), H, B);
    bwd_f32_dq<NC><<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(k), static_cast<const float*>(e),
        static_cast<const float*>(ds), static_cast<const float*>(dr),
        static_cast<float*>(dq), H, T, m, scale);
    return cudaGetLastError();
  });
}

// Stage D: dE, from `groups` partials over ceil(B / groups) batch rows
// each, summed in group order.
int rel_attention_bwd_de(const void* q, const void* dr, void* part, void* de,
                         int B, int H, int T, int dh, int m, int groups,
                         void* stream) {
  if (bad_shape(B, H, T, dh, m) || groups < 1 || groups > B)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int W = 2 * m - 1;
  cudaError_t err = by_width(dh, [&](auto nc) {
    constexpr int NC = decltype(nc)::value;
    const size_t smem = de_smem(16 * NC);
    cudaError_t e2 = prepare(bwd_f32_de_partial<NC>, smem);
    if (e2 != cudaSuccess) return e2;
    const dim3 grid(ceil_div(round16(W), TILE), H, groups);
    bwd_f32_de_partial<NC><<<grid, NTHREADS, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(dr),
        static_cast<float*>(part), B, H, T, m, ceil_div(B, groups));
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  const int n = H * W * dh;
  bwd_f32_de_reduce<<<ceil_div(n, NTHREADS), NTHREADS, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(de), groups, H, W,
      round16(W), dh);
  return (int)cudaGetLastError();
}

const char* rel_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

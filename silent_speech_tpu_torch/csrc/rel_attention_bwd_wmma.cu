// Relative-position attention backward for Hopper (sm_90a), bfloat16: four
// staged kernels whose tile products run on the tensor cores through WMMA,
// with no atomics.
//
// Replaces, for bf16 inputs, the backward of the TPU kernel
// `fused_rel_attention` (silent_speech_tpu/ops/pallas/rel_attention.py,
// `_bwd` -> pl.pallas_call at :414, body `_bwd_kernel` at :267). float32
// inputs keep the single kernel of rel_attention_bwd.cu.
//
// For one (b, h), with scale = 1/sqrt(d_h), P the softmax of the masked
// scores and P' = P * keep * drop_scale (keep: the forward's counter hash
// of (query, key, cell), the cell of rel_attention.cuh):
//
//   dP = dO . V^T,  D = rowsum(P' (.) dP),  dS = P' (.) dP - P (.) D
//   dR[q, r] = dS[q, q + r - (m-1)], 0 where that key lies outside [0, T)
//   dQ = dR . E + scale * dS . K,  dK = scale * dS^T . Q,  dV = P'^T . dO
//   dE_h = sum_b dR_b^T . Q_b
//
// Stages, launched in this order on one stream (ops/rel_attention.py):
//   A  scores_kernel, one CTA per (32-query tile, h, b): R = Q.E^T and
//      S = Q.K^T, the skew, masks and softmax in f32, dP = dO.V^T, D, dS.
//      The CTA owns its rows and their whole key band, so the unskew to dR
//      is a gather inside shared memory. Writes P', dS (B, H, Tp, Tp) and
//      dR (B, H, Tp, Wp) as bf16 scratch, zero outside the band and in the
//      padding (Tp, Wp: T and 2m-1 rounded up to 16).
//   B  dkdv_kernel, one CTA per (64-key tile, h, b) for dK and another for
//      dV: walks the queries that see the tile; dS^T and P'^T come from the
//      row-major scratch through col_major matrix_a fragments.
//   C  dq_kernel, one CTA per (64-query tile, h, b): dR.E over the slots,
//      then dS.K over the band.
//   D  de_partial_kernel, one CTA per (64-slot tile, h, group of batch
//      rows), writes f32 partials (G, H, Wp, d_h); de_reduce_kernel sums
//      the G partials in a fixed order.
// Every output element has a single owner and every sum a fixed order, so
// two calls on the same inputs give bit-equal results. The scratch rounds
// P', dS and dR to bf16 where the JAX kernel rounds them to the compute
// type (rel_attention.py:290, :300, :307-309); D, the softmax and every
// accumulator stay f32. Every stage walks its operand in chunks that
// cp.async copies into a double buffer (`pipeline`), the next chunk in
// flight while the tensor cores work on the current one. The WMMA
// helpers and stage A's band product live in wmma_band.cuh, which the
// bf16 forward (rel_attention_fwd_wmma.cu) shares.
//
// What bounds it on the card. At the training shape (B=120, H=8, T=200,
// d_h=96, m=100) the function reads Q, K, V, E, dO and writes dQ, dK, dV,
// dE: ~258 MB, 0.077 ms at 3.35 TB/s, against ~45 GFLOP of band products
// (~0.045 ms at the dense bf16 peak), so bytes bound it. The staged design
// trades traffic for simplicity: the bf16 scratch (~250 MB written, ~420
// MB read back by stages B-D) and stage A's re-reads of E and of the K
// and V bands (~1 GB, mostly from L2) come on top, and the 16-wide tiles
// pad the band products. In exchange a stage A CTA needs ~74 KB of shared
// memory (three per SM) and the others ~45-53 KB, every product is a
// 16x16x16 bf16 WMMA tile with f32 accumulators, and nothing is summed
// across CTAs except the dE partials. Stage A takes about half the time,
// most of it waiting on its chunk loads; keeping the scratch on chip,
// deeper pipelines, wgmma and TMA are later steps.

#include "rel_attention.cuh"
#include "wmma_band.cuh"

namespace {

using namespace wmmaband;
using relattn::hash_bits;
using relattn::warp_max;
using relattn::warp_sum;

// Shared memory of each stage, in bytes; every chunk is double-buffered.
__host__ __device__ inline size_t scores_smem(int T, int dh, int m) {
  const int nb = band_cols(T, m);
  const int ldr = imax(round16(2 * m - 1), nb) + 4;
  return sizeof(bf16) * (QROWS + 2 * KROWS) * (dh + 8) +
         sizeof(float) * QROWS * ((nb + 4) + ldr + 1);
}
__host__ __device__ inline size_t dkdv_smem(int dh) {
  return sizeof(bf16) * 2 * TILE * (LDC + dh + 8) +
         sizeof(float) * NWARPS * WM * WM;
}
__host__ __device__ inline size_t dq_smem(int dh) { return dkdv_smem(dh); }
__host__ __device__ inline size_t de_smem(int dh) {
  return sizeof(bf16) * 2 * TILE * (LDC + dh + 8);
}

// Stage A.
__global__ void __launch_bounds__(NTHREADS)
scores_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ e,
              const bf16* __restrict__ dout, bf16* __restrict__ pp,
              bf16* __restrict__ ds, bf16* __restrict__ dr, int H, int T,
              int dh, int m, int valid_len, float scale, unsigned seed,
              unsigned drop_threshold, float drop_scale,
              int b_offset, int h_offset, int H_total) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Tp = round16(T);
  const int W = 2 * m - 1;
  const int Wp = round16(W);
  const int nb = band_cols(T, m);
  const int ldh = dh + 8;
  const int lds = nb + 4;
  const int ldr = imax(Wp, nb) + 4;
  bf16* sA = reinterpret_cast<bf16*>(smem);   // QROWS x ldh: Q, then dO
  bf16* sX = sA + QROWS * ldh;                // 2 x KROWS x ldh: E, K, V
  float* sS = reinterpret_cast<float*>(sX + 2 * KROWS * ldh);  // S, then P
  float* sR = sS + QROWS * lds;               // QROWS x ldr: R, dP, dS
  float* sInv = sR + QROWS * ldr;             // QROWS: 1 / the softmax sum

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * QROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = ((size_t)b * H + h) * (size_t)T * dh;
  const int kb = imax(0, q0 - (m - 1)) & ~15;

  // R = Q . E^T over the 2m-1 relative slots, S = Q . K^T over the band
  stage_async(sA, ldh, q + head, dh, q0, QROWS, T, 0, dh, dh);
  band_product(sA, ldh, e + (size_t)h * W * dh, 0, W, Wp, sR, ldr, sX, dh);
  band_product(sA, ldh, k + head, kb, T, nb, sS, lds, sX, dh);

  // Skewed relative logits, masks and the row softmax, one warp per row.
  // Cells that are not visible get P = 0 exactly, as exp(-1e8 - max)
  // underflows to 0 in the reference; rows at or past T are all zero.
  for (int i = warp; i < QROWS; i += NWARPS) {
    const int qi = q0 + i;
    float* srow = sS + i * lds;
    const float* rrow = sR + i * ldr;
    float mx = -INFINITY;
    for (int j = lane; j < nb; j += 32) {
      const int kj = kb + j;
      const int rel = kj - qi;
      const bool visible = qi < T && kj < T && rel >= 1 - m && rel <= m - 1 &&
                           ((kj < valid_len) == (qi < valid_len));
      const float s =
          visible ? fmaf(srow[j], scale, rrow[rel + m - 1]) : -INFINITY;
      srow[j] = s;
      mx = fmaxf(mx, s);
    }
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
  __syncthreads();  // R and the Q tile are no longer read

  // dP = dO . V^T over the band, into sR
  stage_async(sA, ldh, dout + head, dh, q0, QROWS, T, 0, dh, dh);
  band_product(sA, ldh, v + head, kb, T, nb, sR, ldr, sX, dh);

  // D, dS and P' per row (one warp per row), then the row's P', dS and
  // dR into the scratch. The warp owns its row, so the unskew reads it
  // after a __syncwarp.
  const unsigned cell_seed =
      seed + (unsigned)((b_offset + b) * H_total + h_offset + h);
  const size_t row0 = ((size_t)b * H + h) * Tp;  // first scratch row
  for (int i = warp; i < QROWS; i += NWARPS) {
    const int qi = q0 + i;
    if (qi >= Tp) break;
    float* prow = sS + i * lds;
    float* drow = sR + i * ldr;
    const float inv = sInv[i];
    float dsum = 0.f;
    unsigned keep_bits = 0u;  // bit n: the cell j = lane + 32 n is kept
    for (int j = lane, n = 0; j < nb; j += 32, ++n) {
      const bool keep = drop_threshold == 0u ||
                        hash_bits(qi, kb + j, cell_seed) >= drop_threshold;
      keep_bits |= (unsigned)keep << n;
      const float p = prow[j] * inv;
      const float prod = keep ? p * drop_scale * drow[j] : 0.f;
      prow[j] = p;
      drow[j] = prod;
      dsum += prod;
    }
    dsum = warp_sum(dsum);
    for (int j = lane, n = 0; j < nb; j += 32, ++n) {
      drow[j] -= prow[j] * dsum;
      prow[j] = (keep_bits >> n) & 1u ? prow[j] * drop_scale : 0.f;
    }
    __syncwarp();
    bf16* pp_row = pp + (row0 + qi) * Tp;
    bf16* ds_row = ds + (row0 + qi) * Tp;
    bf16* dr_row = dr + (row0 + qi) * Wp;
    for (int c = 2 * lane; c < Tp; c += 64) {
      const int j = c - kb;  // even, as kb and nb are multiples of 16
      const bool in = j >= 0 && j < nb;
      *reinterpret_cast<__nv_bfloat162*>(pp_row + c) = __floats2bfloat162_rn(
          in ? prow[j] : 0.f, in ? prow[j + 1] : 0.f);
      *reinterpret_cast<__nv_bfloat162*>(ds_row + c) = __floats2bfloat162_rn(
          in ? drow[j] : 0.f, in ? drow[j + 1] : 0.f);
    }
    for (int r = 2 * lane; r < Wp; r += 64) {
      float x[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kj = qi + r + u - (m - 1);
        x[u] = (r + u < W && kj >= 0 && kj < T) ? drow[kj - kb] : 0.f;
      }
      *reinterpret_cast<__nv_bfloat162*>(dr_row + r) =
          __floats2bfloat162_rn(x[0], x[1]);
    }
  }
}

// Stage B: dK = scale * dS^T . Q (even blockIdx.x) or dV = P'^T . dO (odd)
// for one key tile.
__global__ void __launch_bounds__(NTHREADS)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ dout,
            const bf16* __restrict__ pp, const bf16* __restrict__ ds,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int T,
            int dh, int m, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Tp = round16(T);
  const int ldh = dh + 8;
  bf16* sM = reinterpret_cast<bf16*>(smem);  // 2 x TILE x LDC: dS or P'
  bf16* sN = sM + 2 * TILE * LDC;            // 2 x TILE x ldh: Q or dO
  float* sT = reinterpret_cast<float*>(sN + 2 * TILE * ldh);

  const int warp = threadIdx.x >> 5;
  const bool is_dv = blockIdx.x & 1;
  const int k0 = (blockIdx.x >> 1) * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = ((size_t)b * H + h) * (size_t)T * dh;
  const size_t sh = ((size_t)b * H + h) * (size_t)Tp * Tp;
  const bf16* mat = (is_dv ? pp : ds) + sh;
  const bf16* rows = (is_dv ? dout : q) + head;
  const int ncol = dh / WM;
  const int ntile = (TILE / WM) * ncol;

  Acc acc[MAXT];
#pragma unroll
  for (int u = 0; u < MAXT; ++u) wmma::fill_fragment(acc[u], 0.f);
  // the queries that see a key of the tile
  const int q_lo = imax(0, k0 - (m - 1));
  const int q_hi = imin(T, k0 + TILE + m - 1);
  pipeline(
      q_hi > q_lo ? (q_hi - q_lo + TILE - 1) / TILE : 0,
      [&](int c, int buf) {
        const int qc = q_lo + c * TILE;
        stage_async(sM + buf * TILE * LDC, LDC, mat, Tp, qc, TILE, q_hi, k0,
                    TILE, Tp);
        stage_async(sN + buf * TILE * ldh, ldh, rows, dh, qc, TILE, q_hi, 0,
                    dh, dh);
      },
      [&](int, int buf) {
#pragma unroll
        for (int u = 0; u < MAXT; ++u) {
          const int t = warp + u * NWARPS;
          if (t < ntile) {
            const int rt = t / ncol, ct = t - (t / ncol) * ncol;
            tile_mma<wmma::col_major, wmma::row_major>(
                acc[u], sM + buf * TILE * LDC + rt * WM, LDC,
                sN + buf * TILE * ldh + ct * WM, ldh, TILE);
          }
        }
      });
  float* tile = sT + warp * WM * WM;
#pragma unroll
  for (int u = 0; u < MAXT; ++u) {
    const int t = warp + u * NWARPS;
    if (t < ntile) {
      const int rt = t / ncol, ct = t - (t / ncol) * ncol;
      store_tile((is_dv ? dv : dk) + head, dh, k0 + rt * WM, T, ct * WM,
                 acc[u], is_dv ? 1.f : scale, tile);
    }
  }
}

// Stage C: dQ = dR . E + scale * dS . K for one query tile.
__global__ void __launch_bounds__(NTHREADS)
dq_kernel(const bf16* __restrict__ k, const bf16* __restrict__ e,
          const bf16* __restrict__ ds, const bf16* __restrict__ dr,
          bf16* __restrict__ dq, int H, int T, int dh, int m, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Tp = round16(T);
  const int W = 2 * m - 1;
  const int Wp = round16(W);
  const int ldh = dh + 8;
  bf16* sA = reinterpret_cast<bf16*>(smem);  // 2 x TILE x LDC: dR or dS
  bf16* sX = sA + 2 * TILE * LDC;            // 2 x TILE x ldh: E or K
  float* sT = reinterpret_cast<float*>(sX + 2 * TILE * ldh);

  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = ((size_t)b * H + h) * (size_t)T * dh;
  const size_t bh = (size_t)b * H + h;
  const int ncol = dh / WM;
  const int ntile = (TILE / WM) * ncol;

  Acc ar[MAXT], as[MAXT];
#pragma unroll
  for (int u = 0; u < MAXT; ++u) {
    wmma::fill_fragment(ar[u], 0.f);
    wmma::fill_fragment(as[u], 0.f);
  }
  // acc[u] += (the chunk in sA) . (the chunk in sX) over one 64 chunk
  auto product = [&](Acc* acc, int buf) {
#pragma unroll
    for (int u = 0; u < MAXT; ++u) {
      const int t = warp + u * NWARPS;
      if (t < ntile) {
        const int rt = t / ncol, ct = t - (t / ncol) * ncol;
        tile_mma<wmma::row_major, wmma::row_major>(
            acc[u], sA + buf * TILE * LDC + rt * WM * LDC, LDC,
            sX + buf * TILE * ldh + ct * WM, ldh, TILE);
      }
    }
  };
  // dR . E over the slots that reach a key in [0, T) from this tile
  const int s_lo = imax(0, (m - 1) - (q0 + TILE - 1)) & ~15;
  const int s_hi = imin(W, T + m - 1 - q0);
  pipeline(
      s_hi > s_lo ? (s_hi - s_lo + TILE - 1) / TILE : 0,
      [&](int c, int buf) {
        const int s0 = s_lo + c * TILE;
        stage_async(sA + buf * TILE * LDC, LDC, dr + bh * Tp * Wp, Wp, q0,
                    TILE, Tp, s0, TILE, Wp);
        stage_async(sX + buf * TILE * ldh, ldh, e + (size_t)h * W * dh, dh,
                    s0, TILE, W, 0, dh, dh);
      },
      [&](int, int buf) { product(ar, buf); });
  // dS . K over the band's keys
  const int k_lo = imax(0, q0 - (m - 1)) & ~15;
  const int k_hi = imin(T, q0 + TILE + m - 1);
  pipeline(
      (k_hi - k_lo + TILE - 1) / TILE,
      [&](int c, int buf) {
        const int c0 = k_lo + c * TILE;
        stage_async(sA + buf * TILE * LDC, LDC, ds + bh * Tp * Tp, Tp, q0,
                    TILE, Tp, c0, TILE, Tp);
        stage_async(sX + buf * TILE * ldh, ldh, k + head, dh, c0, TILE, T, 0,
                    dh, dh);
      },
      [&](int, int buf) { product(as, buf); });
  float* tile = sT + warp * WM * WM;
#pragma unroll
  for (int u = 0; u < MAXT; ++u) {
    const int t = warp + u * NWARPS;
    if (t < ntile) {
      const int rt = t / ncol, ct = t - (t / ncol) * ncol;
      // the same element mapping in both fragments: an elementwise sum
      for (int i = 0; i < ar[u].num_elements; ++i)
        ar[u].x[i] = fmaf(scale, as[u].x[i], ar[u].x[i]);
      store_tile(dq + head, dh, q0 + rt * WM, T, ct * WM, ar[u], 1.f, tile);
    }
  }
}

// Stage D, first kernel: the dR^T . Q partial of one slot tile over one
// group of batch rows, f32, into part (G, H, Wp, dh).
__global__ void __launch_bounds__(NTHREADS, 3)
de_partial_kernel(const bf16* __restrict__ q, const bf16* __restrict__ dr,
                  float* __restrict__ part, int B, int H, int T, int dh,
                  int m, int rows_per_group) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Tp = round16(T);
  const int Wp = round16(2 * m - 1);
  const int ldh = dh + 8;
  bf16* sA = reinterpret_cast<bf16*>(smem);  // 2 x TILE x LDC: dR[q, slot]
  bf16* sX = sA + 2 * TILE * LDC;            // 2 x TILE x ldh: Q

  const int warp = threadIdx.x >> 5;
  const int s0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int g = blockIdx.z;
  const int b_lo = g * rows_per_group;
  const int b_hi = imin(B, b_lo + rows_per_group);
  const int ncol = dh / WM;
  const int ntile = (TILE / WM) * ncol;

  Acc acc[MAXT];
#pragma unroll
  for (int u = 0; u < MAXT; ++u) wmma::fill_fragment(acc[u], 0.f);
  // the queries for which a slot of the tile reaches a key in [0, T); the
  // chunks walk them for each batch row of the group in turn
  const int q_lo = imax(0, (m - 1) - (s0 + TILE - 1));
  const int q_hi = imin(T, T + m - 1 - s0);
  const int nq = q_hi > q_lo ? (q_hi - q_lo + TILE - 1) / TILE : 0;
  pipeline(
      b_hi > b_lo ? (b_hi - b_lo) * nq : 0,
      [&](int c, int buf) {
        const size_t bh = (size_t)(b_lo + c / nq) * H + h;
        const int qc = q_lo + (c % nq) * TILE;
        stage_async(sA + buf * TILE * LDC, LDC, dr + bh * Tp * Wp, Wp, qc,
                    TILE, q_hi, s0, TILE, Wp);
        stage_async(sX + buf * TILE * ldh, ldh, q + bh * T * dh, dh, qc, TILE,
                    q_hi, 0, dh, dh);
      },
      [&](int, int buf) {
#pragma unroll
        for (int u = 0; u < MAXT; ++u) {
          const int t = warp + u * NWARPS;
          if (t < ntile) {
            const int rt = t / ncol, ct = t - (t / ncol) * ncol;
            tile_mma<wmma::col_major, wmma::row_major>(
                acc[u], sA + buf * TILE * LDC + rt * WM, LDC,
                sX + buf * TILE * ldh + ct * WM, ldh, TILE);
          }
        }
      });
  float* out = part + ((size_t)g * H + h) * Wp * dh;
#pragma unroll
  for (int u = 0; u < MAXT; ++u) {
    const int t = warp + u * NWARPS;
    if (t < ntile) {
      const int rt = t / ncol, ct = t - (t / ncol) * ncol;
      if (s0 + rt * WM < Wp)
        wmma::store_matrix_sync(out + (size_t)(s0 + rt * WM) * dh + ct * WM,
                                acc[u], dh, wmma::mem_row_major);
    }
  }
}

// Stage D, second kernel: dE = the sum of the G partials, in group order.
__global__ void de_reduce_kernel(const float* __restrict__ part,
                                 bf16* __restrict__ de, int G, int H, int W,
                                 int Wp, int dh) {
  const int n = H * W * dh;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += gridDim.x * blockDim.x) {
    const int h = idx / (W * dh);
    const int rc = idx - h * W * dh;  // r * dh + c, r < W
    float sum = 0.f;
    for (int g = 0; g < G; ++g)
      sum += part[((size_t)g * H + h) * Wp * dh + rc];
    de[idx] = __float2bfloat16(sum);
  }
}

bool bad_shape(int B, int H, int T, int dh, int m) {
  return B < 1 || H < 1 || T < 1 || m < 1 || dh < 16 || dh > MAX_DH ||
         dh % 16 != 0;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// Shared memory one CTA of stage `stage` (0-3 = A-D) takes, in bytes.
int rel_attention_bwd_wmma_smem_bytes(int stage, int T, int dh, int m) {
  switch (stage) {
    case 0: return (int)scores_smem(T, dh, m);
    case 1: return (int)dkdv_smem(dh);
    case 2: return (int)dq_smem(dh);
    default: return (int)de_smem(dh);
  }
}

// All tensors contiguous, bf16 unless named. q, k, v, dout, dq, dk, dv:
// (B, H, T, dh); e, de: (H, 2m-1, dh). Scratch, written by stage A and read
// by the others: pp and ds (B, H, Tp, Tp), dr (B, H, Tp, Wp), Tp and Wp
// being T and 2m-1 rounded up to 16; part: f32 (groups, H, Wp, dh). Each
// function launches on `stream` and returns the cudaError_t of its
// launches.

// Stage A: P', dS and dR into the scratch.
int rel_attention_bwd_wmma_scores(const void* q, const void* k,
                                  const void* v, const void* e,
                                  const void* dout, void* pp, void* ds,
                                  void* dr, int B, int H, int T, int dh,
                                  int m, int valid_len, float scale,
                                  unsigned seed, unsigned drop_threshold,
                                  float drop_scale,
                                  int b_offset, int h_offset, int H_total,
                                  void* stream) {
  // stage A keeps one keep bit per band cell of a lane in a 32-bit word
  if (bad_shape(B, H, T, dh, m) || valid_len < 0 || valid_len > T ||
      relattn::bad_cells(B, H, b_offset, h_offset, H_total) ||
      band_cols(T, m) > 32 * 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem = scores_smem(T, dh, m);
  cudaError_t err = prepare(scores_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ceil_div(round16(T), QROWS), H, B);
  scores_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(e),
      static_cast<const bf16*>(dout), static_cast<bf16*>(pp),
      static_cast<bf16*>(ds), static_cast<bf16*>(dr), H, T, dh, m, valid_len,
      scale, seed, drop_threshold, drop_scale, b_offset, h_offset, H_total);
  return (int)cudaGetLastError();
}

// Stage B: dK and dV.
int rel_attention_bwd_wmma_dkdv(const void* q, const void* dout,
                                const void* pp, const void* ds, void* dk,
                                void* dv, int B, int H, int T, int dh, int m,
                                float scale, void* stream) {
  if (bad_shape(B, H, T, dh, m)) return (int)cudaErrorInvalidValue;
  const size_t smem = dkdv_smem(dh);
  cudaError_t err = prepare(dkdv_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(2 * ceil_div(T, TILE), H, B);
  dkdv_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(dout),
      static_cast<const bf16*>(pp), static_cast<const bf16*>(ds),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, T, dh, m, scale);
  return (int)cudaGetLastError();
}

// Stage C: dQ.
int rel_attention_bwd_wmma_dq(const void* k, const void* e, const void* ds,
                              const void* dr, void* dq, int B, int H, int T,
                              int dh, int m, float scale, void* stream) {
  if (bad_shape(B, H, T, dh, m)) return (int)cudaErrorInvalidValue;
  const size_t smem = dq_smem(dh);
  cudaError_t err = prepare(dq_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(ceil_div(T, TILE), H, B);
  dq_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(k), static_cast<const bf16*>(e),
      static_cast<const bf16*>(ds), static_cast<const bf16*>(dr),
      static_cast<bf16*>(dq), H, T, dh, m, scale);
  return (int)cudaGetLastError();
}

// Stage D: dE, from `groups` partials over ceil(B / groups) batch rows
// each, summed in group order.
int rel_attention_bwd_wmma_de(const void* q, const void* dr, void* part,
                              void* de, int B, int H, int T, int dh, int m,
                              int groups, void* stream) {
  if (bad_shape(B, H, T, dh, m) || groups < 1 || groups > B)
    return (int)cudaErrorInvalidValue;
  const size_t smem = de_smem(dh);
  cudaError_t err = prepare(de_partial_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int W = 2 * m - 1;
  const dim3 grid(ceil_div(round16(W), TILE), H, groups);
  de_partial_kernel<<<grid, NTHREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(dr),
      static_cast<float*>(part), B, H, T, dh, m, ceil_div(B, groups));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = H * W * dh;
  de_reduce_kernel<<<ceil_div(n, NTHREADS), NTHREADS, 0, s>>>(
      static_cast<const float*>(part), static_cast<bf16*>(de), groups, H, W,
      round16(W), dh);
  return (int)cudaGetLastError();
}

const char* rel_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Relative-position attention forward for Hopper (sm_90a), bfloat16, with
// the probability dropout of training: one kernel whose three band
// products run on the tensor cores through WMMA.
//
// Replaces, for bf16 inputs, the forward of the TPU kernel
// `fused_rel_attention` (silent_speech_tpu/ops/pallas/rel_attention.py,
// `_fwd` -> pl.pallas_call at :386, body `_fwd_kernel` at :251). float32
// inputs keep the kernel of rel_attention_fwd.cu. For query q and key k of
// one (batch b, head h), scale = 1/sqrt(d_h):
//
//   s[q,k] = (q.k) * scale + q . E_h[k - q + m - 1]
//            when |k - q| <= m - 1 and (k < L) == (q < L), else masked
//   P[q]   = softmax_k(s[q, :]),  P' = P * keep * drop_scale
//   O[q]   = bf16(P'[q]) . V
//
// with keep = hash(q, k, cell) >= t (the cell of rel_attention.cuh), the
// hash the JAX kernel runs off the TPU, so the mask equals the plain
// version's and the JAX kernel's in interpret mode value for value. P' is
// rounded to bf16 before the product with V, where the JAX kernel rounds
// it (`p.astype(v_ref.dtype)`, rel_attention.py:263); the softmax and
// every accumulator stay f32.
//
// Design. One CTA of 256 threads per (32-query tile, h, b). The tile sees
// the keys [kb, kb + nb): kb is its first visible key rounded down to 16
// and nb = band_cols(T, m) (wmma_band.cuh), at most round16(32 + 2(m-1) +
// 15) whatever T is, so shared memory does not grow with T. In order:
//   1. R = Q.E^T over the 2m-1 slots and S = Q.K^T over the band, with
//      the E and K chunks double-buffered by cp.async (`band_product`,
//      shared with the backward's stage A), into f32 shared memory;
//   2. the skew rel + m - 1 into R, the band, side and valid_len masks and
//      the row softmax in f32, one warp per row (the first V chunk is
//      already in flight);
//   3. P' as bf16 over the R buffer, which is no longer read, zero past
//      the band up to the 32-column chunk edge;
//   4. O = P'.V over the band in 32-row V chunks, double-buffered and
//      zero-filled outside [0, T); the 32 x d_h output (2 x 6 WMMA tiles
//      at d_h = 96) is spread over the 8 warps, each holding at most two
//      accumulators across the whole loop; rows < T are stored as bf16.
// A CTA needs ~74 KB at T = 200, m = 100 (three per SM) and ~86 KB at
// nb = 256 (T >= 256, two per SM).
//
// What bounds it on the card. At the training shape (B=120, H=8, T=200,
// d_h=96, m=100) the function reads Q, K, V, E and writes O, ~147 MB: 0.044
// ms at 3.35 TB/s, against ~17 GFLOP of band products (~0.017 ms at the
// dense bf16 peak), so bytes bound it. This kernel re-reads E and the K and
// V bands for every 32-row tile (mostly from L2) and pads the band to
// 16-wide tiles. Still to come: wgmma in place of WMMA, TMA staging, P'
// kept in registers between the softmax and P'.V, persistent CTAs, and
// sharing the softmax statistics with the backward's stage A.

#include "rel_attention.cuh"
#include "wmma_band.cuh"

namespace {

using namespace wmmaband;
using relattn::hash_bits;
using relattn::warp_max;
using relattn::warp_sum;

// output tiles of a QROWS x dh block that one warp owns, at most
constexpr int OUT_TILES = (QROWS / WM) * (MAX_DH / WM) / NWARPS;

__host__ __device__ inline int round32(int x) { return (x + 31) & ~31; }

// Floats of the region that holds S (QROWS x (nb + 4)), then each warp's
// 16 x 16 store tile.
__host__ __device__ inline int score_floats(int nb) {
  return imax(QROWS * (nb + 4), NWARPS * WM * WM);
}

// Shared memory of one CTA, in bytes: the Q tile and the double-buffered
// chunk (bf16), S, R and the inverse softmax sums (f32).
__host__ __device__ inline size_t fwd_smem(int T, int dh, int m) {
  const int nb = band_cols(T, m);
  const int ldr = imax(round16(2 * m - 1), nb) + 4;
  return sizeof(bf16) * (QROWS + 2 * KROWS) * (dh + 8) +
         sizeof(float) * (score_floats(nb) + QROWS * (ldr + 1));
}

__global__ void __launch_bounds__(NTHREADS)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ e,
           bf16* __restrict__ o, int H, int T, int dh, int m, int valid_len,
           float scale, unsigned seed, unsigned drop_threshold,
           float drop_scale, int b_offset, int h_offset, int H_total) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int W = 2 * m - 1;
  const int Wp = round16(W);
  const int nb = band_cols(T, m);
  const int ncp = round32(nb);  // P' columns, whole 32-row V chunks
  const int ldh = dh + 8;
  const int lds = nb + 4;
  const int ldr = imax(Wp, nb) + 4;
  const int ldp = ncp + 8;
  bf16* sA = reinterpret_cast<bf16*>(smem);   // QROWS x ldh: Q
  bf16* sX = sA + QROWS * ldh;                // 2 x KROWS x ldh: E, K, V
  float* sS = reinterpret_cast<float*>(sX + 2 * KROWS * ldh);  // S, then P
  float* sR = sS + score_floats(nb);          // QROWS x ldr: R
  float* sInv = sR + QROWS * ldr;             // QROWS: 1 / the softmax sum
  bf16* sP = reinterpret_cast<bf16*>(sR);     // QROWS x ldp: P', over R

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * QROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = ((size_t)b * H + h) * (size_t)T * dh;
  const bf16* vh = v + head;
  const int kb = imax(0, q0 - (m - 1)) & ~15;

  // R = Q . E^T over the 2m-1 relative slots, S = Q . K^T over the band
  stage_async(sA, ldh, q + head, dh, q0, QROWS, T, 0, dh, dh);
  band_product(sA, ldh, e + (size_t)h * W * dh, 0, W, Wp, sR, ldr, sX, dh);
  band_product(sA, ldh, k + head, kb, T, nb, sS, lds, sX, dh);

  // The first V chunk is in flight during the softmax; the P'.V pipeline
  // commits it with its chunk 0. (band_product ends with a barrier, so
  // the buffer is free.)
  stage_async(sX, ldh, vh, dh, kb, KROWS, T, 0, dh, dh);

  // Skewed relative logits, masks and the row softmax, one warp per row,
  // as in the backward's stage A. Cells that are not visible get P = 0
  // exactly, as exp(-1e8 - max) underflows to 0 in the reference; rows at
  // or past T are all zero.
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
  __syncthreads();  // R is no longer read: P' takes its place

  // P' = P * keep * drop_scale, rounded to bf16; 0 from nb to ncp
  const unsigned cell_seed =
      seed + (unsigned)((b_offset + b) * H_total + h_offset + h);
  for (int i = warp; i < QROWS; i += NWARPS) {
    const int qi = q0 + i;
    const float* srow = sS + i * lds;
    const float inv = sInv[i];
    bf16* prow = sP + i * ldp;
    for (int j = 2 * lane; j < ncp; j += 64) {
      float x[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int jj = j + u;
        const bool keep =
            drop_threshold == 0u ||
            hash_bits(qi, kb + jj, cell_seed) >= drop_threshold;
        x[u] = (jj < nb && keep) ? srow[jj] * inv * drop_scale : 0.f;
      }
      *reinterpret_cast<__nv_bfloat162*>(prow + j) =
          __floats2bfloat162_rn(x[0], x[1]);
    }
  }

  // O = P' . V over the band; the pipeline's first barrier orders the P'
  // writes before the products.
  const int ncol = dh / WM;
  const int ntile = (QROWS / WM) * ncol;
  Acc acc[OUT_TILES];
#pragma unroll
  for (int u = 0; u < OUT_TILES; ++u) wmma::fill_fragment(acc[u], 0.f);
  pipeline(
      ncp / KROWS,
      [&](int c, int buf) {
        if (c > 0)
          stage_async(sX + buf * KROWS * ldh, ldh, vh, dh, kb + c * KROWS,
                      KROWS, T, 0, dh, dh);
      },
      [&](int c, int buf) {
        const bf16* x = sX + buf * KROWS * ldh;
#pragma unroll
        for (int u = 0; u < OUT_TILES; ++u) {
          const int t = warp + u * NWARPS;
          if (t < ntile) {
            const int rt = t / ncol, ct = t - (t / ncol) * ncol;
            tile_mma<wmma::row_major, wmma::row_major>(
                acc[u], sP + rt * WM * ldp + c * KROWS, ldp, x + ct * WM,
                ldh, KROWS);
          }
        }
      });

  // S is no longer read: each warp's store tile lies in its region
  float* tile = sS + warp * WM * WM;
#pragma unroll
  for (int u = 0; u < OUT_TILES; ++u) {
    const int t = warp + u * NWARPS;
    if (t < ntile) {
      const int rt = t / ncol, ct = t - (t / ncol) * ncol;
      store_tile(o + head, dh, q0 + rt * WM, T, ct * WM, acc[u], 1.f, tile);
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one CTA takes, in bytes.
int rel_attention_fwd_wmma_smem_bytes(int T, int dh, int m) {
  return (int)fwd_smem(T, dh, m);
}

// q, k, v, o: (B, H, T, dh) contiguous bf16; e: (H, 2m-1, dh) contiguous
// bf16. drop_threshold 0 = no dropout; drop_scale is 1 / (1 -
// drop_threshold / 2^32). Launches on `stream` and returns the cudaError_t
// of the launch (0 on success).
int rel_attention_fwd_wmma(const void* q, const void* k, const void* v,
                           const void* e, void* o, int B, int H, int T,
                           int dh, int m, int valid_len, float scale,
                           unsigned seed, unsigned drop_threshold,
                           float drop_scale,
                           int b_offset, int h_offset, int H_total,
                                  void* stream) {
  if (B < 1 || H < 1 || T < 1 || m < 1 || dh < 16 || dh > MAX_DH ||
      dh % 16 != 0 || valid_len < 0 || valid_len > T ||
      relattn::bad_cells(B, H, b_offset, h_offset, H_total))
    return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(T, dh, m);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + QROWS - 1) / QROWS, H, B);
  fwd_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(e),
      static_cast<bf16*>(o), H, T, dh, m, valid_len, scale, seed,
      drop_threshold, drop_scale, b_offset, h_offset, H_total);
  return (int)cudaGetLastError();
}

const char* rel_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

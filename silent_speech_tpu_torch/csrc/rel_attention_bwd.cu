// Relative-position attention backward for Hopper (sm_90a), float32.
//
// Replaces, for float32 inputs, the backward of the TPU kernel
// `fused_rel_attention` (silent_speech_tpu/ops/pallas/rel_attention.py,
// `_bwd` -> pl.pallas_call at :414, body `_bwd_kernel` at :267); bfloat16
// inputs, the training step's, run the staged WMMA kernels of
// rel_attention_bwd_wmma.cu. Flash-style recompute: nothing quadratic is
// saved by the forward. Each CTA rebuilds its band's scores S, P =
// softmax(S) and the dropout keep mask (from the same counter hash and
// seed as the forward), then, with P' = P * keep * drop_scale:
//
//   dV[k]  = sum_q P'[q,k] dO[q]
//   dP     = dO . V^T
//   dS     = P' (.) dP - P (.) D,   D[q] = sum_k P'[q,k] dP[q,k]
//   dQ[q]  = scale * sum_k dS[q,k] K[k] + sum_r dR[q,r] E[r]
//   dK[k]  = scale * sum_q dS[q,k] Q[q]
//   dE[r]  = sum_b sum_q dR[q,r] Q[q]
//
// where dR[q, r] = dS[q, q + r - (m-1)] is the unskewed dS, zero where that
// key lies outside [0, T) (the TPU kernel's `col < 2m-1` guard).
//
// Design: the band pass of rel_attention.cuh (one CTA per 64-row query
// tile n, band scores in shared memory). D takes a first pass over the V
// chunks, dV and dS a second one (dP is recomputed, not stored); dS then
// overwrites P in place. dR is never materialized: dQ and dE read dS at
// the skewed index. A query row belongs to one CTA, so dQ is written
// directly. A key lies in the bands of several tiles and a relative slot
// in every tile of every batch row, so each CTA writes its share of dK
// and dV (its band rows) and of dE (every slot) into f32 partial buffers
// indexed by (b, h, n), and reduce_kernel sums them in a fixed order: dK
// and dV by key over the tiles whose band covers it, in tile order, dE
// over (b, n) in order. No atomics, so two calls on the same inputs give
// bit-equal results, as the TPU kernel's sequential grid does. Every
// product is f32 FMA on the CUDA cores, so the route keeps full f32
// precision (its tolerance against autograd is 1e-4 x max|ref|).
//
// What bounds it on the card. At the training shape in f32 (B=120, H=8,
// T=200, d_h=96, m=100) the function reads Q, K, V, E, dO and writes dQ,
// dK, dV, dE (~516 MB, ~0.15 ms at 3.35 TB/s) and needs ~2.7x the
// forward's band work (~44 GFLOP, ~0.66 ms at the 67 TFLOP/s f32 peak
// outside the tensor cores), so operations bound it. This kernel runs ~9
// band products per CTA, one ~195 KB CTA per SM, and is latency- and
// FMA-bound; the partials (~1.1 GB at that shape) add traffic on top. It
// serves the f32 step check and f32 callers, off the bf16 training step.

#include "rel_attention.cuh"

namespace {

using namespace relattn;

constexpr int NCOL = MAX_DH / 16;

// Shared memory: Q tile, R, band scores, staging chunk, dO tile (floats),
// the per-row sum D (floats) and the keep bits (BQ x ceil(lds/32) words).
__host__ __device__ inline int mask_words(int m) {
  return (Band(16, m).lds + 31) / 32;
}
__host__ __device__ inline size_t smem_bytes(int dh, int m) {
  const Band g(dh, m);
  const size_t floats = (size_t)BQ * g.ld + BQ * g.w + BQ * g.lds +
                        BK * g.ld + BQ * g.ld + BQ;
  return sizeof(float) * floats + sizeof(unsigned) * BQ * mask_words(m);
}

// Partials: dkp and dvp (B, H, NT, lds, dh), row j of tile n being key
// k_lo(n) + j; dep (B, H, NT, 2m-1, dh). NT = gridDim.x.
__global__ void __launch_bounds__(NTHREADS)
rel_attention_bwd_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ e,
                         const float* __restrict__ dout,
                         float* __restrict__ dq, float* __restrict__ dkp,
                         float* __restrict__ dvp, float* __restrict__ dep,
                         int H, int T_len, int dh, int m, int valid_len,
                         float scale, unsigned seed, unsigned drop_threshold,
                         float drop_scale,
                         int b_offset, int h_offset, int H_total) {
  extern __shared__ float smem[];
  const Band g(dh, m);
  const int mw = mask_words(m);
  float* sQ = smem;              // BQ x ld
  float* sR = sQ + BQ * g.ld;    // BQ x w
  float* sS = sR + BQ * g.w;     // BQ x lds: P, then dS
  float* sX = sS + BQ * g.lds;   // BK x ld: a chunk of E, K or V
  float* sDO = sX + BK * g.ld;   // BQ x ld
  float* sD = sDO + BQ * g.ld;   // BQ
  unsigned* sM = reinterpret_cast<unsigned*>(sD + BQ);  // BQ x mw

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = ((size_t)b * H + h) * (size_t)T_len * dh;
  const float* kh = k + head;
  const float* vh = v + head;
  const float* eh = e + (size_t)h * g.w * dh;
  // this CTA's partials: (b, h, tile)
  const size_t part = ((size_t)b * H + h) * gridDim.x + blockIdx.x;
  float* dkh = dkp + part * g.lds * dh;
  float* dvh = dvp + part * g.lds * dh;
  float* deh = dep + part * g.w * dh;
  const int ncol = dh / 16;

  const int k_lo = max(0, q0 - (m - 1));
  const int k_hi = min(T_len, q0 + BQ + m - 1);
  const int nk = k_hi - k_lo;

  band_softmax(q + head, kh, eh, sQ, sR, sS, sX, g, q0, k_lo, k_hi, T_len,
               dh, m, valid_len, scale);

  // The forward's keep mask, one bit per band cell, and D = 0.
  const unsigned cell_seed =
      seed + (unsigned)((b_offset + b) * H_total + h_offset + h);
  for (int i = warp; i < BQ; i += NWARPS) {
    for (int j0 = 0; j0 < nk; j0 += 32) {
      const int j = j0 + lane;
      const bool keep =
          j < nk && (drop_threshold == 0u ||
                     hash_bits(q0 + i, k_lo + j, cell_seed) >= drop_threshold);
      const unsigned word = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) sM[i * mw + (j0 >> 5)] = word;
    }
    if (lane == 0) sD[i] = 0.f;
  }
  stage_rows(sDO, g.ld, dout + head, q0, BQ, T_len, dh);
  __syncthreads();

  // P' at band cell (i, j), from P in sS and the keep bit.
  auto post = [&](int i, int j) -> float {
    return ((sM[i * mw + (j >> 5)] >> (j & 31)) & 1u)
               ? sS[i * g.lds + j] * drop_scale
               : 0.f;
  };

  float acc[4][4];
  // Pass 1: D[i] = sum_j P'[i,j] dP[i,j].
  for (int c0 = 0; c0 < nk; c0 += BK) {
    stage_rows(sX, g.ld, vh, k_lo + c0, BK, k_hi, dh);
    __syncthreads();
    dot_nt(sDO, sX, g.ld, dh, acc);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float part = 0.f;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int j = c0 + tx + 16 * bb;
        if (j < nk) part = fmaf(post(ty + 16 * a, j), acc[a][bb], part);
      }
      part = row_sum16(part);
      if (tx == 0) sD[ty + 16 * a] += part;
    }
    __syncthreads();
  }

  // Pass 2, per chunk of 64 keys: dP again, dV from P', then dS over P.
  for (int c0 = 0; c0 < nk; c0 += BK) {
    stage_rows(sX, g.ld, vh, k_lo + c0, BK, k_hi, dh);
    __syncthreads();
    dot_nt(sDO, sX, g.ld, dh, acc);

    // dV rows ty + 16a of the chunk, columns tx + 16c.
    float vacc[4][NCOL];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < NCOL; ++c) vacc[a][c] = 0.f;
    for (int i = 0; i < BQ; ++i) {
      float p[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = c0 + ty + 16 * a;
        p[a] = j < nk ? post(i, j) : 0.f;
      }
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        if (c < ncol) {
          const float x = sDO[i * g.ld + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) vacc[a][c] = fmaf(p[a], x, vacc[a][c]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = c0 + ty + 16 * a;
      if (j >= nk) continue;
#pragma unroll
      for (int c = 0; c < NCOL; ++c)
        if (c < ncol)
          dvh[(size_t)j * dh + tx + 16 * c] = vacc[a][c];
    }
    __syncthreads();  // every read of this chunk's P is done

#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int i = ty + 16 * a;
        const int j = c0 + tx + 16 * bb;
        if (j < nk)
          sS[i * g.lds + j] = post(i, j) * acc[a][bb] - sS[i * g.lds + j] * sD[i];
      }
    __syncthreads();
  }
  // sS now holds dS over the band.

  // dK: rows ty + 16a of each 64-key chunk, columns tx + 16c.
  for (int c0 = 0; c0 < nk; c0 += BK) {
    float kacc[4][NCOL];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < NCOL; ++c) kacc[a][c] = 0.f;
    for (int i = 0; i < BQ; ++i) {
      float s[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = c0 + ty + 16 * a;
        s[a] = j < nk ? sS[i * g.lds + j] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        if (c < ncol) {
          const float x = sQ[i * g.ld + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) kacc[a][c] = fmaf(s[a], x, kacc[a][c]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = c0 + ty + 16 * a;
      if (j >= nk) continue;
#pragma unroll
      for (int c = 0; c < NCOL; ++c)
        if (c < ncol)
          dkh[(size_t)j * dh + tx + 16 * c] = kacc[a][c] * scale;
    }
  }

  // dQ: rows ty + 16a, columns tx + 16c; content part over the K band,
  // then the relative part over the E chunks.
  float qacc[4][NCOL];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NCOL; ++c) qacc[a][c] = 0.f;
  for (int c0 = 0; c0 < nk; c0 += BK) {
    stage_rows(sX, g.ld, kh, k_lo + c0, BK, k_hi, dh);
    __syncthreads();
    const int jn = min(BK, nk - c0);
    for (int j = 0; j < jn; ++j) {
      float s[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) s[a] = sS[(ty + 16 * a) * g.lds + c0 + j];
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        if (c < ncol) {
          const float x = sX[j * g.ld + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) qacc[a][c] = fmaf(s[a], x, qacc[a][c]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NCOL; ++c) qacc[a][c] *= scale;
  // band column of dR[i, r]: q0 + i + r - (m-1) - k_lo
  const int skew = q0 - (m - 1) - k_lo;
  for (int r0 = 0; r0 < g.w; r0 += BK) {
    stage_rows(sX, g.ld, eh, r0, BK, g.w, dh);
    __syncthreads();
    const int rn = min(BK, g.w - r0);
    for (int rr = 0; rr < rn; ++rr) {
      float s[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        const int j = i + r0 + rr + skew;
        s[a] = (j >= 0 && j < nk) ? sS[i * g.lds + j] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        if (c < ncol) {
          const float x = sX[rr * g.ld + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) qacc[a][c] = fmaf(s[a], x, qacc[a][c]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qi = q0 + ty + 16 * a;
    if (qi >= T_len) continue;
#pragma unroll
    for (int c = 0; c < NCOL; ++c)
      if (c < ncol)
        dq[head + (size_t)qi * dh + tx + 16 * c] = qacc[a][c];
  }

  // dE: slots ty + 16a of each 64-slot chunk, columns tx + 16c.
  for (int r0 = 0; r0 < g.w; r0 += BK) {
    float eacc[4][NCOL];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < NCOL; ++c) eacc[a][c] = 0.f;
    for (int i = 0; i < BQ; ++i) {
      float s[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = r0 + ty + 16 * a;
        const int j = i + r + skew;
        s[a] = (r < g.w && j >= 0 && j < nk) ? sS[i * g.lds + j] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        if (c < ncol) {
          const float x = sQ[i * g.ld + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) eacc[a][c] = fmaf(s[a], x, eacc[a][c]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = r0 + ty + 16 * a;
      if (r >= g.w) continue;
#pragma unroll
      for (int c = 0; c < NCOL; ++c)
        if (c < ncol)
          deh[(size_t)r * dh + tx + 16 * c] = eacc[a][c];
    }
  }
}

// dK and dV: each key's rows of the tiles whose band covers it, in tile
// order; dE: each slot's rows over (b, tile) in order. One thread per
// output element of dK and dV together, then of dE.
__global__ void reduce_kernel(const float* __restrict__ dkp,
                              const float* __restrict__ dvp,
                              const float* __restrict__ dep,
                              float* __restrict__ dk, float* __restrict__ dv,
                              float* __restrict__ de, int B, int H, int T_len,
                              int dh, int m, int n_tiles) {
  const Band g(dh, m);
  const size_t n_kv = (size_t)B * H * T_len * dh;
  const size_t n_e = (size_t)H * g.w * dh;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n_kv + n_e; idx += (size_t)gridDim.x * blockDim.x) {
    if (idx < n_kv) {
      const size_t bh = idx / ((size_t)T_len * dh);
      const int key = (int)(idx / dh % T_len);
      const int c = (int)(idx % dh);
      float sk = 0.f, sv = 0.f;
      for (int n = 0; n < n_tiles; ++n) {
        const int k_lo = max(0, n * BQ - (m - 1));
        const int k_hi = min(T_len, n * BQ + BQ + m - 1);
        if (key < k_lo || key >= k_hi) continue;
        const size_t at =
            ((bh * n_tiles + n) * g.lds + (key - k_lo)) * dh + c;
        sk += dkp[at];
        sv += dvp[at];
      }
      dk[idx] = sk;
      dv[idx] = sv;
    } else {
      const size_t i = idx - n_kv;
      const int h = (int)(i / ((size_t)g.w * dh));
      const size_t rc = i % ((size_t)g.w * dh);  // r * dh + c
      float sum = 0.f;
      for (int b = 0; b < B; ++b)
        for (int n = 0; n < n_tiles; ++n)
          sum += dep[(((size_t)b * H + h) * n_tiles + n) * g.w * dh + rc];
      de[i] = sum;
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one CTA needs, in bytes, for head width dh and window m.
int rel_attention_bwd_smem_bytes(int dh, int m) {
  return (int)smem_bytes(dh, m);
}

// Elements of each partial buffer, for the shape (B, H, T, dh, m): dkp
// and dvp take `which` = 0, dep `which` = 1.
long long rel_attention_bwd_partial_elems(int which, int B, int H, int T_len,
                                          int dh, int m) {
  const Band g(dh, m);
  const long long tiles = (long long)B * H * ((T_len + BQ - 1) / BQ);
  return tiles * (which == 0 ? g.lds : g.w) * dh;
}

// q, k, v, dout, dq, dk, dv: (B, H, T, dh) contiguous f32; e, de: (H,
// 2m-1, dh) contiguous f32. dkp, dvp, dep: f32 scratch of
// rel_attention_bwd_partial_elems elements, written before they are read.
// is_bf16 must be 0: bf16 inputs go to the rel_attention_bwd_wmma stages.
// Launches both kernels on `stream` and returns the cudaError_t of the
// launches.
int rel_attention_bwd(const void* q, const void* k, const void* v,
                      const void* e, const void* dout, void* dq, void* dk,
                      void* dv, void* de, void* dkp, void* dvp, void* dep,
                      int B, int H, int T_len, int dh, int m, int valid_len,
                      float scale, unsigned seed, unsigned drop_threshold,
                      float drop_scale,
                      int b_offset, int h_offset, int H_total, int is_bf16,
                      void* stream) {
  if (is_bf16 || B < 1 || H < 1 || T_len < 1 || m < 1 || dh < 16 ||
      dh > MAX_DH || dh % 16 != 0 || valid_len < 0 || valid_len > T_len ||
      bad_cells(B, H, b_offset, h_offset, H_total))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(dh, m);
  cudaError_t err = cudaFuncSetAttribute(
      rel_attention_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (T_len + BQ - 1) / BQ;
  const dim3 grid(n_tiles, H, B);
  rel_attention_bwd_kernel<<<grid, NTHREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(e),
      static_cast<const float*>(dout), static_cast<float*>(dq),
      static_cast<float*>(dkp), static_cast<float*>(dvp),
      static_cast<float*>(dep), H, T_len, dh, m, valid_len, scale, seed,
      drop_threshold, drop_scale, b_offset, h_offset, H_total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * H * T_len * dh + (size_t)H * (2 * m - 1) * dh;
  const int blocks = (int)((n + NTHREADS - 1) / NTHREADS);
  reduce_kernel<<<blocks < 65535 ? blocks : 65535, NTHREADS, 0, s>>>(
      static_cast<const float*>(dkp), static_cast<const float*>(dvp),
      static_cast<const float*>(dep), static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(de), B, H, T_len, dh, m,
      n_tiles);
  return (int)cudaGetLastError();
}

const char* rel_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Shared pieces of the relative-position attention kernels for Hopper
// (rel_attention_fwd.cu, rel_attention_bwd.cu): tiling constants, staging
// and dot-product helpers, the dropout counter hash, and the band softmax
// that both the forward and the backward (which recomputes it) run.
//
// Tiling. One CTA per (64-row query tile, head, batch). A tile only sees
// the key band [q0 - (m-1), q0 + 63 + (m-1)]. The relative logits of the
// tile are one product R = Q_tile . E_h^T (64 x (2m-1)); the TPU kernel's
// barrel-shifter skew becomes the index k - q + m - 1 into R. Scores for
// the whole band sit in shared memory in f32, so the softmax is exact.
// All arithmetic is f32 FMA on the CUDA cores, whatever the input type.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace relattn {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // rows of E, K or V staged per chunk
constexpr int NTHREADS = 256;   // a 16 x 16 grid of threads
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_DH = 128;
constexpr float NEG = -1e8f;    // the reference's out-of-window logit

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The counter hash of the JAX kernel's interpret mode (`_hash_bits`,
// silent_speech_tpu/ops/pallas/rel_attention.py): row = query index,
// col = key index, seed = (step seed + b*H + h) mod 2^32.
__device__ __forceinline__ unsigned hash_bits(unsigned r, unsigned c,
                                              unsigned seed) {
  unsigned x = (r * 0x9E3779B1u) ^ (c * 0x85EBCA77u) ^ seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// Copy rows [r0, r0 + rows) of a row-major (*, dh) matrix into shared
// memory as f32 with row stride ld; rows outside [0, n_rows) read as 0.
template <typename T>
__device__ void stage_rows(float* dst, int ld, const T* src, int r0, int rows,
                           int n_rows, int dh) {
  for (int idx = threadIdx.x; idx < rows * dh; idx += NTHREADS) {
    const int r = idx / dh;
    const int c = idx - r * dh;
    const int g = r0 + r;
    dst[r * ld + c] =
        (g >= 0 && g < n_rows) ? to_f32(src[(size_t)g * dh + c]) : 0.f;
  }
}

// acc[a][b] = A[ty + 16a] . B[tx + 16b] over dh, for a 64 x 64 block;
// A and B are row-major in shared memory.
__device__ __forceinline__ void dot_nt(const float* A, const float* B, int ld,
                                       int dh, float acc[4][4]) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  for (int d = 0; d < dh; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A[(ty + 16 * a) * ld + d];
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = B[(tx + 16 * b) * ld + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum over the 16 threads of one row of the 16 x 16 thread grid (the two
// halves of a warp hold two rows).
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Geometry of one CTA's band, in floats of shared memory.
struct Band {
  int ld;   // row stride of Q, K, V, E, dO tiles (odd: no bank conflicts)
  int w;    // relative slots 2m - 1
  int lds;  // row stride of the band scores
  __host__ __device__ Band(int dh, int m)
      : ld(dh + 1), w(2 * m - 1), lds(BQ + 2 * (m - 1) + 1) {}
};

// Stage the Q tile into sQ, compute R = Q.E^T into sR, the band scores
// into sS, and turn each row of sS into softmax probabilities (P before
// dropout). sX is a BK x ld staging buffer. Ends with __syncthreads().
template <typename T>
__device__ void band_softmax(const T* qh, const T* kh, const T* eh,
                             float* sQ, float* sR, float* sS, float* sX,
                             const Band& g, int q0, int k_lo, int k_hi,
                             int T_len, int dh, int m, int valid_len,
                             float scale) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int nk = k_hi - k_lo;
  stage_rows(sQ, g.ld, qh, q0, BQ, T_len, dh);
  __syncthreads();

  float acc[4][4];
  // R = Q_tile . E_h^T over the 2m-1 relative slots.
  for (int r0 = 0; r0 < g.w; r0 += BK) {
    stage_rows(sX, g.ld, eh, r0, BK, g.w, dh);
    __syncthreads();
    dot_nt(sQ, sX, g.ld, dh, acc);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int r = r0 + tx + 16 * bb;
        if (r < g.w) sR[(ty + 16 * a) * g.w + r] = acc[a][bb];
      }
    __syncthreads();
  }

  // Scores over the key band; the skew is the index k - q + m - 1 into R.
  for (int c0 = 0; c0 < nk; c0 += BK) {
    stage_rows(sX, g.ld, kh, k_lo + c0, BK, k_hi, dh);
    __syncthreads();
    dot_nt(sQ, sX, g.ld, dh, acc);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int i = ty + 16 * a;
        const int j = c0 + tx + 16 * bb;
        if (j < nk) {
          const int qi = q0 + i;
          const int kj = k_lo + j;
          const int rel = kj - qi;
          const bool visible = rel >= 1 - m && rel <= m - 1 &&
                               ((kj < valid_len) == (qi < valid_len));
          sS[i * g.lds + j] =
              visible ? fmaf(acc[a][bb], scale, sR[i * g.w + rel + m - 1])
                      : NEG;
        }
      }
    __syncthreads();
  }

  // Row softmax, one warp per row.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = warp; i < BQ; i += NWARPS) {
    float* row = sS + i * g.lds;
    float mx = -INFINITY;
    for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float p = expf(row[j] - mx);
      row[j] = p;
      sum += p;
    }
    const float inv = 1.f / warp_sum(sum);
    for (int j = lane; j < nk; j += 32) row[j] *= inv;
  }
  __syncthreads();
}

}  // namespace relattn

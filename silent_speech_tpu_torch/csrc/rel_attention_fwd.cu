// Relative-position attention forward for Hopper (sm_90a), serving path.
//
// Replaces the forward of the TPU kernel `fused_rel_attention`
// (silent_speech_tpu/ops/pallas/rel_attention.py, `_fwd` -> pl.pallas_call,
// body `_fwd_kernel`) with its dropout off. For query q and key k of one
// (batch, head):
//
//   s[q,k] = (q.k) * scale + q . E_h[k - q + m - 1]
//            when |k - q| <= m - 1 and (k < L) == (q < L), else -1e8
//   O[q]   = softmax_k(s[q, :]) . V           (row max subtracted)
//
// L is the utterance's valid length inside a bucket-padded sequence. With
// L == T this is the TPU kernel's forward; with L < T it is the
// segment-masked forward the JAX serving bundle runs.
//
// Design. One CTA per (64-row query tile, head, batch). A tile only sees
// the key band [q0 - (m-1), q0 + 63 + (m-1)], so a CTA never reads the
// keys outside it. The relative logits of the tile are one product
// R = Q_tile . E_h^T (64 x (2m-1)); the TPU kernel's barrel-shifter skew
// becomes the index k - q + m - 1 into R. Scores for the whole band sit in
// shared memory in f32, so the softmax is exact (no online rescaling).
// All arithmetic is f32 FMA on the CUDA cores, whatever the input type.
//
// What bounds it on the card. At the serving shape (B=1, H=8, d_h=96,
// m=100, T=1024, bf16) the function moves ~6.6 MB (bound ~2 us at
// 3.35 TB/s) and needs ~0.9 GFLOP (~1 us on the bf16 tensor cores), so the
// bound is bytes. This kernel is bound by neither: it does ~1.1 GFLOP of
// band work (Q.E^T over all 2m-1 slots, Q.K^T and P.V over the band) on
// the f32 CUDA cores with 8*T/64 CTAs (128 at T=1024) on 132 SMs, one CTA
// per SM for its ~168 KB of shared memory, so it is latency-bound and
// under-fills the card. Tensor-core products (wgmma), TMA staging and more
// CTAs per SM are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // rows of E, K or V staged per chunk
constexpr int NTHREADS = 256;   // a 16 x 16 grid of threads
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

// Shared memory, in floats: Q tile, R, band scores, one staging chunk.
// Odd row strides keep the column-wise reads of dot_nt off one bank.
__host__ __device__ inline int smem_floats(int dh, int m) {
  const int ld = dh + 1;
  const int w = 2 * m - 1;
  const int lds = BQ + 2 * (m - 1) + 1;
  return BQ * ld + BQ * w + BQ * lds + BK * ld;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
rel_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ e,
                         T* __restrict__ o, int H, int T_len, int dh, int m,
                         int valid_len, float scale) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  const int w = 2 * m - 1;
  const int lds = BQ + 2 * (m - 1) + 1;
  float* sQ = smem;            // BQ x ld
  float* sR = sQ + BQ * ld;    // BQ x w
  float* sS = sR + BQ * w;     // BQ x lds
  float* sX = sS + BQ * lds;   // BK x ld: a chunk of E, K or V

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = ((size_t)b * H + h) * (size_t)T_len * dh;
  const T* qh = q + head;
  const T* kh = k + head;
  const T* vh = v + head;
  const T* eh = e + (size_t)h * w * dh;
  T* oh = o + head;

  const int k_lo = max(0, q0 - (m - 1));
  const int k_hi = min(T_len, q0 + BQ + m - 1);
  const int nk = k_hi - k_lo;

  stage_rows(sQ, ld, qh, q0, BQ, T_len, dh);
  __syncthreads();

  float acc[4][4];
  // R = Q_tile . E_h^T over the 2m-1 relative slots.
  for (int r0 = 0; r0 < w; r0 += BK) {
    stage_rows(sX, ld, eh, r0, BK, w, dh);
    __syncthreads();
    dot_nt(sQ, sX, ld, dh, acc);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int r = r0 + tx + 16 * bb;
        if (r < w) sR[(ty + 16 * a) * w + r] = acc[a][bb];
      }
    __syncthreads();
  }

  // Scores over the key band; the skew is the index k - q + m - 1 into R.
  for (int c0 = 0; c0 < nk; c0 += BK) {
    stage_rows(sX, ld, kh, k_lo + c0, BK, k_hi, dh);
    __syncthreads();
    dot_nt(sQ, sX, ld, dh, acc);
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
          sS[i * lds + j] =
              visible ? fmaf(acc[a][bb], scale, sR[i * w + rel + m - 1])
                      : NEG;
        }
      }
    __syncthreads();
  }

  // Row softmax, one warp per row.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int i = warp; i < BQ; i += NTHREADS / 32) {
    float* row = sS + i * lds;
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

  // O = P . V_band, f32 accumulators in registers: rows ty + 16a,
  // columns tx + 16c.
  float oacc[4][MAX_DH / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < MAX_DH / 16; ++c) oacc[a][c] = 0.f;
  const int ncol = dh / 16;
  for (int c0 = 0; c0 < nk; c0 += BK) {
    stage_rows(sX, ld, vh, k_lo + c0, BK, k_hi, dh);
    __syncthreads();
    const int jn = min(BK, nk - c0);
    for (int j = 0; j < jn; ++j) {
      float p[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) p[a] = sS[(ty + 16 * a) * lds + c0 + j];
#pragma unroll
      for (int c = 0; c < MAX_DH / 16; ++c) {
        if (c < ncol) {
          const float x = sX[j * ld + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) oacc[a][c] = fmaf(p[a], x, oacc[a][c]);
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
    for (int c = 0; c < MAX_DH / 16; ++c)
      if (c < ncol)
        oh[(size_t)qi * dh + tx + 16 * c] = from_f32<T>(oacc[a][c]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* e,
                   void* o, int B, int H, int T_len, int dh, int m,
                   int valid_len, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)smem_floats(dh, m);
  cudaError_t err = cudaFuncSetAttribute(
      rel_attention_fwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + BQ - 1) / BQ, H, B);
  rel_attention_fwd_kernel<T><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(e), static_cast<T*>(o),
      H, T_len, dh, m, valid_len, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one CTA needs, in bytes, for head width dh and window m.
int rel_attention_fwd_smem_bytes(int dh, int m) {
  return (int)(sizeof(float) * (size_t)smem_floats(dh, m));
}

// q, k, v, o: (B, H, T, dh) contiguous; e: (H, 2m-1, dh) contiguous; all
// bf16 when is_bf16, else f32. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success).
int rel_attention_fwd(const void* q, const void* k, const void* v,
                      const void* e, void* o, int B, int H, int T_len, int dh,
                      int m, int valid_len, float scale, int is_bf16,
                      void* stream) {
  if (B < 1 || H < 1 || T_len < 1 || m < 1 || dh < 16 || dh > MAX_DH ||
      dh % 16 != 0 || valid_len < 0 || valid_len > T_len)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(q, k, v, e, o, B, H, T_len, dh, m,
                                      valid_len, scale, s);
  return (int)launch<float>(q, k, v, e, o, B, H, T_len, dh, m, valid_len,
                            scale, s);
}

const char* rel_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

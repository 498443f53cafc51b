// Relative-position attention forward for Hopper (sm_90a), float32, with
// the probability dropout of training.
//
// Replaces, for float32 inputs, the forward of the TPU kernel
// `fused_rel_attention` (silent_speech_tpu/ops/pallas/rel_attention.py,
// `_fwd` -> pl.pallas_call at :386, body `_fwd_kernel` at :251); bfloat16
// inputs, the training step's and serving's, run rel_attention_fwd_wmma.cu
// on the tensor cores. For query q and key k of one (batch b, head h):
//
//   s[q,k] = (q.k) * scale + q . E_h[k - q + m - 1]
//            when |k - q| <= m - 1 and (k < L) == (q < L), else -1e8
//   P[q]   = softmax_k(s[q, :])                 (row max subtracted)
//   P'     = P * keep / (1 - t / 2^32),  keep = hash(q, k, cell) >= t
//            (the cell of rel_attention.cuh)
//   O[q]   = P'[q] . V
//
// L is the utterance's valid length inside a bucket-padded sequence (serving;
// L == T in training). t = 0 turns dropout off. The hash is the one the JAX
// kernel runs off the TPU, so the mask is bit-identical to the JAX kernel's
// in interpret mode and to the plain PyTorch version.
//
// Design: rel_attention.cuh (one CTA per 64-row query tile; the band's
// scores stay in shared memory, so the softmax is exact). Dropout is
// applied in place to the band's probabilities before P'.V. Every product
// is f32 FMA on the CUDA cores, so the f32 route keeps full f32 precision
// (the f32 step check holds the kernels to 1e-4 of the plain versions).
//
// What bounds it on the card. At the training shape in f32 (B=120, H=8,
// T=200, d_h=96, m=100) the function moves ~294 MB (~88 us at 3.35 TB/s)
// and needs ~17 GFLOP of band work (~0.25 ms at the 67 TFLOP/s f32 peak
// outside the tensor cores), so operations bound it. This kernel runs one
// ~168 KB CTA per SM and is latency-bound. It serves the f32 step check
// and f32 callers, off the bf16 training step and serving.

#include "rel_attention.cuh"

namespace {

using namespace relattn;

// Shared memory, in floats: Q tile, R, band scores, one staging chunk.
__host__ __device__ inline int smem_floats(int dh, int m) {
  const Band g(dh, m);
  return BQ * g.ld + BQ * g.w + BQ * g.lds + BK * g.ld;
}

__global__ void __launch_bounds__(NTHREADS)
rel_attention_fwd_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ e, float* __restrict__ o,
                         int H, int T_len, int dh, int m,
                         int valid_len, float scale, unsigned seed,
                         unsigned drop_threshold, float drop_scale,
                         int b_offset, int h_offset, int H_total) {
  extern __shared__ float smem[];
  const Band g(dh, m);
  float* sQ = smem;              // BQ x ld
  float* sR = sQ + BQ * g.ld;    // BQ x w
  float* sS = sR + BQ * g.w;     // BQ x lds
  float* sX = sS + BQ * g.lds;   // BK x ld: a chunk of E, K or V

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t head = ((size_t)b * H + h) * (size_t)T_len * dh;
  const float* vh = v + head;
  float* oh = o + head;

  const int k_lo = max(0, q0 - (m - 1));
  const int k_hi = min(T_len, q0 + BQ + m - 1);
  const int nk = k_hi - k_lo;

  band_softmax(q + head, k + head, e + (size_t)h * g.w * dh, sQ, sR, sS, sX,
               g, q0, k_lo, k_hi, T_len, dh, m, valid_len, scale);

  if (drop_threshold != 0u) {
    const unsigned cell_seed =
        seed + (unsigned)((b_offset + b) * H_total + h_offset + h);
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    for (int i = warp; i < BQ; i += NWARPS) {
      float* row = sS + i * g.lds;
      for (int j = lane; j < nk; j += 32) {
        const bool keep =
            hash_bits(q0 + i, k_lo + j, cell_seed) >= drop_threshold;
        row[j] = keep ? row[j] * drop_scale : 0.f;
      }
    }
    __syncthreads();
  }

  // O = P' . V_band, f32 accumulators in registers: rows ty + 16a,
  // columns tx + 16c.
  float oacc[4][MAX_DH / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < MAX_DH / 16; ++c) oacc[a][c] = 0.f;
  const int ncol = dh / 16;
  for (int c0 = 0; c0 < nk; c0 += BK) {
    stage_rows(sX, g.ld, vh, k_lo + c0, BK, k_hi, dh);
    __syncthreads();
    const int jn = min(BK, nk - c0);
    for (int j = 0; j < jn; ++j) {
      float p[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) p[a] = sS[(ty + 16 * a) * g.lds + c0 + j];
#pragma unroll
      for (int c = 0; c < MAX_DH / 16; ++c) {
        if (c < ncol) {
          const float x = sX[j * g.ld + tx + 16 * c];
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
        oh[(size_t)qi * dh + tx + 16 * c] = oacc[a][c];
  }
}

}  // namespace

extern "C" {

// Shared memory one CTA needs, in bytes, for head width dh and window m.
int rel_attention_fwd_smem_bytes(int dh, int m) {
  return (int)(sizeof(float) * (size_t)smem_floats(dh, m));
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
      bad_cells(B, H, b_offset, h_offset, H_total))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)smem_floats(dh, m);
  cudaError_t err = cudaFuncSetAttribute(
      rel_attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_len + BQ - 1) / BQ, H, B);
  rel_attention_fwd_kernel<<<grid, NTHREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(e),
      static_cast<float*>(o), H, T_len, dh, m, valid_len, scale, seed,
      drop_threshold, drop_scale, b_offset, h_offset, H_total);
  return (int)cudaGetLastError();
}

const char* rel_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

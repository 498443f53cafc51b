// Zero-phase IIR filter chain (scipy's filtfilt, applied filter after
// filter) over ragged columns, for Hopper (sm_90a).
//
// Not a port of a TPU kernel: the JAX package runs this recurrence as a
// lax.scan under XLA (silent_speech_tpu/dsp/jax_filters.py:49-66, masked
// per utterance at :103-148), one filtfilt after another for the EMG
// cleaning chain (silent_speech_tpu/dsp/jax_pipeline.py:34-43: seven
// notches at 60*k Hz, Q = 30, then a 3rd-order 2 Hz Butterworth
// high-pass). A scan in plain PyTorch is one small launch per sample, so
// the whole chain is one kernel here.
//
// Per filter (b, a normalized by a[0], nd = ntaps - 1 delays, padlen
// p = 3 * ntaps) and per column of valid length L > p, exactly the plain
// version's float32 operations in its order (silent_speech_tpu_torch/
// dsp/device_filters.py, filtfilt_masked_plain):
//
//   ext = [2*x[0] - x[p-k] for k < p] ++ x[0..L) ++
//         [2*x[L-1] - x[L-2-k] for k < p]                  (L + 2p samples)
//   forward DF2T from z = zi * ext[0]:
//     y = b0*e + z0;  z[k] = (z[k+1] + b[k+1]*e) - a[k+1]*y  (z[nd] = 0)
//   the same recurrence over y reversed, from z = zi * y[L+2p-1];
//   out[t] = that result at step L + p - 1 - t, t < L.
//
// Every product, sum and difference is an explicit round-to-nearest
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn), so nvcc contracts nothing
// into an FMA and the kernel is bit-equal to the plain version. A column
// never reads another column, so its result does not depend on which
// columns share the launch.
//
// What bounds it on the card: it reads the (B, T_pad, C) input once and
// writes the output once (a few tens of MB for a corpus, microseconds at
// 3.35 TB/s), but every filter is a chain of dependent steps, two passes
// of L + 2p each, 16 passes for the cleaning chain. Its figure of merit is
// the time per step.
//
// Design: one thread per (utterance, channel) column, its delays in
// registers. The column lives in a time-major scratch of (T_pad + 2P)
// rows by B*C columns (P the chain's largest padlen), at row offset P, so
// the 32 threads of a warp touch 128 consecutive bytes at every step.
// Each filter writes its odd extensions around the signal, runs the
// forward pass in place (step j overwrites ext[j] with y[j]) and the
// reverse pass in place (its step t reads y at row total-1-t and writes
// its result there), which leaves the filtered signal at offset P for
// the next filter. Loads run a block of UNROLL steps ahead in registers,
// so the memory latency overlaps the chain of the block before.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_FILTERS = 16;
constexpr int MAX_DELAYS = 3;   // filters of up to 4 taps
constexpr int UNROLL = 16;
constexpr int THREADS = 32;     // one warp a CTA: few columns spread wide

struct Chain {
  int n;
  int nd[MAX_FILTERS];
  float b[MAX_FILTERS][MAX_DELAYS + 1];
  float a[MAX_FILTERS][MAX_DELAYS + 1];
  float zi[MAX_FILTERS][MAX_DELAYS];
};

// One DF2T step: y = b0*e + z0, then the delays (explicit roundings).
template <int ND>
__device__ __forceinline__ float df2t(float e, float (&z)[ND],
                                      const float* b, const float* a) {
  const float y = __fadd_rn(__fmul_rn(b[0], e), z[0]);
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    const float shifted = (k + 1 < ND) ? z[k + 1] : 0.0f;
    z[k] = __fsub_rn(__fadd_rn(shifted, __fmul_rn(b[k + 1], e)),
                     __fmul_rn(a[k + 1], y));
  }
  return y;
}

// One pass over `total` rows of column `col`: rows base + j for j in
// [0, total) forward (dir = +1) or base + total - 1 - j (dir = -1); each
// step's result overwrites the row it read.
template <int ND>
__device__ __forceinline__ void run_pass(float* s, long cols, int col,
                                         int first, int dir, int total,
                                         int rows, const float* b,
                                         const float* a, const float* zi) {
  auto row = [&](int j) {
    int r = first + dir * j;
    r = r < 0 ? 0 : (r >= rows ? rows - 1 : r);   // prefetch past the ends
    return s + (long)r * cols + col;
  };
  float z[ND];
  const float e0 = *row(0);
#pragma unroll
  for (int k = 0; k < ND; ++k) z[k] = __fmul_rn(zi[k], e0);
  float cur[UNROLL], nxt[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) cur[u] = *row(u);
  for (int jb = 0; jb < total; jb += UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) nxt[u] = *row(jb + UNROLL + u);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (jb + u < total) *row(jb + u) = df2t<ND>(cur[u], z, b, a);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) cur[u] = nxt[u];
  }
}

template <int ND>
__device__ void run_filter(float* s, long cols, int col, int L, int P,
                           int rows, const float* b, const float* a,
                           const float* zi) {
  const int p = 3 * (ND + 1);
  const int base = P - p;
  float* x = s + (long)P * cols + col;   // x[t] = x[t * cols]
  const float x0 = x[0];
  const float xl = x[(long)(L - 1) * cols];
  // odd extensions: the back one first, from the samples before the end
  for (int k = 0; k < p; ++k)
    x[(long)(L + k) * cols] =
        __fsub_rn(__fmul_rn(2.0f, xl), x[(long)(L - 2 - k) * cols]);
  for (int k = 0; k < p; ++k)
    s[(long)(base + k) * cols + col] =
        __fsub_rn(__fmul_rn(2.0f, x0), x[(long)(p - k) * cols]);
  const int total = L + 2 * p;
  run_pass<ND>(s, cols, col, base, 1, total, rows, b, a, zi);
  run_pass<ND>(s, cols, col, base + total - 1, -1, total, rows, b, a, zi);
}

__global__ void __launch_bounds__(THREADS)
filtfilt_chain_kernel(const float* __restrict__ x,
                      const int* __restrict__ lengths,
                      float* __restrict__ out, float* __restrict__ scratch,
                      Chain chain, int B, int T_pad, int C, int P) {
  const int col = blockIdx.x * THREADS + threadIdx.x;
  const long cols = (long)B * C;
  if (col >= cols) return;
  const int u = col / C, c = col - u * C;
  const int L = lengths[u];
  const int rows = T_pad + 2 * P;
  const float* xin = x + (long)u * T_pad * C + c;
  float* xout = out + (long)u * T_pad * C + c;
  float* sig = scratch + (long)P * cols + col;
  for (int t = 0; t < L; ++t) sig[(long)t * cols] = xin[(long)t * C];
  for (int f = 0; f < chain.n; ++f) {
    if (chain.nd[f] == 2)
      run_filter<2>(scratch, cols, col, L, P, rows, chain.b[f], chain.a[f],
                    chain.zi[f]);
    else if (chain.nd[f] == 3)
      run_filter<3>(scratch, cols, col, L, P, rows, chain.b[f], chain.a[f],
                    chain.zi[f]);
    else
      run_filter<1>(scratch, cols, col, L, P, rows, chain.b[f], chain.a[f],
                    chain.zi[f]);
  }
  for (int t = 0; t < T_pad; ++t)
    xout[(long)t * C] = t < L ? sig[(long)t * cols] : 0.0f;
}

}  // namespace

extern "C" {

// Rows of scratch the kernel needs for a chain whose largest padlen is P.
int filtfilt_scratch_rows(int T_pad, int P) { return T_pad + 2 * P; }

// x, out: (B, T_pad, C) f32; lengths: (B,) int32, each in (P_f, T_pad] for
// every filter's padlen P_f (the wrapper checks); scratch: (T_pad + 2P,
// B*C) f32. nd: n_filters delays counts (1..3), host memory; coef:
// n_filters x 11 f32 on the host, b[4], a[4], zi[3] each (unused taps 0).
// Launches on `stream` and returns the cudaError_t of the launch.
int filtfilt_chain(const void* x, const void* lengths, void* out,
                   void* scratch, const int* nd, const float* coef,
                   int n_filters, int B, int T_pad, int C, void* stream) {
  if (B < 1 || T_pad < 1 || C < 1 || n_filters < 1 ||
      n_filters > MAX_FILTERS)
    return (int)cudaErrorInvalidValue;
  Chain chain;
  chain.n = n_filters;
  int P = 0;
  for (int f = 0; f < n_filters; ++f) {
    if (nd[f] < 1 || nd[f] > MAX_DELAYS) return (int)cudaErrorInvalidValue;
    chain.nd[f] = nd[f];
    for (int k = 0; k <= MAX_DELAYS; ++k) {
      chain.b[f][k] = coef[f * 11 + k];
      chain.a[f][k] = coef[f * 11 + 4 + k];
    }
    for (int k = 0; k < MAX_DELAYS; ++k) chain.zi[f][k] = coef[f * 11 + 8 + k];
    const int p = 3 * (nd[f] + 1);
    P = p > P ? p : P;
  }
  const long cols = (long)B * C;
  const int blocks = (int)((cols + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  filtfilt_chain_kernel<<<blocks, THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const int*>(lengths),
      static_cast<float*>(out), static_cast<float*>(scratch), chain, B, T_pad,
      C, P);
  return (int)cudaGetLastError();
}

const char* filtfilt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

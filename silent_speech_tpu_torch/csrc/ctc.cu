// CTC negative log-likelihood and its gradient for Hopper (sm_90a), on
// optax's clamped lattice.
//
// Not a port of a TPU kernel: the JAX package computes this loss with
// optax.ctc_loss under XLA (silent_speech_tpu/train/losses.py:210-238;
// optax 0.2.6 ctc_loss_with_forward_probs). It replaces torch's
// F.ctc_loss, whose infeasible targets give inf where optax gives ~1e5, and
// whose CUDA backward (blank 37 rules out cuDNN) is not deterministic.
//
// The lattice, per utterance u with L labels l[0..L) of its padded row
// (padding is label 0), eps = -1e5 (optax's log_epsilon) and
// lae(a, b) = max(a, b) + log1p(exp(-|a - b|)) (jnp.logaddexp):
//
//   phi[0] = 0, phi[n > 0] = eps, emit[n] = eps;
//   rep[n] = l[n] == l[n+1] over the padded row (0 at its last position);
//   each frame t < utt_len:
//     A[0] = phi[0],  A[n] = lae(phi[n], emit[n-1] + eps*rep[n-1])
//     emit[n] <- lae(A[n] + lp[t, l[n]], emit[n] + lp[t, l[n]])      n < L
//     phi[0]  <- A[0] + lp[t, blank]
//     phi[n]  <- lae(A[n] + lp[t, blank],
//                    (emit[n-1] + lp[t, blank]) + eps*(1 - rep[n-1]))
//   then phi[L] <- lae(phi[L], emit[L-1]) once, and nll = -phi[L].
//
// Positions past L never reach phi[L], so each CTA runs n = 0..L only.
// Every operation is the one optax performs, in its order (eps*rep is
// exact, so an FMA cannot change a sum), and the plain PyTorch version in
// ops/ctc.py agrees with this kernel to a rounding of expf/log1pf.
//
// The backward is JAX's autodiff of that scan, written out: the
// cotangents of (phi, emit) run backwards over the frames, each lae passing
// g * exp(x - out) to its inputs (jax's _logaddexp_jvp), from the per-frame
// states the forward stored. The cotangent of lp[t, l[n]] at position n is
// the position's occupancy; the last kernel sums them into grad[u, t, k]
// over n in ascending order, one thread per (t, k), with no atomics, so the
// gradient is bit-equal between calls. Frames t >= utt_len and rows with
// L = 0 get an exact 0.
//
// What bounds it on the card. The function reads each (t, label) log-prob
// it needs once and writes the (U, T, K) gradient: at the recognition
// micro-step (U = 64 rows, ~20 of them real, T = 1024, K = 38) ~20 MB, a
// few microseconds at 3.35 TB/s. But each direction is a chain of utt_len
// dependent frames, one CTA barrier each, so the kernels are
// latency-bound: their figure of merit is the time per frame.
//
// Design. Forward: one CTA per utterance, thread n owns phi[n] and
// emit[n] in registers; only emit[n-1] crosses threads, through a
// double-buffered shared array, one __syncthreads a frame. The next
// frame's two log-probs are loaded a frame ahead. The states before each
// frame and after the last go to global memory (U, T+1, S+1) for the
// backward. Backward: the same CTA shape walks the frames in reverse; each
// thread keeps its cotangents of phi[n] and emit[n] in registers and only
// the term emit[n] receives from position n+1 crosses threads (shared,
// double-buffered, one barrier a frame); stored states are loaded a frame
// ahead. A label outside [0, K) makes its row's loss NaN.

#include <cuda_runtime.h>

namespace {

constexpr float LOG_EPS = -1e5f;

__device__ __forceinline__ float lae(float a, float b) {
  return __fadd_rn(fmaxf(a, b), log1pf(expf(-fabsf(__fsub_rn(a, b)))));
}

struct Row {
  int len;   // frames, clamped to [0, T]
  int L;     // labels, clamped to [0, S]
  int lab;   // l[n] of this thread's position when n < L, else 0
  float pen_rep, pen_norep;  // eps*rep[n-1] and eps*(1 - rep[n-1]), n >= 1
  bool bad;  // this position's label lies outside [0, K)
};

// Row constants for position n (thread n). `labels` is the row.
__device__ Row row_of(const int* labels, const int* utt_len,
                      const int* text_len, int u, int n, int T, int S,
                      int K) {
  Row r;
  r.len = min(max(utt_len[u], 0), T);
  r.L = min(max(text_len[u], 0), S);
  const bool rep = n >= 1 && n < S && labels[n - 1] == labels[n];
  r.pen_rep = rep ? LOG_EPS : 0.f;
  r.pen_norep = rep ? 0.f : LOG_EPS;
  r.lab = n < r.L ? labels[n] : 0;
  r.bad = r.lab < 0 || r.lab >= K;
  if (r.bad) r.lab = 0;
  return r;
}

// grid (U), block >= L + 1 threads; shared: 2 * (S + 1) floats.
__global__ void ctc_fwd_kernel(const float* __restrict__ lp,
                               const int* __restrict__ utt_len,
                               const int* __restrict__ labels,
                               const int* __restrict__ text_len,
                               float* __restrict__ nll,
                               float* __restrict__ h_phi,
                               float* __restrict__ h_emit, int T, int K,
                               int S, int blank) {
  extern __shared__ float em[];  // [2][S + 1]: emit of the last frame
  __shared__ int any_bad;
  const int u = blockIdx.x, n = threadIdx.x;
  const Row r = row_of(labels + (size_t)u * S, utt_len, text_len, u, n, T,
                       S, K);
  if (n == 0) any_bad = 0;
  __syncthreads();
  if (r.bad) any_bad = 1;
  const bool live = n <= r.L;
  const size_t stride = (size_t)S + 1;
  float* hp = h_phi + (size_t)u * (T + 1) * stride + n;
  float* he = h_emit + (size_t)u * (T + 1) * stride + n;
  const float* x = lp + (size_t)u * T * K;

  float phi = n == 0 ? 0.f : LOG_EPS, emit = LOG_EPS;
  if (live) {
    hp[0] = phi;
    he[0] = emit;
    em[n] = emit;
  }
  float le_nx = 0.f, lb_nx = 0.f;
  if (live && r.len > 0) {
    le_nx = x[r.lab];
    lb_nx = x[blank];
  }
  __syncthreads();
  int cur = 0;
  for (int t = 0; t < r.len; ++t) {
    const float le = le_nx, lb = lb_nx;
    if (live && t + 1 < r.len) {
      le_nx = x[(size_t)(t + 1) * K + r.lab];
      lb_nx = x[(size_t)(t + 1) * K + blank];
    }
    if (live) {
      const float emp = n >= 1 ? em[cur * stride + n - 1] : 0.f;
      const float a = n == 0 ? phi : lae(phi, __fadd_rn(emp, r.pen_rep));
      if (n < r.L) emit = lae(__fadd_rn(a, le), __fadd_rn(emit, le));
      const float b = __fadd_rn(a, lb);
      phi = n == 0 ? b
                   : lae(b, __fadd_rn(__fadd_rn(emp, lb), r.pen_norep));
      em[(cur ^ 1) * stride + n] = emit;
      hp[(size_t)(t + 1) * stride] = phi;
      he[(size_t)(t + 1) * stride] = emit;
    }
    cur ^= 1;
    __syncthreads();
  }
  if (n == r.L) {
    const float last = n == 0 ? phi : lae(phi, em[cur * stride + n - 1]);
    nll[u] = any_bad ? __int_as_float(0x7fc00000) : -last;
  }
}

// grid (U), block >= L + 1 threads; shared: 2 * (S + 1) floats.
// occ_e[u, t, n]: cotangent of lp[t, l[n]] at position n (n < L);
// occ_b[u, t, n]: position n's share of the cotangent of lp[t, blank].
__global__ void ctc_bwd_kernel(const float* __restrict__ lp,
                               const int* __restrict__ utt_len,
                               const int* __restrict__ labels,
                               const int* __restrict__ text_len,
                               const float* __restrict__ h_phi,
                               const float* __restrict__ h_emit,
                               float* __restrict__ occ_e,
                               float* __restrict__ occ_b, int T, int K,
                               int S, int blank) {
  extern __shared__ float qs[];  // [2][S + 1]: what emit[n-1] gets from n
  const int u = blockIdx.x, n = threadIdx.x;
  const Row r = row_of(labels + (size_t)u * S, utt_len, text_len, u, n, T,
                       S, K);
  if (r.L == 0) return;  // the whole CTA: the grad kernel writes zeros
  const bool live = n <= r.L;
  const size_t stride = (size_t)S + 1;
  const float* hp = h_phi + (size_t)u * (T + 1) * stride;
  const float* he = h_emit + (size_t)u * (T + 1) * stride;
  const float* x = lp + (size_t)u * T * K;
  float* oe = occ_e + (size_t)u * T * stride + n;
  float* ob = occ_b + (size_t)u * T * stride + n;

  // the final update: phi_last[L] = lae(phi[L], emit[L-1]), cotangent 1
  float g_phi = 0.f, g_emit = 0.f;
  float p_out = 0.f, e_out = 0.f;  // this position's state after frame t
  if (live) {
    const size_t end = (size_t)r.len * stride;
    p_out = hp[end + n];
    if (n < r.L) e_out = he[end + n];
    const float ph = hp[end + r.L], el = he[end + r.L - 1];
    const float last = lae(ph, el);
    if (n == r.L) g_phi = expf(__fsub_rn(ph, last));
    if (n == r.L - 1) g_emit = expf(__fsub_rn(el, last));
  }
  // frame t's inputs, loaded a frame ahead
  float phi_nx = 0.f, em_nx = 0.f, emp_nx = 0.f, le_nx = 0.f, lb_nx = 0.f;
  const int t0 = r.len - 1;
  if (live && t0 >= 0) {
    phi_nx = hp[(size_t)t0 * stride + n];
    if (n < r.L) em_nx = he[(size_t)t0 * stride + n];
    if (n >= 1) emp_nx = he[(size_t)t0 * stride + n - 1];
    le_nx = x[(size_t)t0 * K + r.lab];
    lb_nx = x[(size_t)t0 * K + blank];
  }
  __syncthreads();
  int cur = 0;
  for (int t = t0; t >= 0; --t) {
    const float phi = phi_nx, em = em_nx, emp = emp_nx, le = le_nx,
                lb = lb_nx;
    if (live && t >= 1) {
      const size_t o = (size_t)(t - 1) * stride;
      phi_nx = hp[o + n];
      if (n < r.L) em_nx = he[o + n];
      if (n >= 1) emp_nx = he[o + n - 1];
      le_nx = x[(size_t)(t - 1) * K + r.lab];
      lb_nx = x[(size_t)(t - 1) * K + blank];
    }
    float g_a = 0.f, g2 = 0.f;
    if (live) {
      const float d = __fadd_rn(emp, r.pen_rep);
      const float a = n == 0 ? phi : lae(phi, d);
      const float b = __fadd_rn(a, lb);
      float g_b = g_phi, g_c = 0.f;
      if (n >= 1) {
        g_b = g_phi * expf(__fsub_rn(b, p_out));
        const float c = __fadd_rn(__fadd_rn(emp, lb), r.pen_norep);
        g_c = g_phi * expf(__fsub_rn(c, p_out));
      }
      float g1 = 0.f;
      if (n < r.L) {
        g1 = g_emit * expf(__fsub_rn(__fadd_rn(a, le), e_out));
        g2 = g_emit * expf(__fsub_rn(__fadd_rn(em, le), e_out));
        oe[(size_t)t * stride] = g1 + g2;
      }
      ob[(size_t)t * stride] = g_b + g_c;
      g_a = g_b + g1;
      float q = 0.f;
      if (n >= 1) q = g_c + g_a * expf(__fsub_rn(d, a));
      qs[cur * stride + n] = q;
      g_phi = n == 0 ? g_a : g_a * expf(__fsub_rn(phi, a));
      p_out = phi;
      e_out = em;
    }
    __syncthreads();
    if (live && n < r.L) g_emit = g2 + qs[cur * stride + n + 1];
    cur ^= 1;
  }
}

// grid (T, U), block >= K threads; shared: S ints (the row's labels).
__global__ void ctc_grad_kernel(const int* __restrict__ utt_len,
                                const int* __restrict__ labels,
                                const int* __restrict__ text_len,
                                const float* __restrict__ g_nll,
                                const float* __restrict__ occ_e,
                                const float* __restrict__ occ_b,
                                float* __restrict__ grad, int T, int K,
                                int S, int blank) {
  extern __shared__ int lab[];
  const int t = blockIdx.x, u = blockIdx.y, k = threadIdx.x;
  const int len = min(max(utt_len[u], 0), T);
  const int L = min(max(text_len[u], 0), S);
  for (int i = k; i < L; i += blockDim.x) lab[i] = labels[(size_t)u * S + i];
  __syncthreads();
  if (k >= K) return;
  float* out = grad + ((size_t)u * T + t) * K + k;
  if (t >= len || L == 0) {
    *out = 0.f;
    return;
  }
  const size_t o = ((size_t)u * T + t) * ((size_t)S + 1);
  float s = 0.f;
  if (k == blank) {
    for (int n = 0; n <= L; ++n) s += occ_b[o + n];
  } else {
    for (int n = 0; n < L; ++n)
      if (lab[n] == k) s += occ_e[o + n];
  }
  *out = -(g_nll[u] * s);
}

int threads_for(int S) { return ((S + 1 + 31) / 32) * 32; }

}  // namespace

extern "C" {

// lp: (U, T, K) f32; utt_len, text_len: (U,) int32; labels: (U, S) int32
// (>= 0); nll: (U,) f32 out; h_phi, h_emit: (U, T+1, S+1) f32 scratch the
// backward reads. All device pointers; launches on `stream` and returns
// the cudaError_t of the launch (0 on success).
int ctc_forward(const void* lp, const void* utt_len, const void* labels,
                const void* text_len, void* nll, void* h_phi, void* h_emit,
                int U, int T, int K, int S, int blank, void* stream) {
  if (U < 1 || T < 1 || K < 1 || S < 0 || S + 1 > 1024 || blank < 0 ||
      blank >= K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ctc_fwd_kernel<<<U, threads_for(S), 2 * (S + 1) * sizeof(float), s>>>(
      static_cast<const float*>(lp), static_cast<const int*>(utt_len),
      static_cast<const int*>(labels), static_cast<const int*>(text_len),
      static_cast<float*>(nll), static_cast<float*>(h_phi),
      static_cast<float*>(h_emit), T, K, S, blank);
  return (int)cudaGetLastError();
}

// g_nll: (U,) f32, the cotangent of nll; occ_e, occ_b: (U, T, S+1) f32
// scratch; grad: (U, T, K) f32 out, d loss / d lp.
int ctc_backward(const void* lp, const void* utt_len, const void* labels,
                 const void* text_len, const void* h_phi, const void* h_emit,
                 const void* g_nll, void* occ_e, void* occ_b, void* grad,
                 int U, int T, int K, int S, int blank, void* stream) {
  if (U < 1 || T < 1 || K < 1 || K > 1024 || S < 0 || S + 1 > 1024 ||
      blank < 0 || blank >= K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ul = static_cast<const int*>(utt_len);
  const int* lb = static_cast<const int*>(labels);
  const int* tl = static_cast<const int*>(text_len);
  ctc_bwd_kernel<<<U, threads_for(S), 2 * (S + 1) * sizeof(float), s>>>(
      static_cast<const float*>(lp), ul, lb, tl,
      static_cast<const float*>(h_phi), static_cast<const float*>(h_emit),
      static_cast<float*>(occ_e), static_cast<float*>(occ_b), T, K, S,
      blank);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ctc_grad_kernel<<<dim3(T, U), ((K + 31) / 32) * 32,
                    (S > 0 ? S : 1) * sizeof(int), s>>>(
      ul, lb, tl, static_cast<const float*>(g_nll),
      static_cast<const float*>(occ_e), static_cast<const float*>(occ_b),
      static_cast<float*>(grad), T, K, S, blank);
  return (int)cudaGetLastError();
}

const char* ctc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

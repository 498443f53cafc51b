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
// over n in ascending order, one thread per (t, k) cell and a CTA per 32
// frames of a row (a CTA per frame made 65,536 small CTAs at a
// micro-step), with no atomics, so the gradient is bit-equal between
// calls. Frames t >= utt_len get an exact 0. A row with L = 0 has the NLL
// -sum_t lp[t, blank] (phi[0] only ever adds the blank), so its gradient
// is -g_nll at the blank of each frame t < utt_len and 0 elsewhere, as
// jax.grad of optax.ctc_loss gives it; the backward recursion has no
// state to walk for such a row, and the last kernel writes it directly.
//
// What bounds it on the card. The function reads each (t, label) log-prob
// it needs once and writes the (U, T, K) gradient: at the recognition
// micro-step (U = 64 rows, ~20 of them real, T = 1024, K = 38) ~20 MB, a
// few microseconds at 3.35 TB/s. But each direction is a chain of utt_len
// dependent frames, so the kernels are latency-bound: their figure of
// merit is the time per frame, and what sets it is the dependent chain a
// warp's in-order issue waits on each frame. Ablations of the first
// design (PERF.md §6) found the per-frame global loads, the CTA
// barrier and the stores worth 24 of its 397 ns a frame forward and 93 of
// 434 backward; the rest was arithmetic that need not be on the chain.
//
// Design. Forward: one CTA per utterance, thread n owns phi[n] and
// emit[n] in registers. Each frame computes A, then the emit and phi
// updates, all three lae unconditionally and selected after (as branches,
// the n < L and n == 0 cases kept the two lae that follow A from
// interleaving). The row's log-probs are staged in shared memory a chunk
// of F frames at a time, double-buffered with cp.async: chunk c + 1
// is in flight while chunk c runs, so no frame waits on device memory.
// emit[n-1] comes from lane n - 1 by __shfl_up_sync; lane 0 takes warp
// w - 1's lane 31 from shared memory, behind a named barrier over the
// warps that hold positions 0..L only (none when one warp holds them all).
// Warps past position L return at the start. The states before each frame
// and after the last go to global memory (U, T+1, S+1) for the backward.
//
// Backward: the reverse step's coefficients (the one lae and the six
// exponentials of a (frame, position) cell) depend on the stored states
// and log-probs only, never on the cotangents. So it walks the frames in
// chunks of F from the end, and for each chunk (1) every thread of the
// CTA computes the chunk's cells' coefficients in parallel into shared
// memory, then (2) thread n runs the chunk's frames in reverse on its
// cotangents of phi[n] and emit[n]: six multiplies and adds a frame, the
// term emit[n] receives from position n + 1 by __shfl_down_sync (lane 31
// from warp w + 1's lane 0 through shared memory, the same named
// barrier), the occupancies written over the coefficients they replace,
// then (3) the chunk's occupancies go to global memory in coalesced rows.
// Every product and sum is the first design's, with its rounding written
// out (__fmul_rn, __fadd_rn, and the one fused q = fma(g_a, e, g_c) that
// nvcc made of it), so the NLL and gradient are bit-equal to it. A label
// outside [0, K) makes its row's loss NaN.
//
// Measured slower on the H100 at a recognition micro-step (PERF.md
// §6): two or four positions a lane so that one warp holds a row of up to
// 127 labels (one warp issues what two did in parallel); tagged rings in
// shared memory that let a warp run ahead of its neighbour in place of
// the per-frame barrier; __launch_bounds__(1024) on these kernels.

#include <cuda_runtime.h>

namespace {

constexpr float LOG_EPS = -1e5f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_POS = 1024;           // label positions + 1, one a thread
constexpr int MAX_CHUNK = 64;           // frames a chunk
constexpr int FWD_SMEM = 40 * 1024;     // the forward's two log-prob chunks
constexpr int BWD_SMEM = 160 * 1024;    // the backward's coefficients
constexpr int BWD_THREADS = 512;        // at least; all of them compute cells
constexpr int NCOEF = 6;
constexpr int GRAD_FRAMES = 32;         // frames a CTA of the gradient sum
constexpr int GRAD_THREADS = 256;

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

// a barrier over the nw warps that hold the row's positions
__device__ __forceinline__ void live_sync(int nw) {
  if (nw > 1) {
    asm volatile("bar.sync 1, %0;" ::"r"(nw * 32) : "memory");
  } else {
    __syncwarp();
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// grid (U), block threads_for(S); dynamic shared: 2 * F * K floats, the
// double-buffered log-prob chunks of F frames.
__global__ void ctc_fwd_kernel(const float* __restrict__ lp,
                               const int* __restrict__ utt_len,
                               const int* __restrict__ labels,
                               const int* __restrict__ text_len,
                               float* __restrict__ nll,
                               float* __restrict__ h_phi,
                               float* __restrict__ h_emit, int T, int K,
                               int S, int blank, int F) {
  extern __shared__ float chunk[];  // [2][F * K]
  __shared__ float edge[2][32];     // lane 31's emit by warp, frame parity
  const int u = blockIdx.x, n = threadIdx.x, lane = n & 31, w = n >> 5;
  const Row r = row_of(labels + (size_t)u * S, utt_len, text_len, u, n, T,
                       S, K);
  const bool any_bad = __syncthreads_or(r.bad);
  const int nw = (r.L + 32) >> 5;  // warps holding positions 0..L
  if (w >= nw) return;
  const bool live = n <= r.L;
  const size_t stride = (size_t)S + 1;
  float* hp = h_phi + (size_t)u * (T + 1) * stride + n;
  float* he = h_emit + (size_t)u * (T + 1) * stride + n;
  const float* x = lp + (size_t)u * T * K;
  const int span = F * K;

  float phi = n == 0 ? 0.f : LOG_EPS, emit = LOG_EPS;
  if (live) {
    hp[0] = phi;
    he[0] = emit;
  }
  if (lane == 31) edge[1][w] = emit;  // read by frame 0 (or the end)
  live_sync(nw);
  const int nchunks = (r.len + F - 1) / F;
  if (nchunks > 0) {
    for (int i = n; i < min(F, r.len) * K; i += nw * 32)
      cp_async4(chunk + i, x + i);
  }
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * F, nf = min(F, r.len - t0);
    // chunk c has landed for every thread; chunk c - 1's buffer is free
    cp_async_wait_all();
    live_sync(nw);
    if (c + 1 < nchunks) {
      float* next = chunk + ((c + 1) & 1) * span;
      const float* from = x + (size_t)(t0 + F) * K;
      for (int i = n; i < min(F, r.len - t0 - F) * K; i += nw * 32)
        cp_async4(next + i, from + i);
    }
    cp_async_commit();
    const float* cur = chunk + (c & 1) * span;
    for (int j = 0; j < nf; ++j) {
      const int t = t0 + j;
      const float le = cur[j * K + r.lab], lb = cur[j * K + blank];
      float emp = __shfl_up_sync(FULL, emit, 1);
      if (lane == 0) emp = w > 0 ? edge[(t & 1) ^ 1][w - 1] : 0.f;
      const float a1 = lae(phi, __fadd_rn(emp, r.pen_rep));
      const float a = n == 0 ? phi : a1;
      const float e1 = lae(__fadd_rn(a, le), __fadd_rn(emit, le));
      const float b = __fadd_rn(a, lb);
      const float p1 = lae(b, __fadd_rn(__fadd_rn(emp, lb), r.pen_norep));
      emit = n < r.L ? e1 : emit;
      phi = n == 0 ? b : p1;
      if (lane == 31) edge[t & 1][w] = emit;
      if (live) {
        hp[(size_t)(t + 1) * stride] = phi;
        he[(size_t)(t + 1) * stride] = emit;
      }
      if (nw > 1) live_sync(nw);
    }
  }
  float emp = __shfl_up_sync(FULL, emit, 1);
  if (lane == 0) emp = w > 0 ? edge[(r.len - 1) & 1][w - 1] : 0.f;
  if (n == r.L) {
    const float last = n == 0 ? phi : lae(phi, emp);
    nll[u] = any_bad ? __int_as_float(0x7fc00000) : -last;
  }
}

// grid (U), block max(threads_for(S), BWD_THREADS); dynamic shared:
// NCOEF * F * (S + 1) floats, one chunk's coefficients.
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
                               int S, int blank, int F) {
  // coef[k][j][n] of frame t0 + j and position n <= L, pitch P = L + 1:
  // k = 0..5 the multipliers of g_b, g_c, g1, g2, q's g_a and g_phi's g_a;
  // after the recursion k = 0 holds occ_b and k = 1 occ_e
  extern __shared__ float coef[];
  __shared__ int lab_s[MAX_POS];
  __shared__ float pen_rep_s[MAX_POS], pen_norep_s[MAX_POS];
  __shared__ float edge[2][32];  // lane 0's q by warp, frame parity
  const int u = blockIdx.x, n = threadIdx.x, lane = n & 31, w = n >> 5;
  const int len = min(max(utt_len[u], 0), T);
  const int L = min(max(text_len[u], 0), S);
  if (L == 0) return;  // the whole CTA: the grad kernel needs no state
  const int P = L + 1, nw = (L + 32) >> 5;
  const size_t stride = (size_t)S + 1;
  const float* hp = h_phi + (size_t)u * (T + 1) * stride;
  const float* he = h_emit + (size_t)u * (T + 1) * stride;
  const float* x = lp + (size_t)u * T * K;
  float* oe = occ_e + (size_t)u * T * stride;
  float* ob = occ_b + (size_t)u * T * stride;
  for (int i = n; i < P; i += blockDim.x) {
    const Row r = row_of(labels + (size_t)u * S, utt_len, text_len, u, i, T,
                         S, K);
    lab_s[i] = r.lab;
    pen_rep_s[i] = r.pen_rep;
    pen_norep_s[i] = r.pen_norep;
  }

  // the final update: phi_last[L] = lae(phi[L], emit[L-1]), cotangent 1
  float g_phi = 0.f, g_emit = 0.f;
  if (n <= L) {
    const size_t end = (size_t)len * stride;
    const float ph = hp[end + L], el = he[end + L - 1];
    const float last = lae(ph, el);
    if (n == L) g_phi = expf(__fsub_rn(ph, last));
    if (n == L - 1) g_emit = expf(__fsub_rn(el, last));
  }
  const int nchunks = (len + F - 1) / F;
  const int np = min(n, L);  // a lane past L reads position L's cells
  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * F, nf = min(F, len - t0);
    __syncthreads();  // the row constants; the last chunk's write-out
    // (1) the chunk's coefficients, every thread, cells in parallel
    for (int i = n; i < nf * P; i += blockDim.x) {
      const int j = i / P, m = i - j * P, t = t0 + j;
      const size_t o = (size_t)t * stride;
      const float phi = hp[o + m], p_out = hp[o + stride + m];
      const float em = m < L ? he[o + m] : 0.f;
      const float e_out = m < L ? he[o + stride + m] : 0.f;
      const float emp = m >= 1 ? he[o + m - 1] : 0.f;
      const float le = x[(size_t)t * K + lab_s[m]];
      const float lb = x[(size_t)t * K + blank];
      const float d = __fadd_rn(emp, pen_rep_s[m]);
      const float a1 = lae(phi, d);
      const float a = m == 0 ? phi : a1;
      const float b = __fadd_rn(a, lb);
      const float cc = __fadd_rn(__fadd_rn(emp, lb), pen_norep_s[m]);
      float* k0 = coef + j * P + m;
      const int plane = F * P;
      k0[0] = expf(__fsub_rn(b, p_out));
      k0[plane] = expf(__fsub_rn(cc, p_out));
      k0[2 * plane] = expf(__fsub_rn(__fadd_rn(a, le), e_out));
      k0[3 * plane] = expf(__fsub_rn(__fadd_rn(em, le), e_out));
      k0[4 * plane] = expf(__fsub_rn(d, a));
      k0[5 * plane] = expf(__fsub_rn(phi, a));
    }
    __syncthreads();
    // (2) the recursion on the cotangents, frames in reverse
    if (w < nw) {
      const int plane = F * P;
      for (int j = nf - 1; j >= 0; --j) {
        const int t = t0 + j;
        float* k0 = coef + j * P + np;
        const float eb = k0[0], ec = k0[plane], e1 = k0[2 * plane],
                    e2 = k0[3 * plane], eq = k0[4 * plane],
                    ephi = k0[5 * plane];
        const float g_b = n >= 1 ? __fmul_rn(g_phi, eb) : g_phi;
        const float g_c = n >= 1 ? __fmul_rn(g_phi, ec) : 0.f;
        const float g1 = n < L ? __fmul_rn(g_emit, e1) : 0.f;
        const float g2 = n < L ? __fmul_rn(g_emit, e2) : 0.f;
        const float g_a = __fadd_rn(g_b, g1);
        const float q = n >= 1 ? __fmaf_rn(g_a, eq, g_c) : 0.f;
        g_phi = n == 0 ? g_a : __fmul_rn(g_a, ephi);
        if (n <= L) {
          k0[0] = __fadd_rn(g_b, g_c);
          k0[plane] = __fadd_rn(g1, g2);
        }
        float qn = __shfl_down_sync(FULL, q, 1);
        if (lane == 0) edge[t & 1][w] = q;
        live_sync(nw);
        if (lane == 31 && w + 1 < nw) qn = edge[t & 1][w + 1];
        if (n < L) g_emit = __fadd_rn(g2, qn);
      }
    }
    __syncthreads();
    // (3) the chunk's occupancies out, in rows of positions
    for (int i = n; i < nf * P; i += blockDim.x) {
      const int j = i / P, m = i - j * P;
      const size_t o = (size_t)(t0 + j) * stride + m;
      ob[o] = coef[j * P + m];
      if (m < L) oe[o] = coef[F * P + j * P + m];
    }
  }
}

// grid (ceil(T / GRAD_FRAMES), U), block GRAD_THREADS; shared: S ints
// (the row's labels). A CTA writes GRAD_FRAMES frames of a row, thread i
// the cells i, i + GRAD_THREADS, ... of that (frames, K) block in row-major
// order; each cell sums its positions in ascending order.
__global__ void ctc_grad_kernel(const int* __restrict__ utt_len,
                                const int* __restrict__ labels,
                                const int* __restrict__ text_len,
                                const float* __restrict__ g_nll,
                                const float* __restrict__ occ_e,
                                const float* __restrict__ occ_b,
                                float* __restrict__ grad, int T, int K,
                                int S, int blank) {
  extern __shared__ int lab[];
  const int u = blockIdx.y, t0 = blockIdx.x * GRAD_FRAMES;
  const int len = min(max(utt_len[u], 0), T);
  const int L = min(max(text_len[u], 0), S);
  const int cells = min(GRAD_FRAMES, T - t0) * K;
  for (int i = threadIdx.x; i < L; i += blockDim.x)
    lab[i] = labels[(size_t)u * S + i];
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int t = t0 + i / K, k = i - (i / K) * K;
    float* out = grad + ((size_t)u * T + t) * K + k;
    if (t >= len) {
      *out = 0.f;
      continue;
    }
    if (L == 0) {  // -sum_t lp[t, blank]: d/d lp[t, blank] = -1
      *out = k == blank ? -g_nll[u] : 0.f;
      continue;
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
}

int threads_for(int S) { return ((S + 1 + 31) / 32) * 32; }

// frames a chunk: as many as fit in `budget` bytes at `bytes_per_frame`,
// at most MAX_CHUNK
int chunk_frames(size_t budget, size_t bytes_per_frame) {
  const size_t f = budget / bytes_per_frame;
  return (int)(f < 1 ? 1 : (f > MAX_CHUNK ? MAX_CHUNK : f));
}

}  // namespace

extern "C" {

// Frames a chunk of the forward (backward = 0) or the backward (1) at K
// classes and S label positions, as the launches below choose them.
int ctc_chunk_frames(int K, int S, int backward) {
  return backward
             ? chunk_frames(BWD_SMEM, (size_t)NCOEF * (S + 1) * sizeof(float))
             : chunk_frames(FWD_SMEM, (size_t)K * 2 * sizeof(float));
}

// lp: (U, T, K) f32; utt_len, text_len: (U,) int32; labels: (U, S) int32
// (>= 0); nll: (U,) f32 out; h_phi, h_emit: (U, T+1, S+1) f32 scratch the
// backward reads. All device pointers; launches on `stream` and returns
// the cudaError_t of the launch (0 on success).
int ctc_forward(const void* lp, const void* utt_len, const void* labels,
                const void* text_len, void* nll, void* h_phi, void* h_emit,
                int U, int T, int K, int S, int blank, void* stream) {
  if (U < 1 || T < 1 || K < 1 || S < 0 || S + 1 > MAX_POS || blank < 0 ||
      blank >= K || (size_t)K * 2 * sizeof(float) > FWD_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int F = ctc_chunk_frames(K, S, 0);
  ctc_fwd_kernel<<<U, threads_for(S), (size_t)2 * F * K * sizeof(float),
                   s>>>(
      static_cast<const float*>(lp), static_cast<const int*>(utt_len),
      static_cast<const int*>(labels), static_cast<const int*>(text_len),
      static_cast<float*>(nll), static_cast<float*>(h_phi),
      static_cast<float*>(h_emit), T, K, S, blank, F);
  return (int)cudaGetLastError();
}

// g_nll: (U,) f32, the cotangent of nll; occ_e, occ_b: (U, T, S+1) f32
// scratch; grad: (U, T, K) f32 out, d loss / d lp.
int ctc_backward(const void* lp, const void* utt_len, const void* labels,
                 const void* text_len, const void* h_phi, const void* h_emit,
                 const void* g_nll, void* occ_e, void* occ_b, void* grad,
                 int U, int T, int K, int S, int blank, void* stream) {
  if (U < 1 || T < 1 || K < 1 || K > 1024 || S < 0 || S + 1 > MAX_POS ||
      blank < 0 || blank >= K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ul = static_cast<const int*>(utt_len);
  const int* lb = static_cast<const int*>(labels);
  const int* tl = static_cast<const int*>(text_len);
  const int F = ctc_chunk_frames(K, S, 1);
  const size_t smem = (size_t)NCOEF * F * (S + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ctc_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = threads_for(S) > BWD_THREADS ? threads_for(S)
                                                     : BWD_THREADS;
  ctc_bwd_kernel<<<U, threads, smem, s>>>(
      static_cast<const float*>(lp), ul, lb, tl,
      static_cast<const float*>(h_phi), static_cast<const float*>(h_emit),
      static_cast<float*>(occ_e), static_cast<float*>(occ_b), T, K, S,
      blank, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ctc_grad_kernel<<<dim3((T + GRAD_FRAMES - 1) / GRAD_FRAMES, U),
                    GRAD_THREADS, (S > 0 ? S : 1) * sizeof(int), s>>>(
      ul, lb, tl, static_cast<const float*>(g_nll),
      static_cast<const float*>(occ_e), static_cast<const float*>(occ_b),
      static_cast<float*>(grad), T, K, S, blank);
  return (int)cudaGetLastError();
}

const char* ctc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

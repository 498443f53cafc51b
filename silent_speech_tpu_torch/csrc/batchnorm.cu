// The conv stack's training BatchNorm for Hopper (sm_90a): batch
// statistics, the normalization fused with the ReLU and the ResBlock's
// residual add, and a backward that recomputes what it needs from the
// compute-dtype conv outputs.
//
// Not a port of a TPU kernel: the JAX package computes flax's nn.BatchNorm
// (silent_speech_tpu/models/encoder.py) in XLA fusions. The port composed it
// from ATen ops (ops/batch_norm.py batch_norm_plain): a float32 copy of the
// conv output, the two means, the normalization, the ReLU and the residual
// add as separate passes, and autograd's backward of each, ~245 elementwise
// and reduction launches and ~87 GB a bf16 transduction micro-step, with
// float32 activation-sized tensors saved for the backward.
//
// The mathematics, over the rows (b, c, :) of channels-first (B, C, L)
// tensors, per channel c, n = B * L (times the data ranks on a mesh):
//   mean = Sx / n, d = Sxx / n - mean^2, var = d < 0 ? 0 : d,
//   rstd = rsqrt(var + eps), scale = rstd * gamma,
//   shift = beta - mean * scale,
//   running = momentum * running + (1 - momentum) * batch (mean and var),
//   pre = x * scale + shift (one fma), y = relu(pre), or at a block's end
//   y = relu(pre2 + pre_res) and y = relu(pre2 + r) with a residual input r.
// The backward of a BN behind the ReLU, with gm = pre > 0 ? g : 0 and
// xhat = (x - mean) * rstd:
//   dbeta = Sum gm, dgamma = Sum gm * xhat,
//   dx = scale * (gm - Sum gm / n - xhat * k),
//   k = d >= 0 ? Sum gm xhat / n : 0,
// which is autograd's gradient through the composition: clamp_min passes
// the gradient where its input is >= 0, so a clipped channel drops the
// variance's term. Two BNs that end a block share gm, so one reduction gives
// Sum gm and both Sum gm * xhat. A block's output that feeds two consumers
// (the next block's conv1 and residual path) comes back as two gradients,
// added here in float32 as autograd added them on a float32 output.
//
// Every sum is float32 in registers, in a fixed order: a thread's loads in
// turn, a warp's butterfly, the warps in order, the slabs' partials in order
// in a finalize launch. No atomics: two calls are bit-equal. Stores are in
// the compute dtype T (bf16 or float32), the output in O (T, or float32 on a
// mesh, where a model all-gather follows), the gradient g in the output's
// dtype. pre is one explicit fma (and one add) wherever it is formed, so the
// backward's ReLU mask is the forward's bit for bit.
//
// What bounds it on the card: bytes; a few flops an element. A transduction
// ResBlock's passes read or write 8 tensors of (B, C, L) forward (statistics
// 1 + 2, apply 1 + 3 with the store) and 15 backward (reduce 1 + 4, apply
// 3 + 7, the block's end reading its output's two gradients). Design: every
// pass gives a CTA one channel and a slab of its batch rows (rows_per_slab
// from the wrapper, ~16K elements), so thousands of CTAs fill the card at
// L = 200, and a CTA reads its channel's few statistics once. A group is 16
// bytes of T (8 bf16 or 4 f32 elements) that never crosses a row, loaded as
// one vector where the rows are whole groups and the buffers 16-byte
// aligned, element by element otherwise; each thread keeps a few groups in
// flight. The reductions write per-slab partials that a finalize sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// CTAs an SM keeps: at most 64 registers a thread, so that each SM holds
// 1,024 threads' loads in flight (the backward's passes run ~10% faster than
// at the compiler's own 72-128 registers; PERF.md §6)
constexpr int MIN_CTAS = 4;
constexpr int FIN_THREADS = 128;

enum Mode { BN_RELU = 0, BN_BN_ADD_RELU = 1, BN_INPUT_ADD_RELU = 2 };

template <typename T> struct Elem;

template <> struct Elem<__nv_bfloat16> {
  using Raw = unsigned short;
  __device__ static float get(Raw r) {
    return __uint_as_float((unsigned)r << 16);
  }
  __device__ static Raw put(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

template <> struct Elem<float> {
  using Raw = unsigned;
  __device__ static float get(Raw r) { return __uint_as_float(r); }
  __device__ static Raw put(float f) { return __float_as_uint(f); }
};

// N elements of T from p into f: one 16-byte vector per 16 bytes when `vec`
// and the group is whole (cnt == N), else element by element, 0 past cnt.
template <typename T, int N>
__device__ __forceinline__ void load(const T* p, int cnt, bool vec,
                                     float (&f)[N]) {
  using Raw = typename Elem<T>::Raw;
  constexpr int PER = 16 / sizeof(Raw);
  static_assert(N % PER == 0, "a group is whole 16-byte vectors");
  if (vec && cnt == N) {
#pragma unroll
    for (int k = 0; k < N / PER; ++k) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[k];
      const Raw* r = reinterpret_cast<const Raw*>(&q);
#pragma unroll
      for (int j = 0; j < PER; ++j) f[k * PER + j] = Elem<T>::get(r[j]);
    }
    return;
  }
  const Raw* r = reinterpret_cast<const Raw*>(p);
#pragma unroll
  for (int j = 0; j < N; ++j) f[j] = j < cnt ? Elem<T>::get(r[j]) : 0.f;
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, int cnt, bool vec,
                                      const float (&f)[N]) {
  using Raw = typename Elem<T>::Raw;
  constexpr int PER = 16 / sizeof(Raw);
  Raw* r = reinterpret_cast<Raw*>(p);
  if (vec && cnt == N) {
#pragma unroll
    for (int k = 0; k < N / PER; ++k) {
      uint4 q;
      Raw* w = reinterpret_cast<Raw*>(&q);
#pragma unroll
      for (int j = 0; j < PER; ++j) w[j] = Elem<T>::put(f[k * PER + j]);
      reinterpret_cast<uint4*>(p)[k] = q;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < cnt) r[j] = Elem<T>::put(f[j]);
}

// Elements of a group: 16 bytes of the compute dtype.
template <typename T>
__host__ __device__ constexpr int group_n() { return 16 / (int)sizeof(T); }

// The CTA's share: channel c's rows b0 .. b0 + nb - 1 (blockIdx.y's slab),
// per_row groups a row.
template <int N>
struct Slab {
  int c, b0, per_row, groups, C, L;

  __device__ Slab(int c_, int B, int C_, int L_, int rows_per_slab)
      : c(c_), C(C_), L(L_) {
    b0 = blockIdx.y * rows_per_slab;
    per_row = (L + N - 1) / N;
    groups = min(rows_per_slab, B - b0) * per_row;
  }

  // group j's first element and element count (0 past the slab)
  __device__ int at(int j, long long& off) const {
    if (j >= groups) return 0;
    const int r = j / per_row, q = j - r * per_row;
    off = ((long long)(b0 + r) * C + c) * L + (long long)q * N;
    return min(N, L - q * N);
  }
};

// The BN's pre-activation, one fma, as every pass forms it.
__device__ __forceinline__ float affine(float x, float scale, float shift) {
  return __fmaf_rn(x, scale, shift);
}

// J sums over the CTA, in a fixed order; thread 0 holds the result.
template <int J>
__device__ __forceinline__ void block_sum(float (&v)[J]) {
  __shared__ float sh[J][WARPS];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int j = 0; j < J; ++j) sh[j][warp] = v[j];
  __syncthreads();
  if (threadIdx.x == 0)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += sh[j][w];
      v[j] = s;
    }
}

// ---- forward -------------------------------------------------------------

// CTA (k, p): channel k mod C of tensor k / C (x0, or x1 for the second),
// batch rows [p * rows_per_slab, ..): Sx and Sxx to part[p][0|1][k].
template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
    stats_kernel(const T* __restrict__ x0, const T* __restrict__ x1,
                 float* __restrict__ part, int B, int C, int L,
                 int rows_per_slab, bool vec) {
  constexpr int N = group_n<T>();
  constexpr int U = 4;
  const int K = gridDim.x, k = blockIdx.x;
  const T* x = k < C ? x0 : x1;
  const Slab<N> sl(k % C, B, C, L, rows_per_slab);
  float acc[2] = {0.f, 0.f};
  for (int j = threadIdx.x; j < sl.groups; j += THREADS * U) {
    float v[U][N];
    int cnt[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      long long off = 0;
      cnt[u] = sl.at(j + u * THREADS, off);
      if (cnt[u]) load<T, N>(x + off, cnt[u], vec, v[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (cnt[u])
#pragma unroll
        for (int e = 0; e < N; ++e) {
          acc[0] += v[u][e];
          acc[1] = __fmaf_rn(v[u][e], v[u][e], acc[1]);
        }
  }
  block_sum<2>(acc);
  if (threadIdx.x == 0) {
    part[((long long)blockIdx.y * 2 + 0) * K + k] = acc[0];
    part[((long long)blockIdx.y * 2 + 1) * K + k] = acc[1];
  }
}

struct BnParams {
  const float* gamma[2];
  const float* beta[2];
  float* running_mean[2];
  float* running_var[2];
};

// Thread k: the P partials of channel k summed in order. sums_only writes
// Sx, Sxx to sums[0|1][k] (a mesh then sums them over its data ranks and
// calls again with P = 1 on them); else stats[0..4][k] = mean, rstd, scale,
// shift, d >= 0 and the running statistics move.
__global__ void __launch_bounds__(FIN_THREADS)
    finalize_kernel(const float* __restrict__ part, int P, int K, int C,
                    float count, float eps, float momentum, float keep,
                    BnParams prm, float* __restrict__ stats,
                    float* __restrict__ sums, bool sums_only) {
  const int k = blockIdx.x * FIN_THREADS + threadIdx.x;
  if (k >= K) return;
  float s1 = 0.f, s2 = 0.f;
  for (int p = 0; p < P; ++p) {
    s1 += part[((long long)p * 2 + 0) * K + k];
    s2 += part[((long long)p * 2 + 1) * K + k];
  }
  if (sums_only) {
    sums[k] = s1;
    sums[K + k] = s2;
    return;
  }
  const int t = k / C, c = k - t * C;
  const float mean = __fdiv_rn(s1, count);
  const float msq = __fdiv_rn(s2, count);
  const float d = __fsub_rn(msq, __fmul_rn(mean, mean));
  const float var = d < 0.f ? 0.f : d;
  const float rstd = rsqrtf(__fadd_rn(var, eps));
  const float scale = __fmul_rn(rstd, prm.gamma[t][c]);
  const float shift = __fsub_rn(prm.beta[t][c], __fmul_rn(mean, scale));
  stats[0 * K + k] = mean;
  stats[1 * K + k] = rstd;
  stats[2 * K + k] = scale;
  stats[3 * K + k] = shift;
  stats[4 * K + k] = d >= 0.f ? 1.f : 0.f;
  float* rm = prm.running_mean[t];
  float* rv = prm.running_var[t];
  rm[c] = __fadd_rn(__fmul_rn(momentum, rm[c]), __fmul_rn(keep, mean));
  rv[c] = __fadd_rn(__fmul_rn(momentum, rv[c]), __fmul_rn(keep, var));
}

// CTA (c, p): y = relu(x0 * scale + shift [+ x1 * scale' + shift' | + r])
// in O over channel c's slab.
template <typename T, typename O, int MODE>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
    apply_kernel(const T* __restrict__ x0, const T* __restrict__ x1,
                 const float* __restrict__ r, O* __restrict__ out,
                 const float* __restrict__ stats, int B, int C, int L,
                 int rows_per_slab, bool vec) {
  constexpr int N = group_n<T>();
  constexpr int U = MODE == BN_RELU ? 4 : 2;
  const int K = MODE == BN_BN_ADD_RELU ? 2 * C : C;
  const int c = blockIdx.x;
  const Slab<N> sl(c, B, C, L, rows_per_slab);
  const float sc0 = stats[2 * K + c], sh0 = stats[3 * K + c];
  float sc1 = 0.f, sh1 = 0.f;
  if (MODE == BN_BN_ADD_RELU) {
    sc1 = stats[2 * K + C + c];
    sh1 = stats[3 * K + C + c];
  }
  for (int j = threadIdx.x; j < sl.groups; j += THREADS * U) {
    float a[U][N], b[U][N];
    long long off[U];
    int cnt[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cnt[u] = sl.at(j + u * THREADS, off[u]);
      if (!cnt[u]) continue;
      load<T, N>(x0 + off[u], cnt[u], vec, a[u]);
      if (MODE == BN_BN_ADD_RELU) load<T, N>(x1 + off[u], cnt[u], vec, b[u]);
      if (MODE == BN_INPUT_ADD_RELU)
        load<float, N>(r + off[u], cnt[u], vec, b[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!cnt[u]) break;
      float y[N];
#pragma unroll
      for (int e = 0; e < N; ++e) {
        float pre = affine(a[u][e], sc0, sh0);
        if (MODE == BN_BN_ADD_RELU)
          pre = __fadd_rn(pre, affine(b[u][e], sc1, sh1));
        if (MODE == BN_INPUT_ADD_RELU) pre = __fadd_rn(pre, b[u][e]);
        y[e] = pre < 0.f ? 0.f : pre;
      }
      store<O, N>(out + off[u], cnt[u], vec, y);
    }
  }
}

// ---- backward ------------------------------------------------------------

// What a backward pass reads and writes. g (and g2) in G, the output's
// dtype; where a block's output has two consumers (the next block's conv1
// and residual path), each hands its own gradient and the passes add them
// in float32, as autograd summed the two on the float32 output.
struct Bwd {
  const void* g;
  const void* g2;  // nullptr: one gradient
  const void* x0;
  const void* x1;  // the second BN's input (mode 1)
  const float* r;  // the residual input (mode 2)
  const float* stats;
  float* part;       // the reduction's partials
  const float* tot;  // the apply's totals
  void* dx0;
  void* dx1;
  float* dr;
  int B, C, L, rows_per_slab;
  float count;
  bool vec;
};

// One channel's statistics: mean, rstd, scale, shift, and the coefficient
// k of x̂ in dx (0 at a clipped channel; set by the apply).
struct Chan {
  float mean, rstd, scale, shift, k;
};

__device__ __forceinline__ Chan chan(const float* stats, int K, int i) {
  return Chan{stats[i], stats[K + i], stats[2 * K + i], stats[3 * K + i],
              0.f};
}

__device__ __forceinline__ float xhat(float x, const Chan& s) {
  return __fmul_rn(__fsub_rn(x, s.mean), s.rstd);
}

// The loads of one group: the gradient (or both), x0, and x1 or r.
template <typename T, typename G, int MODE, int N>
struct BwdGroup {
  float g[N], g2[N], a[N], b[N];

  __device__ void load_at(const Bwd& q, long long off, int n) {
    load<G, N>(static_cast<const G*>(q.g) + off, n, q.vec, g);
    if (q.g2) load<G, N>(static_cast<const G*>(q.g2) + off, n, q.vec, g2);
    load<T, N>(static_cast<const T*>(q.x0) + off, n, q.vec, a);
    if (MODE == BN_BN_ADD_RELU)
      load<T, N>(static_cast<const T*>(q.x1) + off, n, q.vec, b);
    if (MODE == BN_INPUT_ADD_RELU) load<float, N>(q.r + off, n, q.vec, b);
  }

  // element e's gradient behind the ReLU, its mask recomputed
  __device__ float masked(const Bwd& q, int e, const Chan& s0,
                          const Chan& s1) const {
    float pre = affine(a[e], s0.scale, s0.shift);
    if (MODE == BN_BN_ADD_RELU)
      pre = __fadd_rn(pre, affine(b[e], s1.scale, s1.shift));
    if (MODE == BN_INPUT_ADD_RELU) pre = __fadd_rn(pre, b[e]);
    const float gs = q.g2 ? __fadd_rn(g[e], g2[e]) : g[e];
    return pre > 0.f ? gs : 0.f;
  }
};

// CTA (c, p): channel c over the slab's rows. J = 2: Sum gm, Sum gm * xhat0;
// J = 3 (two BNs): and Sum gm * xhat1. To part[p][j][c].
template <typename T, typename G, int MODE>
__global__ void __launch_bounds__(THREADS, MIN_CTAS) bwd_reduce_kernel(const Bwd q) {
  constexpr int N = group_n<T>();
  constexpr int U = MODE == BN_BN_ADD_RELU ? 1 : 2;
  constexpr int J = MODE == BN_BN_ADD_RELU ? 3 : 2;
  const int C = q.C, c = blockIdx.x;
  const int K = MODE == BN_BN_ADD_RELU ? 2 * C : C;
  const Slab<N> sl(c, q.B, C, q.L, q.rows_per_slab);
  const Chan s0 = chan(q.stats, K, c);
  const Chan s1 = MODE == BN_BN_ADD_RELU ? chan(q.stats, K, C + c) : s0;
  float acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = 0.f;
  for (int j = threadIdx.x; j < sl.groups; j += THREADS * U) {
    BwdGroup<T, G, MODE, N> in[U];
    int cnt[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      long long off = 0;
      cnt[u] = sl.at(j + u * THREADS, off);
      if (cnt[u]) in[u].load_at(q, off, cnt[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if (e >= cnt[u]) break;
        const float gm = in[u].masked(q, e, s0, s1);
        acc[0] += gm;
        acc[1] = __fmaf_rn(gm, xhat(in[u].a[e], s0), acc[1]);
        if (MODE == BN_BN_ADD_RELU)
          acc[J - 1] = __fmaf_rn(gm, xhat(in[u].b[e], s1), acc[J - 1]);
      }
  }
  block_sum<J>(acc);
  if (threadIdx.x == 0)
#pragma unroll
    for (int j = 0; j < J; ++j)
      q.part[((long long)blockIdx.y * J + j) * C + c] = acc[j];
}

// Thread c: the partials summed in order, to tot[j][c] (a mesh sums tot over
// its data ranks) and to the parameters' gradients, this rank's own:
// dbeta0 = dbeta1 = Sum gm, dgamma0 = Sum gm xhat0, dgamma1 = Sum gm xhat1.
__global__ void __launch_bounds__(FIN_THREADS)
    bwd_finalize_kernel(const float* __restrict__ part, int P, int J, int C,
                        float* __restrict__ tot, float* __restrict__ dbeta0,
                        float* __restrict__ dgamma0,
                        float* __restrict__ dbeta1,
                        float* __restrict__ dgamma1) {
  const int c = blockIdx.x * FIN_THREADS + threadIdx.x;
  if (c >= C) return;
  float s[3] = {0.f, 0.f, 0.f};
  for (int p = 0; p < P; ++p)
    for (int j = 0; j < J; ++j) s[j] += part[((long long)p * J + j) * C + c];
  for (int j = 0; j < J; ++j) tot[j * C + c] = s[j];
  dbeta0[c] = s[0];
  dgamma0[c] = s[1];
  if (J == 3) {
    dbeta1[c] = s[0];
    dgamma1[c] = s[2];
  }
}

__device__ __forceinline__ float dx_of(float gm, float mean_g, float x,
                                       const Chan& s) {
  return __fmul_rn(s.scale, __fsub_rn(__fsub_rn(gm, mean_g),
                                      __fmul_rn(xhat(x, s), s.k)));
}

// CTA (c, p): dx0 (and dx1, or dr = gm for a residual input) over channel
// c's slab, from the totals.
template <typename T, typename G, int MODE>
__global__ void __launch_bounds__(THREADS, MIN_CTAS) bwd_apply_kernel(const Bwd q) {
  constexpr int N = group_n<T>();
  constexpr int U = MODE == BN_BN_ADD_RELU ? 1 : 2;
  const int C = q.C, c = blockIdx.x;
  const int K = MODE == BN_BN_ADD_RELU ? 2 * C : C;
  const Slab<N> sl(c, q.B, C, q.L, q.rows_per_slab);
  const float mean_g = __fdiv_rn(q.tot[c], q.count);
  Chan s0 = chan(q.stats, K, c);
  if (q.stats[4 * K + c] != 0.f) s0.k = __fdiv_rn(q.tot[C + c], q.count);
  Chan s1 = s0;
  if (MODE == BN_BN_ADD_RELU) {
    s1 = chan(q.stats, K, C + c);
    if (q.stats[4 * K + C + c] != 0.f)
      s1.k = __fdiv_rn(q.tot[2 * C + c], q.count);
  }
  for (int j = threadIdx.x; j < sl.groups; j += THREADS * U) {
    BwdGroup<T, G, MODE, N> in[U];
    long long off[U];
    int cnt[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cnt[u] = sl.at(j + u * THREADS, off[u]);
      if (cnt[u]) in[u].load_at(q, off[u], cnt[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!cnt[u]) break;
      float d0[N], d1[N];
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float gm = in[u].masked(q, e, s0, s1);
        d0[e] = dx_of(gm, mean_g, in[u].a[e], s0);
        if (MODE == BN_BN_ADD_RELU) d1[e] = dx_of(gm, mean_g, in[u].b[e], s1);
        if (MODE == BN_INPUT_ADD_RELU) d1[e] = gm;
      }
      store<T, N>(static_cast<T*>(q.dx0) + off[u], cnt[u], q.vec, d0);
      if (MODE == BN_BN_ADD_RELU)
        store<T, N>(static_cast<T*>(q.dx1) + off[u], cnt[u], q.vec, d1);
      if (MODE == BN_INPUT_ADD_RELU)
        store<float, N>(q.dr + off[u], cnt[u], q.vec, d1);
    }
  }
}

// ---- launches ------------------------------------------------------------

inline dim3 grid_of(int channels, int B, int rows_per_slab) {
  return dim3(channels, (B + rows_per_slab - 1) / rows_per_slab);
}

template <typename T, typename O>
int apply_mode(int mode, const void* x0, const void* x1, const float* r,
               void* out, const float* stats, int B, int C, int L,
               int rows_per_slab, bool vec, cudaStream_t s) {
  const dim3 grid = grid_of(C, B, rows_per_slab);
  const T* a = static_cast<const T*>(x0);
  const T* b = static_cast<const T*>(x1);
  O* y = static_cast<O*>(out);
  switch (mode) {
    case BN_RELU:
      apply_kernel<T, O, BN_RELU><<<grid, THREADS, 0, s>>>(
          a, b, r, y, stats, B, C, L, rows_per_slab, vec);
      break;
    case BN_BN_ADD_RELU:
      apply_kernel<T, O, BN_BN_ADD_RELU><<<grid, THREADS, 0, s>>>(
          a, b, r, y, stats, B, C, L, rows_per_slab, vec);
      break;
    default:
      apply_kernel<T, O, BN_INPUT_ADD_RELU><<<grid, THREADS, 0, s>>>(
          a, b, r, y, stats, B, C, L, rows_per_slab, vec);
  }
  return (int)cudaGetLastError();
}

template <typename T, typename G, int MODE>
void launch_bwd(bool reduce, const Bwd& q, cudaStream_t s) {
  const dim3 grid = grid_of(q.C, q.B, q.rows_per_slab);
  if (reduce)
    bwd_reduce_kernel<T, G, MODE><<<grid, THREADS, 0, s>>>(q);
  else
    bwd_apply_kernel<T, G, MODE><<<grid, THREADS, 0, s>>>(q);
}

template <typename T, typename G>
void bwd_mode(int mode, bool reduce, const Bwd& q, cudaStream_t s) {
  switch (mode) {
    case BN_RELU:
      return launch_bwd<T, G, BN_RELU>(reduce, q, s);
    case BN_BN_ADD_RELU:
      return launch_bwd<T, G, BN_BN_ADD_RELU>(reduce, q, s);
    default:
      return launch_bwd<T, G, BN_INPUT_ADD_RELU>(reduce, q, s);
  }
}

int bwd_pass(bool reduce, int mode, const Bwd& q, int is_bf16, int g_f32,
             void* stream) {
  if (q.B < 1 || q.C < 1 || q.L < 1 || mode < 0 || mode > 2 ||
      q.rows_per_slab < 1 || !(q.count > 0.f) || (!is_bf16 && !g_f32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    bwd_mode<float, float>(mode, reduce, q, s);
  else if (g_f32)
    bwd_mode<__nv_bfloat16, float>(mode, reduce, q, s);
  else
    bwd_mode<__nv_bfloat16, __nv_bfloat16>(mode, reduce, q, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x0 (and x1 when nt == 2): contiguous (B, C, L) of the compute dtype (bf16
// when is_bf16, else f32); part: (P, 2, nt * C) float32, P = ceil(B /
// rows_per_slab); vec 1 when every row is whole 16-byte groups and the
// buffers 16-byte aligned. Launches on `stream`; returns its cudaError_t.
int bn_stats(const void* x0, const void* x1, float* part, int nt, int B,
             int C, int L, int rows_per_slab, int is_bf16, int vec,
             void* stream) {
  if (nt < 1 || nt > 2 || B < 1 || C < 1 || L < 1 || rows_per_slab < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(nt * C, B, rows_per_slab);
  if (is_bf16)
    stats_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x0),
        static_cast<const __nv_bfloat16*>(x1), part, B, C, L, rows_per_slab,
        vec != 0);
  else
    stats_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x0), static_cast<const float*>(x1), part,
        B, C, L, rows_per_slab, vec != 0);
  return (int)cudaGetLastError();
}

// part: (P, 2, K) partials, K = nt * C. sums_only: sums (2, K) = their sums.
// Else stats (5, K) and the running statistics of each tensor's BN
// (gamma, beta, running mean and var: C floats each; the second set read
// when K == 2 C). count is n, the elements of a channel over every rank.
int bn_finalize(const float* part, int P, int K, int C, float count,
                float eps, float momentum, float keep, const float* gamma0,
                const float* beta0, float* rmean0, float* rvar0,
                const float* gamma1, const float* beta1, float* rmean1,
                float* rvar1, float* stats, float* sums, int sums_only,
                void* stream) {
  if (P < 1 || C < 1 || (K != C && K != 2 * C) || !(count > 0.f))
    return (int)cudaErrorInvalidValue;
  const BnParams prm{{gamma0, gamma1}, {beta0, beta1}, {rmean0, rmean1},
                     {rvar0, rvar1}};
  finalize_kernel<<<(K + FIN_THREADS - 1) / FIN_THREADS, FIN_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      part, P, K, C, count, eps, momentum, keep, prm, stats, sums,
      sums_only != 0);
  return (int)cudaGetLastError();
}

// mode 0: out = relu(BN(x0)); 1: relu(BN(x0) + BN'(x1)); 2: relu(BN(x0) +
// r), r float32 of x0's shape. out is float32 when out_f32, else x0's dtype.
int bn_apply(int mode, const void* x0, const void* x1, const float* r,
             void* out, const float* stats, int B, int C, int L,
             int rows_per_slab, int is_bf16, int out_f32, int vec,
             void* stream) {
  if (B < 1 || C < 1 || L < 1 || mode < 0 || mode > 2 ||
      rows_per_slab < 1 || (!is_bf16 && !out_f32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return apply_mode<float, float>(mode, x0, x1, r, out, stats, B, C, L,
                                    rows_per_slab, vec != 0, s);
  if (out_f32)
    return apply_mode<__nv_bfloat16, float>(mode, x0, x1, r, out, stats, B,
                                            C, L, rows_per_slab, vec != 0,
                                            s);
  return apply_mode<__nv_bfloat16, __nv_bfloat16>(
      mode, x0, x1, r, out, stats, B, C, L, rows_per_slab, vec != 0, s);
}

// The backward's reduction: part (P, J, C), J = 3 for mode 1 else 2; g
// (and g2, or null) of the output's dtype (float32 when g_f32).
int bn_bwd_reduce(int mode, const void* g, const void* g2, const void* x0,
                  const void* x1, const float* r, const float* stats,
                  float* part, int B, int C, int L, int rows_per_slab,
                  int is_bf16, int g_f32, int vec, void* stream) {
  const Bwd q{g, g2, x0, x1, r, stats, part, nullptr, nullptr, nullptr,
              nullptr, B, C, L, rows_per_slab, 1.f, vec != 0};
  return bwd_pass(true, mode, q, is_bf16, g_f32, stream);
}

// tot (J, C) and the parameters' gradients (C floats each; dbeta1 and
// dgamma1 written when J == 3) from part (P, J, C).
int bn_bwd_finalize(const float* part, int P, int J, int C, float* tot,
                    float* dbeta0, float* dgamma0, float* dbeta1,
                    float* dgamma1, void* stream) {
  if (P < 1 || C < 1 || J < 2 || J > 3) return (int)cudaErrorInvalidValue;
  bwd_finalize_kernel<<<(C + FIN_THREADS - 1) / FIN_THREADS, FIN_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      part, P, J, C, tot, dbeta0, dgamma0, dbeta1, dgamma1);
  return (int)cudaGetLastError();
}

// dx0 (and dx1 in mode 1, dr float32 in mode 2) from tot (J, C), the
// totals over every rank; count as in bn_finalize.
int bn_bwd_apply(int mode, const void* g, const void* g2, const void* x0,
                 const void* x1, const float* r, const float* stats,
                 const float* tot, void* dx0, void* dx1, float* dr, int B,
                 int C, int L, int rows_per_slab, float count, int is_bf16,
                 int g_f32, int vec, void* stream) {
  const Bwd q{g, g2, x0, x1, r, stats, nullptr, tot, dx0, dx1, dr, B, C, L,
              rows_per_slab, count, vec != 0};
  return bwd_pass(false, mode, q, is_bf16, g_f32, stream);
}

const char* bn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// AdamW over every leaf of an optimizer in one launch, and the gradient
// accumulation's fold, for Hopper (sm_90a).
//
// Not a port of a TPU kernel: the JAX package's optimizer is an XLA fusion
// (fused_adamw / make_adamw, silent_speech_tpu/train/state.py). The port
// looped in Python over the leaves (train/state.py FusedAdamW), one eager
// op after another: 20 launches a leaf with bf16 moments, 18 with float32,
// ~2,400 an update at the transduction model's 120 leaves, each a full
// pass over its leaf with float32 temporaries. These kernels compute the
// same numbers in one pass over all the leaves.
//
// The arithmetic, bit for bit that of the loop on the card, element by
// element, every operation rounded once (the intrinsics keep nvcc from
// contracting a multiply and an add into one FMA that the loop rounds
// twice):
//   m32 = b1*m + (1-b1)*g            v32 = b2*v + (1-b2)*(g*g)
//   upd = (m32*inv_bc1) / (sqrt(v32*inv_bc2) + eps) + wd*p
//   p   = p + (-lr)*upd              m, v = m32, v32 rounded to the moments'
//                                           type (bf16: to nearest even)
// PyTorch's CUDA division of a tensor by a CPU scalar multiplies by the
// scalar's float32 reciprocal, so the host passes inv_bc = 1/bc (float32);
// every scalar is a float32 computed on the host as the loop computes it.
// The fold: acc = acc + (g - acc)*inv_n, inv_n the float32 reciprocal of
// the micro-step's count n, as torch._foreach_div_ by a scalar computes on
// the card (true division would part from it at n = 3). An update may read the
// accumulator in place of a gradient and then writes it back as zeros.
// A leaf without a gradient reads zeros (a null pointer).
//
// What bounds it on the card: bytes. Per element an update reads p, g, m, v
// and writes p, m, v: 20 bytes with bf16 moments, 28 with float32; at the
// transduction model's 54.2 M parameters 1.08 GB, 0.32 ms at 3.35 TB/s.
// The fold moves 12 bytes an element. The arithmetic, ~12 floating-point
// operations an element with one divide and one square root, is far below
// what the SMs issue in that time.
//
// Design: each leaf is cut into chunks of CHUNK consecutive elements, never
// across a leaf, numbered leaf after leaf. Everything a launch needs goes by
// value in its parameter block: each leaf's p/m/v/acc and gradient pointers
// (the gradients are new tensors every step), its size and its first chunk,
// for up to MAX_LEAVES leaves (more leaves take more launches). So the
// kernels read no table from device memory and the optimizer holds none.
// Persistent CTAs take the chunks c = blockIdx.x, + gridDim.x, ...; a CTA
// finds each chunk's leaf by walking the leaves' first chunks forward. In a
// chunk each thread takes 4 consecutive elements UNROLL times, all loads
// issued before any arithmetic: 16 bytes a load for float32 (float4), 8 for
// four bf16 moments, streaming (read once, evict first). A leaf whose
// buffers or gradient are not 16-byte aligned, and a leaf's ragged last
// group, go element by element. Nothing but p, m, v and acc is written,
// and nothing is allocated.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CTAS_PER_SM = 2;
constexpr int UNROLL = 4;
constexpr int CHUNK = THREADS * 4 * UNROLL;  // elements a chunk: one pass
constexpr int MAX_LEAVES = 256;

// A leaf of a launch: its buffers, its gradient (null: zero), its size, and
// its first chunk counted in the launch.
struct Leaf {
  float* p;
  void* m;
  void* v;
  float* acc;  // null without accumulation
  const float* g;
  long long n;
  int first;
  int pad;
};

struct Hyper {
  float b1, b2, omb1, omb2, inv_bc1, inv_bc2, eps, wd, neg_lr;
};

// One launch's parameter block: up to MAX_LEAVES leaves and their
// n_chunks chunks, all by value (__grid_constant__: read from the constant
// bank, never copied). Past the classic 4 KB of kernel parameters: CUDA
// 12.1 and later take 32,764 bytes on Volta and later.
struct Args {
  int n_leaves, n_chunks;
  Hyper h;
  float inv_n;
  Leaf leaf[MAX_LEAVES];
};
static_assert(sizeof(Args) <= 32764, "a kernel's parameters hold 32,764 B");

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The leaf that holds chunk c, from leaf k (the last leaf whose first chunk
// is at most c: a leaf without elements shares its first with the next
// one). A CTA's chunks rise, so it walks each leaf once.
__device__ __forceinline__ int leaf_of(const Args& a, int c, int k) {
  while (k + 1 < a.n_leaves && a.leaf[k + 1].first <= c) ++k;
  return k;
}

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
}

__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
}

// A moment's element type: loads widen to float, stores round.
template <typename M> struct Moment;

template <> struct Moment<float> {
  __device__ static void get4(const void* b, long long i, float (&x)[4]) {
    load4(static_cast<const float*>(b) + i, x);
  }
  __device__ static void put4(void* b, long long i, const float (&x)[4]) {
    store4(static_cast<float*>(b) + i, x);
  }
  __device__ static float get(const void* b, long long i) {
    return static_cast<const float*>(b)[i];
  }
  __device__ static void put(void* b, long long i, float x) {
    static_cast<float*>(b)[i] = x;
  }
};

template <> struct Moment<__nv_bfloat16> {
  __device__ static unsigned bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  __device__ static void get4(const void* b, long long i, float (&x)[4]) {
    const uint2 q = __ldcs(reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(b) + i));
    x[0] = __uint_as_float(q.x << 16);
    x[1] = __uint_as_float(q.x & 0xFFFF0000u);
    x[2] = __uint_as_float(q.y << 16);
    x[3] = __uint_as_float(q.y & 0xFFFF0000u);
  }
  __device__ static void put4(void* b, long long i, const float (&x)[4]) {
    __stcs(reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(b) + i),
           make_uint2(bits(x[0]) | bits(x[1]) << 16,
                      bits(x[2]) | bits(x[3]) << 16));
  }
  __device__ static float get(const void* b, long long i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(b)[i]);
  }
  __device__ static void put(void* b, long long i, float x) {
    static_cast<__nv_bfloat16*>(b)[i] = __float2bfloat16_rn(x);
  }
};

// One element's AdamW step, in the loop's order of operations.
__device__ __forceinline__ void adamw(float& p, float g, float& m, float& v,
                                      const Hyper& h) {
  const float m32 = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  const float v32 = __fadd_rn(__fmul_rn(h.b2, v),
                              __fmul_rn(h.omb2, __fmul_rn(g, g)));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v32, h.inv_bc2)), h.eps);
  const float upd = __fadd_rn(__fdiv_rn(__fmul_rn(m32, h.inv_bc1), den),
                              __fmul_rn(h.wd, p));
  p = __fadd_rn(p, __fmul_rn(h.neg_lr, upd));
  m = m32;
  v = v32;
}

__device__ __forceinline__ float fold(float acc, float g, float inv_n) {
  return __fadd_rn(acc, __fmul_rn(__fsub_rn(g, acc), inv_n));
}

// Chunk c of leaf L: elements [base, stop).
__device__ __forceinline__ void span(const Leaf& L, int c, long long& base,
                                     long long& stop) {
  base = (long long)(c - L.first) * CHUNK;
  stop = base + CHUNK < L.n ? base + CHUNK : L.n;
}

// FROM_ACC: the update reads the accumulator as its gradient and zeroes it.
template <typename M, bool FROM_ACC>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
    update_kernel(const __grid_constant__ Args a) {
  using Mo = Moment<M>;
  int k = 0;
  for (int c = blockIdx.x; c < a.n_chunks; c += gridDim.x) {
    k = leaf_of(a, c, k);
    const Leaf& L = a.leaf[k];
    const float* g = FROM_ACC ? L.acc : L.g;
    long long base, stop;
    span(L, c, base, stop);
    if (!(aligned16(L.p) && aligned16(L.m) && aligned16(L.v) &&
          aligned16(g))) {
      for (long long i = base + threadIdx.x; i < stop; i += THREADS) {
        float p = L.p[i], m = Mo::get(L.m, i), v = Mo::get(L.v, i);
        adamw(p, g ? g[i] : 0.f, m, v, a.h);
        L.p[i] = p;
        Mo::put(L.m, i, m);
        Mo::put(L.v, i, v);
        if (FROM_ACC) L.acc[i] = 0.f;
      }
      continue;
    }
    float p[UNROLL][4], gr[UNROLL][4], m[UNROLL][4], v[UNROLL][4];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + 4 * (threadIdx.x + u * THREADS);
      if (i + 4 <= stop) {
        load4(L.p + i, p[u]);
        if (g) load4(g + i, gr[u]);
        else gr[u][0] = gr[u][1] = gr[u][2] = gr[u][3] = 0.f;
        Mo::get4(L.m, i, m[u]);
        Mo::get4(L.v, i, v[u]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = i + j < stop;
          p[u][j] = in ? L.p[i + j] : 0.f;
          gr[u][j] = in && g ? g[i + j] : 0.f;
          m[u][j] = in ? Mo::get(L.m, i + j) : 0.f;
          v[u][j] = in ? Mo::get(L.v, i + j) : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        adamw(p[u][j], gr[u][j], m[u][j], v[u][j], a.h);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + 4 * (threadIdx.x + u * THREADS);
      if (i + 4 <= stop) {
        store4(L.p + i, p[u]);
        Mo::put4(L.m, i, m[u]);
        Mo::put4(L.v, i, v[u]);
        if (FROM_ACC) {
          const float zero[4] = {0.f, 0.f, 0.f, 0.f};
          store4(L.acc + i, zero);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (i + j < stop) {
            L.p[i + j] = p[u][j];
            Mo::put(L.m, i + j, m[u][j]);
            Mo::put(L.v, i + j, v[u][j]);
            if (FROM_ACC) L.acc[i + j] = 0.f;
          }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
    fold_kernel(const __grid_constant__ Args a) {
  int k = 0;
  for (int c = blockIdx.x; c < a.n_chunks; c += gridDim.x) {
    k = leaf_of(a, c, k);
    const Leaf& L = a.leaf[k];
    const float* g = L.g;
    long long base, stop;
    span(L, c, base, stop);
    if (!(aligned16(L.acc) && aligned16(g))) {
      for (long long i = base + threadIdx.x; i < stop; i += THREADS)
        L.acc[i] = fold(L.acc[i], g ? g[i] : 0.f, a.inv_n);
      continue;
    }
    float acc[UNROLL][4], gr[UNROLL][4];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + 4 * (threadIdx.x + u * THREADS);
      if (i + 4 <= stop) {
        load4(L.acc + i, acc[u]);
        if (g) load4(g + i, gr[u]);
        else gr[u][0] = gr[u][1] = gr[u][2] = gr[u][3] = 0.f;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool in = i + j < stop;
          acc[u][j] = in ? L.acc[i + j] : 0.f;
          gr[u][j] = in && g ? g[i + j] : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + 4 * (threadIdx.x + u * THREADS);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[u][j] = fold(acc[u][j], gr[u][j], a.inv_n);
      if (i + 4 <= stop) {
        store4(L.acc + i, acc[u]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (i + j < stop) L.acc[i + j] = acc[u][j];
      }
    }
  }
}

// Persistent CTAs: enough to fill every SM, no more than the chunks.
inline int ctas_for(int n_chunks) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int most = sms * CTAS_PER_SM;
  return n_chunks < most ? n_chunks : most;
}

// The parameter block of a launch; false on arguments out of range. ptrs:
// 5 a leaf (p, m, v, acc, g); first: each leaf's first chunk, rising from 0.
bool make_args(Args& a, const unsigned long long* ptrs, const long long* n,
               const int* first, int n_leaves, int n_chunks) {
  if (!ptrs || !n || !first || n_leaves < 1 || n_leaves > MAX_LEAVES ||
      n_chunks < 1 || first[0] != 0)
    return false;
  a.n_leaves = n_leaves;
  a.n_chunks = n_chunks;
  a.h = Hyper{};
  a.inv_n = 1.f;
  for (int k = 0; k < n_leaves; ++k) {
    const unsigned long long* q = ptrs + 5 * k;
    const long long chunks = (n[k] + CHUNK - 1) / CHUNK;
    const int next = k + 1 < n_leaves ? first[k + 1] : n_chunks;
    // an empty leaf may have no storage
    if (n[k] < 0 || (n[k] && (!q[0] || !q[1] || !q[2])) ||
        next - first[k] != chunks)
      return false;
    a.leaf[k] = Leaf{reinterpret_cast<float*>(q[0]),
                     reinterpret_cast<void*>(q[1]),
                     reinterpret_cast<void*>(q[2]),
                     reinterpret_cast<float*>(q[3]),
                     reinterpret_cast<const float*>(q[4]), n[k], first[k], 0};
  }
  return true;
}

}  // namespace

extern "C" {

// The leaves one launch takes at most, and the elements of a chunk.
int adamw_leaves_per_launch(void) { return MAX_LEAVES; }
int adamw_chunk_elements(void) { return CHUNK; }

// One AdamW update of n_leaves leaves: ptrs holds 5 device pointers a leaf
// (p, m, v, acc or 0, the gradient or 0 for a zero gradient), n their
// sizes, first their first chunks (0, then rising by each leaf's
// ceil(n / CHUNK)), n_chunks their chunks in all. from_acc 1 reads each
// leaf's accumulator in place of its gradient and zeroes it. Moments bf16
// (bf16_moments 1) or float32. Launches on `stream`; returns the launch's
// cudaError_t.
int adamw_update(const unsigned long long* ptrs, const long long* n,
                 const int* first, int n_leaves, int n_chunks, float b1,
                 float b2, float omb1, float omb2, float inv_bc1,
                 float inv_bc2, float eps, float wd, float neg_lr,
                 int from_acc, int bf16_moments, void* stream) {
  Args a;
  if (!make_args(a, ptrs, n, first, n_leaves, n_chunks))
    return (int)cudaErrorInvalidValue;
  for (int k = 0; from_acc && k < n_leaves; ++k)
    if (a.leaf[k].n && !a.leaf[k].acc) return (int)cudaErrorInvalidValue;
  a.h = Hyper{b1, b2, omb1, omb2, inv_bc1, inv_bc2, eps, wd, neg_lr};
  auto kernel = bf16_moments
                    ? (from_acc ? update_kernel<__nv_bfloat16, true>
                                : update_kernel<__nv_bfloat16, false>)
                    : (from_acc ? update_kernel<float, true>
                                : update_kernel<float, false>);
  kernel<<<ctas_for(n_chunks), THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// acc = acc + (g - acc)*inv_n over n_leaves leaves, the arguments as
// adamw_update's (every acc set).
int adamw_fold(const unsigned long long* ptrs, const long long* n,
               const int* first, int n_leaves, int n_chunks, float inv_n,
               void* stream) {
  Args a;
  if (!make_args(a, ptrs, n, first, n_leaves, n_chunks))
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < n_leaves; ++k)
    if (a.leaf[k].n && !a.leaf[k].acc) return (int)cudaErrorInvalidValue;
  a.inv_n = inv_n;
  fold_kernel<<<ctas_for(n_chunks), THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* adamw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

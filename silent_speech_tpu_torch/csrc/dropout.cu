// Counter-hash dropout for Hopper (sm_90a): mask, scale and the optional
// ReLU in one pass over the tensor, and the ReLU-dropout's backward.
//
// Not a port of a TPU kernel: the JAX package's regenerating dropout is an
// XLA fusion (silent_speech_tpu/ops/dropout.py). The port drew its mask in
// plain tensor code (ops/dropout.py keep_mask): int64 passes for the hash,
// an 8-byte-an-element byte split, the compare, the multiply and a where,
// ~23 launches and ~98 bytes of traffic an element, and a blocking copy of
// the scale to the card at every site. This kernel draws the same bits.
//
// The bits, bit for bit those of keep_mask: element n of the one-process
// tensor keeps iff byte n mod 4 of hash_bits(n >> 2, 0, seed) is at least
// `threshold` (relattn::hash_bits, the attention kernels' mixer; the word
// index is taken mod 2^32, as the plain version's 32-bit masking does).
// A launch covers a tensor of n elements, rows of `width`, that lies in the
// one-process tensor at row `row0`, column `col0` of `cols`: its element i
// has the index base + i where it holds whole rows (col0 == 0 and cols ==
// width; base = row0 * cols), else (row0 + i / width) * cols + col0 +
// i % width. All in 64 bits.
//
// The value: y = keep ? round(float(x) * scale) : +0, with x first put
// through a ReLU (x < 0 ? 0 : x, so that a NaN stays a NaN) where asked;
// `scale` is the keep scale already rounded to the tensor's dtype, and the
// product is one float32 multiply rounded to the dtype (round to nearest
// even), which is what PyTorch's multiply of a bf16 or f32 tensor by a
// scalar of its dtype computes. The backward of relu_dropout is
// out = y > 0 ? round(float(g) * scale) : +0.
//
// What bounds it on the card: bytes. One read and one write of the tensor
// (two reads and a write in the backward); at the training step's
// 24,000 x 3072 bf16 FFN activation that is 295 MB, 0.088 ms at 3.35 TB/s.
// The hash is ~10 integer operations a 32-bit word, a word serving four
// elements: far below what the SMs issue in that time.
//
// Design: a thread takes 16 bytes at a time (8 bf16 or 4 f32 elements, two
// or one hash words), UNROLL such groups loaded before any is computed so
// that each thread keeps several loads in flight; a grid-stride loop over
// CTAS_PER_SM CTAs of 256 threads on each SM. A group of consecutive
// indices hashes each of its words once and shifts the run of bytes by the
// first index's byte within its word (a funnel shift), so a start that
// is not a multiple of 4 costs one hash more and no branch per element.
// Only a group that crosses a row's end in a shard of columns, and the
// tensor's last, partial group, go element by element. Buffers that are not
// 16-byte aligned take element-by-element loads and stores throughout.
// Measured on the H100 (PERF.md §6): 76-87% of the byte bound at the
// training step's shapes, 38-40 registers, no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "rel_attention.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CTAS_PER_SM = 8;
constexpr int UNROLL = 2;

// An element's bits in a 32-bit word, and its value as a float.
template <typename T> struct Elem;

template <> struct Elem<__nv_bfloat16> {
  static constexpr int PER_WORD = 2;
  using Raw = unsigned short;
  __device__ static float get(unsigned bits) {
    return __uint_as_float(bits << 16);
  }
  __device__ static unsigned put(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

template <> struct Elem<float> {
  static constexpr int PER_WORD = 1;
  using Raw = unsigned;
  __device__ static float get(unsigned bits) { return __uint_as_float(bits); }
  __device__ static unsigned put(float f) { return __float_as_uint(f); }
};

// 16 bytes of a tensor: V elements from index i0, as four 32-bit words.
template <typename T> struct Group {
  static constexpr int PW = Elem<T>::PER_WORD;
  static constexpr int V = 4 * PW;
  static constexpr int BITS = 32 / PW;
  using Raw = typename Elem<T>::Raw;
  unsigned w[4];

  __device__ unsigned bits(int j) const {
    return PW == 1 ? w[j] : (w[j / PW] >> (BITS * (j % PW))) & 0xFFFFu;
  }
  __device__ float value(int j) const { return Elem<T>::get(bits(j)); }

  // the whole 16 bytes at once when `vec` (aligned buffers) and the group
  // lies inside the tensor; else element by element, 0 past its end
  __device__ void load(const T* p, long long i0, long long n, bool vec) {
    if (vec && i0 + V <= n) {
      const uint4 q = *reinterpret_cast<const uint4*>(p + i0);
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
      return;
    }
    const Raw* r = reinterpret_cast<const Raw*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = 0u;
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (i0 + j < n) w[j / PW] |= (unsigned)r[i0 + j] << (BITS * (j % PW));
  }

  __device__ void store(T* p, long long i0, long long n, bool vec) const {
    if (vec && i0 + V <= n) {
      *reinterpret_cast<uint4*>(p + i0) = make_uint4(w[0], w[1], w[2], w[3]);
      return;
    }
    Raw* r = reinterpret_cast<Raw*>(p);
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (i0 + j < n) r[i0 + j] = (Raw)bits(j);
  }
};

// Where the tensor lies in the one-process tensor (see the note above).
struct Geometry {
  long long base, row0, col0, cols;
  int width;
  bool whole;
  unsigned seed;
};

// The random bytes of the consecutive indices g0 .. g0 + 4*NW - 1, four to
// a word in index order: the words g0 >> 2 .. hashed once each, the run
// shifted by g0's byte within its word.
template <int NW>
__device__ __forceinline__ void run_bytes(long long g0, unsigned seed,
                                          unsigned (&b)[NW]) {
  const unsigned w0 = (unsigned)(g0 >> 2);
  const unsigned sh = 8u * (unsigned)(g0 & 3);
  unsigned h[NW + 1];
#pragma unroll
  for (int k = 0; k < NW; ++k) h[k] = relattn::hash_bits(w0 + k, 0u, seed);
  h[NW] = sh ? relattn::hash_bits(w0 + NW, 0u, seed) : 0u;
#pragma unroll
  for (int k = 0; k < NW; ++k) b[k] = __funnelshift_r(h[k], h[k + 1], sh);
}

// The random bytes of the V elements from local index i0.
template <int V>
__device__ __forceinline__ void group_bytes(const Geometry& G, long long i0,
                                            unsigned (&b)[V / 4]) {
  if (G.whole) {
    run_bytes<V / 4>(G.base + i0, G.seed, b);
    return;
  }
  long long r = i0 / G.width;
  int c = (int)(i0 - r * G.width);
  if (c + V <= G.width) {
    run_bytes<V / 4>((G.row0 + r) * G.cols + G.col0 + c, G.seed, b);
    return;
  }
  // the group crosses the end of a row of the shard: each element's own
  // index and byte
#pragma unroll
  for (int k = 0; k < V / 4; ++k) b[k] = 0u;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (c == G.width) {
      c = 0;
      ++r;
    }
    const long long g = (G.row0 + r) * G.cols + G.col0 + c;
    const unsigned byte = (relattn::hash_bits((unsigned)(g >> 2), 0u, G.seed)
                           >> (8u * (unsigned)(g & 3))) & 0xFFu;
    b[j / 4] |= byte << (8 * (j % 4));
    ++c;
  }
}

template <typename T, bool RELU>
__global__ void __launch_bounds__(THREADS)
    mask_scale_kernel(const T* __restrict__ x, T* __restrict__ y,
                      long long n, Geometry G, unsigned threshold,
                      float scale, bool vec) {
  using Gp = Group<T>;
  constexpr int V = Gp::V;
  const long long groups = (n + V - 1) / V;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
       g < groups; g += UNROLL * stride) {
    Gp in[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (g + u * stride < groups) in[u].load(x, (g + u * stride) * V, n, vec);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i0 = (g + u * stride) * V;
      if (g + u * stride >= groups) break;
      unsigned b[V / 4];
      group_bytes<V>(G, i0, b);
      Gp out;
#pragma unroll
      for (int k = 0; k < 4; ++k) out.w[k] = 0u;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float v = in[u].value(j);
        if (RELU) v = v < 0.f ? 0.f : v;
        const bool keep = ((b[j / 4] >> (8 * (j % 4))) & 0xFFu) >= threshold;
        const unsigned o = keep ? Elem<T>::put(v * scale) : 0u;
        out.w[j / Gp::PW] |= o << (Gp::BITS * (j % Gp::PW));
      }
      out.store(y, i0, n, vec);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    relu_dropout_bwd_kernel(const T* __restrict__ grad,
                            const T* __restrict__ y, T* __restrict__ out,
                            long long n, float scale, bool vec) {
  using Gp = Group<T>;
  constexpr int V = Gp::V;
  const long long groups = (n + V - 1) / V;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
       g < groups; g += UNROLL * stride) {
    Gp gin[UNROLL], yin[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (g + u * stride < groups) {
        gin[u].load(grad, (g + u * stride) * V, n, vec);
        yin[u].load(y, (g + u * stride) * V, n, vec);
      }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (g + u * stride >= groups) break;
      Gp o;
#pragma unroll
      for (int k = 0; k < 4; ++k) o.w[k] = 0u;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const unsigned r = yin[u].value(j) > 0.f
                               ? Elem<T>::put(gin[u].value(j) * scale)
                               : 0u;
        o.w[j / Gp::PW] |= r << (Gp::BITS * (j % Gp::PW));
      }
      o.store(out, (g + u * stride) * V, n, vec);
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// CTAs for n elements of V a group: enough to fill every SM, no more than
// the groups need.
inline int ctas_for(long long n, int V) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long groups = (n + V - 1) / V;
  const long long need = (groups + (long long)THREADS * UNROLL - 1) /
                         ((long long)THREADS * UNROLL);
  const long long most = (long long)sms * CTAS_PER_SM;
  return (int)(need < most ? need : most);
}

template <typename T>
int launch_mask_scale(const void* x, void* y, long long n, Geometry G,
                      int threshold, float scale, int relu,
                      cudaStream_t s) {
  const bool vec = aligned16(x) && aligned16(y);
  auto kernel = relu ? mask_scale_kernel<T, true> : mask_scale_kernel<T, false>;
  kernel<<<ctas_for(n, Group<T>::V), THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, G,
      (unsigned)threshold, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_relu_bwd(const void* g, const void* y, void* out, long long n,
                    float scale, cudaStream_t s) {
  const bool vec = aligned16(g) && aligned16(y) && aligned16(out);
  relu_dropout_bwd_kernel<T><<<ctas_for(n, Group<T>::V), THREADS, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(y),
      static_cast<T*>(out), n, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: n contiguous elements, bf16 (is_bf16 1) or f32, rows of `width`;
// the tensor lies at row row0, column col0 of cols in the one-process
// tensor, base = row0 * cols; seed taken mod 2^32; threshold in [0, 256];
// scale the keep scale in the tensor's dtype; relu 1 applies the ReLU
// first. Launches on `stream` and returns the cudaError_t of the launch.
int dropout_mask_scale(const void* x, void* y, long long n, int width,
                       long long base, long long row0, long long col0,
                       long long cols, unsigned seed, int threshold,
                       float scale, int relu, int is_bf16, void* stream) {
  if (n < 1 || width < 1 || n % width || base < 0 || row0 < 0 || col0 < 0 ||
      cols < col0 + width || base != row0 * cols || threshold < 0 ||
      threshold > 256)
    return (int)cudaErrorInvalidValue;
  const Geometry G{base, row0, col0, cols, width, col0 == 0 && cols == width,
                   seed};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_mask_scale<__nv_bfloat16>(x, y, n, G, threshold,
                                                    scale, relu, s)
                 : launch_mask_scale<float>(x, y, n, G, threshold, scale,
                                            relu, s);
}

// grad, y, out: n contiguous elements of one dtype; out = y > 0 ?
// grad * scale : 0. Launches on `stream`; returns the launch's cudaError_t.
int dropout_relu_bwd(const void* grad, const void* y, void* out,
                     long long n, float scale, int is_bf16, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_relu_bwd<__nv_bfloat16>(grad, y, out, n, scale, s)
                 : launch_relu_bwd<float>(grad, y, out, n, scale, s);
}

const char* dropout_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Shared pieces of the float32 relative-position attention kernels on the
// CUDA cores (rel_attention_fwd.cu, rel_attention_bwd.cu): the constants of
// a 32-query band tile, cp.async staging into a ring of buffers, and the
// register-tiled FP32 FMA products, with no TF32 and no tensor cores.
//
// The band product. One CTA of 256 threads holds QA = 32 query rows and up
// to NCOLS = 256 columns (keys of the band, or relative slots). Each warp
// owns 32 columns and each thread an 8 x 4 register tile of the QA x NCOLS
// block: rows ly + 4i, columns 32 warp + lx + 8j (ly = lane >> 3, lx =
// lane & 7). Both operands are staged with d_h contiguous in KA = 16-wide
// slices of row stride LDK = 20 floats (5 x 16 B, odd), so the 8 rows a
// quarter-warp reads fall in 8 different bank groups; a 4-float step along
// d_h takes 12 128-bit loads for 128 FMAs.
//
// Each including source builds into a library of its own, so these
// definitions live in exactly one translation unit per library.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace f32band {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_DH = 128;
constexpr int NBUF = 2;         // slices in shared memory: one in flight
constexpr int QA = 32;          // query rows of a band tile
constexpr int NCOLS = 256;      // columns of a band product (keys, slots)
constexpr int KA = 16;          // d_h slice of a band product
constexpr int LDK = KA + 4;     // row stride of those slices

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Key columns a band tile stages: [kb, kb + nb), kb being its first
// visible key rounded down to 16.
__host__ __device__ inline int band_cols(int T, int m) {
  return imin(round16(T), round16(QA + 2 * (m - 1) + 15));
}

// A thread's columns of an (output rows) x (16 * NC) block: NC / VW groups
// of VW neighbours, column g * 16 * VW + tx * VW + v for tx < 16.
template <int NC>
struct Cols {
  static constexpr int DH = 16 * NC;
  static constexpr int VW = NC % 4 == 0 ? 4 : (NC % 2 == 0 ? 2 : 1);
  static constexpr int G = NC / VW;
  static constexpr int LDH = DH + 4;  // row stride of a KC x d_h slice
};

template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float* x) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (VW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

template <int VW>
__device__ __forceinline__ void store_vec(float* p, const float* x) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (VW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// Store acc * mult into rows row0 + rstep * i (below n_rows) of a
// row-major (*, 16 * NC) matrix, the thread's columns.
template <int NC>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[8][NC],
                                           int row0, int rstep, int n_rows,
                                           int tx, float mult) {
  using C = Cols<NC>;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + rstep * i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int g = 0; g < C::G; ++g) {
      float x[C::VW];
#pragma unroll
      for (int u = 0; u < C::VW; ++u) x[u] = acc[i][g * C::VW + u] * mult;
      store_vec<C::VW>(out + (size_t)r * C::DH + g * 16 * C::VW + tx * C::VW,
                       x);
    }
  }
}

template <int NC>
__device__ __forceinline__ void zero(float (&acc)[8][NC]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
}

// Start copying rows [r0, r0 + rows) and columns [c0, c0 + COLS) of a
// row-major f32 matrix (n_rows x n_cols, row stride ldg) into dst (row
// stride ld) with cp.async, 16 bytes a thread at a time; cells outside the
// matrix are zero-filled. c0, COLS, n_cols, ldg and ld are multiples of 4.
// The copies land once cp_async_wait returns and a barrier follows.
template <int COLS>
__device__ void stage_async(float* dst, int ld, const float* src, int ldg,
                            int r0, int rows, int n_rows, int c0,
                            int n_cols) {
  constexpr int VECS = COLS / 4;
  for (int idx = threadIdx.x; idx < rows * VECS; idx += NTHREADS) {
    const int r = idx / VECS;
    const int c = (idx - r * VECS) * 4;
    const int gr = r0 + r;
    const int gc = c0 + c;
    const bool in = gr >= 0 && gr < n_rows && gc < n_cols;
    const float* from = in ? src + (size_t)gr * ldg + gc : src;
    const unsigned to =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + r * ld + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to),
                 "l"(from), "r"(in ? 16 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Run body(c, buf) over slices c = 0 .. n-1 through a ring of NBUF
// buffers: load(c, buf) issues the cp.async copies of slice c into buffer
// buf, and slices c + 1 .. c + NBUF - 1 are in flight while body(c) runs.
// Every body runs between two barriers; the second one frees its buffer
// for the slice that the next iteration loads into it. Copies issued
// before the call land with slice 0.
template <typename Load, typename Body>
__device__ __forceinline__ void pipeline(int n, Load load, Body body) {
  if (n <= 0) return;
#pragma unroll
  for (int c = 0; c < NBUF - 1; ++c) {
    if (c < n) load(c, c);
    cp_async_commit();
  }
  for (int c = 0; c < n; ++c) {
    if (c + NBUF - 1 < n) load(c + NBUF - 1, (c + NBUF - 1) % NBUF);
    cp_async_commit();              // empty past the last slice
    cp_async_wait<NBUF - 1>();      // slice c has landed
    __syncthreads();
    body(c, c % NBUF);
    __syncthreads();
  }
}

// The band product's step over one KA slice: acc[i][j] += A[ly + 4i] .
// B[lx + 8j] for the warp's 8 x 4 register tile; a and b hold the slice's
// rows (QA of Q or dO; the warp's 32 of E, K or V) with d_h contiguous.
__device__ __forceinline__ void band_mma(float (&acc)[8][4], const float* a,
                                         const float* b, int ly, int lx) {
#pragma unroll
  for (int kk = 0; kk < KA; kk += 4) {
    float4 av[8], bv[4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ly + 4 * i) * LDK + kk);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (lx + 8 * j) * LDK + kk);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// The band product: acc = A . X^T over d_h for the CTA's QA rows of A (Q
// or dO, rows from q0) and rows x0 + c, c < ncols <= NCOLS, of X (E, K or
// V; rows at or past n_rows read as 0). A warp whose 32 columns all lie at
// or past ncols keeps acc at 0. sA holds NBUF x QA x LDK floats, sB NBUF x
// NCOLS x LDK; ends with a barrier.
__device__ __forceinline__ void band_product(float (&acc)[8][4],
                                             const float* ah,
                             const float* xh, int q0, int T, int x0,
                             int ncols, int n_rows, int dh, float* sA,
                             float* sB) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int rows = ceil_div(ncols, 32) * 32;
  const bool live = 32 * warp < ncols;
  pipeline(
      dh / KA,
      [&](int c, int buf) {
        stage_async<KA>(sA + buf * QA * LDK, LDK, ah, dh, q0, QA, T, c * KA,
                        dh);
        stage_async<KA>(sB + buf * NCOLS * LDK, LDK, xh, dh, x0, rows,
                        n_rows, c * KA, dh);
      },
      [&](int, int buf) {
        if (live)
          band_mma(acc, sA + buf * QA * LDK,
                   sB + buf * NCOLS * LDK + 32 * warp * LDK, lane >> 3,
                   lane & 7);
      });
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// f(std::integral_constant<int, dh / 16>) for dh in 16 .. 128.
template <typename F>
cudaError_t by_width(int dh, F f) {
  switch (dh / 16) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    case 6: return f(std::integral_constant<int, 6>());
    case 7: return f(std::integral_constant<int, 7>());
    default: return f(std::integral_constant<int, 8>());
  }
}

}  // namespace f32band

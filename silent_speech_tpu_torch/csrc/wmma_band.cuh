// Shared pieces of the bf16 relative-position attention kernels that run on
// the tensor cores through WMMA (rel_attention_fwd_wmma.cu,
// rel_attention_bwd_wmma.cu): tile constants, the 16x16x16 bf16 tile
// product with f32 accumulators, cp.async staging into a double buffer,
// the bf16 tile store, and the band product of a 32-query tile against the
// rows of E, K or V that its key band covers.
//
// Each including source builds into a library of its own, so these
// definitions live in exactly one translation unit per library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace wmmaband {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int TILE = 64;                 // rows of a tile and a chunk, B-D
constexpr int QROWS = 32;                // query rows of a stage A CTA
constexpr int KROWS = 32;                // rows of a stage A chunk of E, K, V
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int WM = 16;                   // WMMA tile edge
constexpr int MAX_DH = 128;
constexpr int LDC = TILE + 8;            // row stride of a 64-column chunk
// output tiles of a TILE x dh block that one warp owns, at most
constexpr int MAXT = (TILE / WM) * (MAX_DH / WM) / NWARPS;

using Acc = wmma::fragment<wmma::accumulator, WM, WM, WM, float>;

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// Key columns a stage A query tile stages: [kb, kb + nb), kb being its
// first visible key rounded down to 16.
__host__ __device__ inline int band_cols(int T, int m) {
  return imin(round16(T), round16(QROWS + 2 * (m - 1) + 15));
}

// acc += A . B over k (a multiple of 16) for one 16 x 16 output tile; `a`
// and `b` point at the tile's first element. LA row_major: A[i][kk] at
// a[i * lda + kk]; col_major: at a[kk * lda + i] (A stored transposed).
// LB row_major: B[kk][j] at b[kk * ldb + j]; col_major: at b[j * ldb + kk].
template <typename LA, typename LB>
__device__ __forceinline__ void tile_mma(Acc& acc, const bf16* a, int lda,
                                         const bf16* b, int ldb, int k) {
  wmma::fragment<wmma::matrix_a, WM, WM, WM, bf16, LA> fa;
  wmma::fragment<wmma::matrix_b, WM, WM, WM, bf16, LB> fb;
  const int a_step = std::is_same<LA, wmma::row_major>::value ? WM : WM * lda;
  const int b_step = std::is_same<LB, wmma::row_major>::value ? WM * ldb : WM;
  for (int kk = 0; kk < k; kk += WM) {
    wmma::load_matrix_sync(fa, a, lda);
    wmma::load_matrix_sync(fb, b, ldb);
    wmma::mma_sync(acc, fa, fb, acc);
    a += a_step;
    b += b_step;
  }
}

// Start copying rows [r0, r0 + rows) and columns [c0, c0 + cols) of a
// row-major bf16 matrix (n_rows x n_cols, row stride ldg) into dst (row
// stride ld) with cp.async, 16 bytes a thread at a time; cells outside the
// matrix are zero-filled. c0, cols, n_cols, ldg and ld are multiples of 8.
// The copies land once cp_async_wait returns and a barrier follows.
__device__ void stage_async(bf16* dst, int ld, const bf16* src, int ldg,
                            int r0, int rows, int n_rows, int c0, int cols,
                            int n_cols) {
  const int vecs = cols >> 3;
  for (int idx = threadIdx.x; idx < rows * vecs; idx += NTHREADS) {
    const int r = idx / vecs;
    const int c = (idx - r * vecs) << 3;
    const int gr = r0 + r;
    const int gc = c0 + c;
    const bool in = gr >= 0 && gr < n_rows && gc < n_cols;
    const bf16* from = in ? src + (size_t)gr * ldg + gc : src;
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

// Run body(c, buf) over chunks c = 0 .. n-1 of a double-buffered loop:
// load(c, buf) issues the cp.async copies of chunk c into buffer buf, and
// chunk c + 1 is in flight while body(c) runs. Copies issued before the
// call land with chunk 0. Every body runs between two barriers.
template <typename Load, typename Body>
__device__ __forceinline__ void pipeline(int n, Load load, Body body) {
  if (n <= 0) return;
  load(0, 0);
  cp_async_commit();
  for (int c = 0; c < n; ++c) {
    if (c + 1 < n) {
      load(c + 1, (c + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    body(c, c & 1);
    __syncthreads();
  }
}

// Write one 16 x 16 accumulator tile, times `mult`, as bf16 into rows
// [row0, row0 + 16) below n_rows and columns [col0, col0 + 16) of a
// row-major matrix with row stride ld. `tile` is the warp's own 256 floats
// of shared memory.
__device__ void store_tile(bf16* out, int ld, int row0, int n_rows, int col0,
                           const Acc& acc, float mult, float* tile) {
  const int lane = threadIdx.x & 31;
  wmma::store_matrix_sync(tile, acc, WM, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < WM * WM / 2; e += 32) {
    const int r = e >> 3;
    const int c = (e & 7) << 1;
    if (row0 + r < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row0 + r) * ld +
                                         col0 + c) =
          __floats2bfloat162_rn(tile[r * WM + c] * mult,
                                tile[r * WM + c + 1] * mult);
  }
  __syncwarp();
}

// Stage A's band products: out[i][0 : ncols) = sA[i] . X[x0 + j] for the
// QROWS rows of sA and rows x0 .. x0 + ncols - 1 of a row-major (n_rows x
// dh) matrix X (rows outside [0, n_rows) read as 0), staged KROWS rows at
// a time through the double buffer sX (2 x KROWS x ldh).
__device__ void band_product(const bf16* sA, int ldh, const bf16* src,
                             int x0, int n_rows, int ncols, float* out,
                             int ldo, bf16* sX, int dh) {
  constexpr int NTILE = (QROWS / WM) * (KROWS / WM);  // tiles of a chunk
  const int warp = threadIdx.x >> 5;
  pipeline(
      (ncols + KROWS - 1) / KROWS,
      [&](int c, int buf) {
        stage_async(sX + buf * KROWS * ldh, ldh, src, dh, x0 + c * KROWS,
                    KROWS, n_rows, 0, dh, dh);
      },
      [&](int c, int buf) {
        const bf16* x = sX + buf * KROWS * ldh;
        for (int t = warp; t < NTILE; t += NWARPS) {
          const int rt = t / (KROWS / WM), ct = t % (KROWS / WM);
          const int col = c * KROWS + ct * WM;
          if (col >= ncols) continue;
          Acc acc;
          wmma::fill_fragment(acc, 0.f);
          tile_mma<wmma::row_major, wmma::col_major>(
              acc, sA + rt * WM * ldh, ldh, x + ct * WM * ldh, ldh, dh);
          wmma::store_matrix_sync(out + rt * WM * ldo + col, acc, ldo,
                                  wmma::mem_row_major);
        }
      });
}

}  // namespace wmmaband

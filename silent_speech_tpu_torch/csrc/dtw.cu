// Monotonic DTW alignment for Hopper (sm_90a), with a DP-only mode.
//
// Replaces the TPU kernel `pallas_dtw_align_batch`
// (silent_speech_tpu/ops/pallas/dtw_kernel.py, pl.pallas_call, body
// `_dtw_kernel`) and, with dp_only = 1, its DP-only profiling variant
// (`dponly`, tools/prof_dtw.py, body `_dtw_kernel_dponly`). For each
// utterance u with valid lengths n1 <= T1 rows and n2 <= T2 columns of the
// cost matrix C (T1, T2):
//
//   dtw[0,0] = 0, the rest of row 0 and column 0 = +inf,
//   dtw[i,j] = C[i,j] + min(dtw[i-1,j], dtw[i,j-1], dtw[i-1,j-1])   (f32)
//
// then a backtrace from (n1-1, n2-1) that takes the first minimum in the
// order up, left, diag. Outputs: for each row i < n1 the smallest column
// visited (0 for row 0, unvisited rows and rows >= n1) and the corner cost
// dtw[n1-1, n2-1] (0 when n1 = n2 = 1).
//
// The recurrence is the per-cell one of `dtw_align`
// (silent_speech_tpu/ops/dtw.py), not the Pallas kernel's cumsum/cummin
// form, which rounds differently: every cell is one f32 add of C to an
// exact min, so this kernel, the plain PyTorch version and the JAX scan
// agree bit for bit.
//
// Design. One CTA per utterance walks the anti-diagonals k = i + j of the
// [0, n1) x [0, n2) rectangle (the cells beyond it never reach the
// corner), threads along the diagonal, three diagonals in shared memory.
// Thread t owns the rows i = t mod blockDim, so it sees the columns of
// each of its rows in order: it packs the 2-bit choices (0 up, 1 left,
// 2 diag) of 16 consecutive cells in a per-row word in shared memory and
// stores each finished word to the choice table in global memory
// (T1 x ceil(T2/16) words, 256 KB per utterance at T=1024, held by L2).
// One thread then walks the backtrace. There is no size limit beyond the
// shared memory of the three diagonals and the row words (16 bytes a row:
// T1 up to ~14,000).
//
// What bounds it on the card. The function reads each valid cost once and
// writes T1 + 1 outputs: at K=16, T=1024, bf16 costs and n ~ 800 that is
// ~20 MB, ~6 us at 3.35 TB/s. The DP is a chain of n1 + n2 - 1 dependent
// diagonals and the backtrace a chain of up to n1 + n2 dependent loads, so
// this kernel is latency-bound: each diagonal costs one barrier and one
// uncoalesced cost load per cell (neighbouring threads read addresses
// T2 - 1 elements apart). Pre-skewing the costs, prefetching the next
// diagonal and a row-wise backtrace are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NTHREADS = 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

inline size_t smem_bytes(int T1) { return (size_t)T1 * 4 * sizeof(float); }

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
dtw_kernel(const T* __restrict__ costs, const int* __restrict__ n1s,
           const int* __restrict__ n2s, int* __restrict__ align,
           float* __restrict__ path_cost, unsigned* __restrict__ choices,
           int T1, int T2, int dp_only) {
  extern __shared__ float smem[];
  float* diag[3] = {smem, smem + T1, smem + 2 * T1};
  unsigned* row_word = reinterpret_cast<unsigned*>(smem + 3 * T1);

  const int u = blockIdx.x;
  const int tid = threadIdx.x;
  // lengths outside [1, T] are clamped, as the JAX gathers clamp them
  const int n1 = min(max(n1s[u], 1), T1);
  const int n2 = min(max(n2s[u], 1), T2);
  const T* C = costs + (size_t)u * T1 * T2;
  const int W = (T2 + 15) / 16;
  unsigned* ch = choices + (size_t)u * T1 * W;
  int* al = align + (size_t)u * T1;

  for (int i = tid; i < T1; i += NTHREADS) {
    al[i] = 0;
    row_word[i] = 0u;
  }
  if (tid == 0) diag[0][0] = 0.f;  // diagonal 0 holds only (0, 0)
  __syncthreads();

  int cur = 0;
  for (int k = 1; k <= n1 + n2 - 2; ++k) {
    const float* prev2 = diag[(cur + 2) % 3];  // diagonal k - 2
    const float* prev = diag[cur];             // diagonal k - 1
    cur = (cur + 1) % 3;
    float* d = diag[cur];
    const int i_lo = max(0, k - (n2 - 1));
    const int i_hi = min(n1 - 1, k);
    for (int i = tid; i <= i_hi; i += NTHREADS) {
      if (i < i_lo) continue;
      const int j = k - i;
      if (i == 0 || j == 0) {
        d[i] = INFINITY;
        continue;
      }
      const float up = prev[i - 1];    // dtw[i-1, j]
      const float left = prev[i];      // dtw[i, j-1]
      const float dg = prev2[i - 1];   // dtw[i-1, j-1]
      const bool pick_up = up <= left && up <= dg;
      const bool pick_left = !pick_up && left <= dg;
      const unsigned c = pick_up ? 0u : (pick_left ? 1u : 2u);
      d[i] = to_f32(C[(size_t)i * T2 + j]) + fminf(fminf(up, left), dg);
      const int jb = j & 15;
      const unsigned word = (jb == 0 ? 0u : row_word[i]) | (c << (2 * jb));
      if (jb == 15 || j == n2 - 1)
        ch[(size_t)i * W + (j >> 4)] = word;
      else
        row_word[i] = word;
    }
    __syncthreads();
  }

  if (tid == 0) {
    path_cost[u] = (n1 + n2 > 2) ? diag[cur][n1 - 1] : 0.f;
    if (!dp_only) {
      int i = n1 - 1, j = n2 - 1;
      while (i > 0 && j > 0) {
        al[i] = j;
        const unsigned c =
            (ch[(size_t)i * W + (j >> 4)] >> (2 * (j & 15))) & 3u;
        if (c != 1u) --i;
        if (c != 0u) --j;
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* costs, const int* n1, const int* n2, int* align,
                   float* cost, unsigned* choices, int K, int T1, int T2,
                   int dp_only, cudaStream_t stream) {
  const size_t smem = smem_bytes(T1);
  cudaError_t err = cudaFuncSetAttribute(
      dtw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dtw_kernel<T><<<K, NTHREADS, smem, stream>>>(
      static_cast<const T*>(costs), n1, n2, align, cost, choices, T1, T2,
      dp_only);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one CTA needs, in bytes, for T1 rows.
int dtw_smem_bytes(int T1) { return (int)smem_bytes(T1); }

// costs: (K, T1, T2) contiguous, bf16 when is_bf16 else f32; n1, n2: (K,)
// int32; align: (K, T1) int32 out; cost: (K,) f32 out; choices: scratch of
// K * T1 * ceil(T2/16) uint32. All device pointers. Launches on `stream`
// and returns the cudaError_t of the launch (0 on success).
int dtw_align(const void* costs, const void* n1, const void* n2, void* align,
              void* cost, void* choices, int K, int T1, int T2, int is_bf16,
              int dp_only, void* stream) {
  if (K < 1 || T1 < 1 || T2 < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* n1p = static_cast<const int*>(n1);
  const int* n2p = static_cast<const int*>(n2);
  int* ap = static_cast<int*>(align);
  float* cp = static_cast<float*>(cost);
  unsigned* chp = static_cast<unsigned*>(choices);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(costs, n1p, n2p, ap, cp, chp, K, T1,
                                      T2, dp_only, s);
  return (int)launch<float>(costs, n1p, n2p, ap, cp, chp, K, T1, T2, dp_only,
                            s);
}

const char* dtw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

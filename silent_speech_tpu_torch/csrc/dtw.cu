// Monotonic DTW alignment for Hopper (sm_90a), with a DP-only mode.
//
// Replaces the TPU kernel `pallas_dtw_align_batch`
// (silent_speech_tpu/ops/pallas/dtw_kernel.py:209, pl.pallas_call, body
// `_dtw_kernel` :74) and, with dp_only = 1, its DP-only profiling variant
// (`dponly`, tools/prof_dtw.py:136, body `_dtw_kernel_dponly` :58). For
// each utterance u with valid lengths n1 <= T1 rows and n2 <= T2 columns of
// the cost matrix C (T1, T2):
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
// What bounds it on the card. The function reads each valid cost once and
// writes T1 + 1 outputs: at K=12, T=1024, bf16 costs and n 282-730 that is
// ~4 MB, ~2 us at 3.35 TB/s. But the DP is a chain of max(n1 + n2 - 1)
// dependent anti-diagonals and the backtrace a chain of up to n1 + n2
// steps, so the kernel is latency-bound and its figure of merit is the time
// per diagonal.
//
// Design. One CTA of 1024 threads per utterance walks the anti-diagonals
// k = i + j of the [0, n1) x [0, n2) rectangle, three diagonals in shared
// memory, one barrier a diagonal. Thread t owns the rows t, t + 1024, ...
// (R = 1, 2 or 4 of them, a template parameter: T1 <= 4096) and meets the
// columns of each of its rows in order, one a diagonal. On the H100 a
// diagonal with global loads or stores in flight in any warp took longer,
// whether or not their results were used on it (PERF.md), so every global
// access of the DP sits on a few diagonals that are the same
// for the whole CTA; the loop runs in blocks of 16 diagonals, unrolled:
//  - Costs come from registers. On diagonals k % LW == 0 each thread
//    issues, for each of its rows, the loads of the LW columns it will
//    meet on the next LW diagonals (LW = 16 bytes of costs at R = 1: 8
//    bf16 or 4 f32; 4 at R = 2 and 2 at R = 4, for the registers), only
//    those in [1, n2): a window of loads LW diagonals ahead of use.
//    Inside the unrolled block the cost of diagonal k is window lane
//    k % LW, a fixed register.
//  - The 2-bit choices (0 up, 1 left, 2 diag) of a row enter a register
//    word at the top, so after column 16w + 15 it holds columns 16w ..
//    16w + 15; the finished word waits in a second register and is stored
//    to the choice table in global memory (T1 x ceil(T2/16) words, 256 KB
//    per utterance at T=1024, held by L2) on the next diagonal k % 16 ==
//    0.
//  - Warps whose rows all lie at or past n1 return after zeroing the
//    outputs; the rest meet at a named barrier over 32 * ceil(min(n1,
//    1024) / 32) threads (`bar.sync 1, n`).
//  - One thread walks the backtrace. It keeps the word in use in a
//    register and loads the next RING rows' candidate words ahead into a
//    ring of registers whose slots are fixed by unrolling, so a step
//    waits on a load only where a left run crosses more than one word.
//    The walk's time is then its chain of dependent instructions: on the
//    H100 a walk with one load a step and fewer instructions was faster
//    (PERF.md).
//
// Not done yet: a warp-synchronous wavefront (`__shfl_up_sync` within a
// warp, flags between warps) in place of the block barrier; costs
// pre-skewed by the producer of the cost matrix (train/losses.py) so that a
// diagonal's costs are contiguous and a window is one vector load;
// several utterances a CTA when K is small (K = 12-16 CTAs use 12-16 of
// the 132 SMs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NTHREADS = 1024;
constexpr int MAX_ROWS_PER_THREAD = 4;
constexpr int MAX_ROWS = NTHREADS * MAX_ROWS_PER_THREAD;
constexpr int RING = 4;  // rows of choice words the backtrace loads ahead

inline size_t smem_bytes(int T1) { return (size_t)T1 * 3 * sizeof(float); }

__device__ __forceinline__ void live_barrier(int nthreads) {
  asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}

// Issue the loads of row i's costs for the LW diagonals from k: columns
// k - i .. k - i + LW - 1, those in [1, n2) only (column 0 takes no cost).
template <typename T, int LW>
__device__ __forceinline__ void issue_window(const T* C, int T2, int i, int k,
                                             int n1, int n2,
                                             unsigned (&out)[LW]) {
  if (i < 1 || i >= n1) return;
  const T* row = C + (size_t)i * T2;
#pragma unroll
  for (int m = 0; m < LW; ++m) {
    const int col = k - i + m;
    if (col >= 1 && col < n2) {
      if constexpr (sizeof(T) == 4)
        out[m] = __ldg(reinterpret_cast<const unsigned*>(row) + col);
      else
        out[m] = __ldg(reinterpret_cast<const unsigned short*>(row) + col);
    }
  }
}

// A cost's bits as f32 (a bf16 widens exactly: its bits << 16).
template <typename T>
__device__ __forceinline__ float cost_f32(unsigned bits) {
  if constexpr (sizeof(T) == 4) return __uint_as_float(bits);
  return __uint_as_float(bits << 16);
}

// Load row r's choice words w and w - 1 into a ring slot, tagged w. Rows
// < 1 hold no choices: their slot loads row 1 and gets a tag no word index
// matches. The loads are unconditional, and nothing reads their registers
// until the walk reaches the row.
__device__ __forceinline__ void fill_slot(const unsigned* ch, int W, int r,
                                          int w, unsigned& a, unsigned& b,
                                          int& tag) {
  const unsigned* p = ch + (size_t)max(r, 1) * W + w;
  a = p[0];
  b = p[-1];  // at w = 0 the last word of the row above: never used
  tag = r >= 1 ? w : -2;
}

// The walk from (n1-1, n2-1): the first minimum of up, left, diag, as the
// choice codes say. The word in use stays in a register and is replaced
// only when the row or the word index j >> 4 changes. Slot s of a ring of
// RING holds rows n1-1-s, n1-1-s-RING, ...: when the walk leaves a row, its
// slot takes the words j >> 4 and (j >> 4) - 1 of the row RING below, so
// their loads have RING rows of the walk to arrive. The walk never moves
// right, so those are the words it needs unless a left run crosses more
// than one word; then it loads on demand. The slot loop is unrolled, so
// each slot is a fixed register and no step waits on another slot's load.
__device__ void backtrace(const unsigned* ch, int* al, int W, int n1,
                          int n2) {
  int i = n1 - 1, j = n2 - 1;
  if (i <= 0 || j <= 0) return;
  unsigned a[RING], b[RING];
  int tag[RING];
#pragma unroll
  for (int s = 0; s < RING; ++s)
    fill_slot(ch, W, i - s, j >> 4, a[s], b[s], tag[s]);
  while (true) {
#pragma unroll
    for (int s = 0; s < RING; ++s) {  // row i's words are in slot s
      int w = j >> 4;
      unsigned word = tag[s] == w       ? a[s]
                      : tag[s] - 1 == w ? b[s]
                                        : ch[(size_t)i * W + w];
      unsigned c;
      while (true) {
        al[i] = j;
        c = (word >> (2 * (j & 15))) & 3u;
        if (c != 1u) break;
        if (--j == 0) return;
        if ((j & 15) == 15) {  // left into word w - 1
          --w;
          word = tag[s] - 1 == w ? b[s] : ch[(size_t)i * W + w];
        }
      }
      if (c == 2u) --j;
      fill_slot(ch, W, i - RING, j >> 4, a[s], b[s], tag[s]);
      if (--i == 0 || j == 0) return;
    }
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(NTHREADS)
dtw_kernel(const T* __restrict__ costs, const int* __restrict__ n1s,
           const int* __restrict__ n2s, int* __restrict__ align,
           float* __restrict__ path_cost, unsigned* __restrict__ choices,
           int T1, int T2, int dp_only) {
  // diagonals a cost window covers: 16 bytes of a row at R = 1; fewer at
  // R = 2 and 4, whose rows' windows would not fit the 64 registers
  constexpr int LW = R == 1 ? 16 / (int)sizeof(T) : 8 / R;
  extern __shared__ float smem[];  // three diagonals of T1 floats

  const int u = blockIdx.x;
  const int tid = threadIdx.x;
  // lengths outside [1, T] are clamped, as the JAX gathers clamp them
  const int n1 = min(max(n1s[u], 1), T1);
  const int n2 = min(max(n2s[u], 1), T2);
  const T* C = costs + (size_t)u * T1 * T2;
  const int W = (T2 + 15) / 16;
  unsigned* ch = choices + (size_t)u * T1 * W;
  int* al = align + (size_t)u * T1;

  for (int i = tid; i < T1; i += NTHREADS) al[i] = 0;
  if (tid == 0) smem[0] = 0.f;  // diagonal 0 holds only (0, 0)
  __syncthreads();
  const int live = 32 * ((min(n1, NTHREADS) + 31) / 32);
  if (tid >= live) return;  // every row of this warp is >= n1

  unsigned win[R][LW], nxt[R][LW];  // cost bits of this window, the next
  unsigned word[R], done[R];        // choices: the 16 in flight, the last
  int done_w[R];                    // finished word's index, -1 if stored
#pragma unroll
  for (int r = 0; r < R; ++r) {
    word[r] = done[r] = 0u;
    done_w[r] = -1;
#pragma unroll
    for (int m = 0; m < LW; ++m) win[r][m] = nxt[r][m] = 0u;
    issue_window<T, LW>(C, T2, tid + r * NTHREADS, 0, n1, n2, nxt[r]);
  }

  int o_prev2 = 2 * T1, o_prev = 0, o_cur = T1;  // diagonals k-2, k-1, k
  const int last = n1 + n2 - 2;
  for (int k0 = 0; k0 <= last; k0 += 16) {
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int k = k0 + q;
      if (q == 0) {  // store the words finished in the last 16 diagonals
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (done_w[r] >= 0) {
            ch[(size_t)(tid + r * NTHREADS) * W + done_w[r]] = done[r];
            done_w[r] = -1;
          }
      }
      if (q % LW == 0) {  // the next window's costs, LW diagonals ahead
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int m = 0; m < LW; ++m) win[r][m] = nxt[r][m];
          issue_window<T, LW>(C, T2, tid + r * NTHREADS, k + LW, n1, n2,
                              nxt[r]);
        }
      }
      if (k < 1 || k > last) continue;  // uniform across the CTA
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = tid + r * NTHREADS;
        const int j = k - i;
        if (i >= n1 || (unsigned)j >= (unsigned)n2) continue;
        float v = INFINITY;
        if (i > 0 && j > 0) {
          const float up = smem[o_prev + i - 1];   // dtw[i-1, j]
          const float left = smem[o_prev + i];     // dtw[i, j-1]
          const float dg = smem[o_prev2 + i - 1];  // dtw[i-1, j-1]
          const bool pick_up = up <= left && up <= dg;
          const bool pick_left = !pick_up && left <= dg;
          const unsigned c = pick_up ? 0u : (pick_left ? 1u : 2u);
          v = cost_f32<T>(win[r][q % LW]) + fminf(fminf(up, left), dg);
          // the newest choice enters at the top: after column 16w + 15
          // the word holds columns 16w .. 16w + 15 at bits 0 .. 31
          word[r] = (word[r] >> 2) | (c << 30);
          const int jb = j & 15;
          if (jb == 15 || j == n2 - 1) {
            // a row's last word may finish right after a full one
            if (done_w[r] >= 0) ch[(size_t)i * W + done_w[r]] = done[r];
            done[r] = word[r] >> (2 * (15 - jb));
            done_w[r] = j >> 4;
          }
        }
        smem[o_cur + i] = v;
      }
      live_barrier(live);
      const int t = o_prev2;
      o_prev2 = o_prev;
      o_prev = o_cur;
      o_cur = t;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (done_w[r] >= 0)
      ch[(size_t)(tid + r * NTHREADS) * W + done_w[r]] = done[r];
  live_barrier(live);

  if (tid == 0) {
    path_cost[u] = (n1 + n2 > 2) ? smem[o_prev + n1 - 1] : 0.f;
    if (!dp_only) backtrace(ch, al, W, n1, n2);
  }
}

template <typename T, int R>
cudaError_t launch_rows(const void* costs, const int* n1, const int* n2,
                        int* align, float* cost, unsigned* choices, int K,
                        int T1, int T2, int dp_only, cudaStream_t stream) {
  const size_t smem = smem_bytes(T1);
  cudaError_t err = cudaFuncSetAttribute(
      dtw_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dtw_kernel<T, R><<<K, NTHREADS, smem, stream>>>(
      static_cast<const T*>(costs), n1, n2, align, cost, choices, T1, T2,
      dp_only);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* costs, const int* n1, const int* n2, int* align,
                   float* cost, unsigned* choices, int K, int T1, int T2,
                   int dp_only, cudaStream_t stream) {
  if (T1 <= NTHREADS)
    return launch_rows<T, 1>(costs, n1, n2, align, cost, choices, K, T1, T2,
                             dp_only, stream);
  if (T1 <= 2 * NTHREADS)
    return launch_rows<T, 2>(costs, n1, n2, align, cost, choices, K, T1, T2,
                             dp_only, stream);
  return launch_rows<T, 4>(costs, n1, n2, align, cost, choices, K, T1, T2,
                           dp_only, stream);
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
  if (K < 1 || T1 < 1 || T2 < 1 || T1 > MAX_ROWS)
    return (int)cudaErrorInvalidValue;
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

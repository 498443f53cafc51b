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
// What bounds it on the card: every filter is a chain of dependent steps,
// two passes a filter, 16 passes for the cleaning chain; a step's chain
// is z0 -> y (add) -> a1*y (mul) -> z0' (sub). The passes meet only at
// their ends (a pass runs from the other's last output back to its
// first), so each pass streams its column through memory once.
//
// Design: a CTA serves 32 columns, one lane a column, with 2 * MOVERS + 2
// warps.
//   warp 0, the chain: each lane runs its column's recurrence, its delays
//     and coefficients in registers, reading its input from and writing
//     its output to a ring of RING tiles in shared memory (a tile is TILE
//     steps x 32 lanes; the tile's step u of lane l at u * 32 + l, so a
//     step is one conflict-free load and store at a constant offset). The
//     lanes run their steps in lockstep from step 0: which row of a column
//     a step reads is the producer's business, not the chain's. The inner
//     loop over a tile has no branch and no address arithmetic.
//   the producer (MOVERS warps, each a share of a tile's steps): fills
//     tile g ahead of the chain with cp.async, each column from its own
//     rows in its own direction: the first forward pass from x itself,
//     later ones and every reverse pass from the global scratch (B, T_pad
//     + 2P, C), where row P + t holds sample t. A lane moves 4 adjacent
//     channels of one utterance (16 bytes of a row) where C % 4 == 0 and
//     the buffers are 16-byte aligned, else its own column's float. The
//     odd extensions, computed once a filter from the column's ends, come
//     from a small table in shared memory. Tile g's copies are waited for
//     (cp.async.wait_group) when tile g + LAG is issued, and then the tile
//     is handed to the chain by an mbarrier.
//   the drain (MOVERS warps): copies each tile the chain finished to its
//     rows (the forward pass's whole y to the scratch, the reverse pass's
//     L outputs to the scratch or, for the last filter, to out) and hands
//     the slot back to the producer. A pass reads what the pass before it
//     wrote, so the drain and the producer meet at a named barrier between
//     passes.
//   the last warp writes the zeros of out past each column's length.
// Lanes past their column's end (the warp runs its longest column's
// steps) compute on whatever the ring holds and their results are never
// copied out; lanes past the last column do the same.
//
// Why so (PERF.md §6): with one producer and one drain warp moving 4
// bytes a lane, the movers, not the chain, set the pace: one warp issues
// its copies and stores too slowly. 16-byte moves and two warps of each,
// every one a share of a tile, leave the chain's warp setting the pace.
// A layout of each utterance's rows in step order (512 contiguous bytes
// an instruction) was slower, its movers and its chain alike.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_FILTERS = 16;
constexpr int MAX_DELAYS = 3;            // filters of up to 4 taps
constexpr int MAX_PAD = 3 * (MAX_DELAYS + 1);
constexpr int LANES = 32;
constexpr int TILE = 64;                 // steps a tile
constexpr int RING = 8;                  // tiles in the ring
constexpr int LAG = 4;                   // tiles in flight before a hand-off
constexpr int MOVERS = 2;                // producer warps, and drain warps
constexpr int THREADS = (2 * MOVERS + 2) * LANES;
constexpr unsigned FULL = 0xffffffffu;
static_assert(LAG < RING, "the producer must hand a tile over before it "
                          "needs that tile's slot again");

struct Chain {
  int n;
  int nd[MAX_FILTERS];
  float b[MAX_FILTERS][MAX_DELAYS + 1];
  float a[MAX_FILTERS][MAX_DELAYS + 1];
  float zi[MAX_FILTERS][MAX_DELAYS];
};

struct Barriers {
  unsigned long long full[RING];   // producer -> chain: the inputs landed
  unsigned long long done[RING];   // chain -> drain: the outputs written
  unsigned long long empty[RING];  // drain -> producer: the slot is free
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar,
                                         unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// the producer and the drain, between passes
__device__ __forceinline__ void pass_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(2 * MOVERS * LANES) : "memory");
}

// One DF2T step: y = b0*e + z0, then the delays (explicit roundings).
template <int ND>
__device__ __forceinline__ float df2t(float e, float (&z)[ND],
                                      const float (&b)[ND + 1],
                                      const float (&a)[ND + 1]) {
  const float y = __fadd_rn(__fmul_rn(b[0], e), z[0]);
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    const float shifted = (k + 1 < ND) ? z[k + 1] : 0.0f;
    z[k] = __fsub_rn(__fadd_rn(shifted, __fmul_rn(b[k + 1], e)),
                     __fmul_rn(a[k + 1], y));
  }
  return y;
}

// Steps of a pass: the forward pass runs all L + 2p; the reverse pass
// stops after the step of out[0] (step L + p - 1), since the steps after
// it compute the front extension's results, which the crop drops.
__device__ __forceinline__ int pass_steps(int L, int p, int reverse) {
  return reverse ? L + p : L + 2 * p;
}

__device__ __forceinline__ int tiles_of(int steps) {
  return (steps + TILE - 1) / TILE;
}

// warp 0 ------------------------------------------------------------------
template <int ND>
__device__ void chain_filter(const Chain& chain, int f, float* ring,
                             Barriers& bars, int lane, int l_max, int& g) {
  float b[ND + 1], a[ND + 1], zi[ND];
#pragma unroll
  for (int k = 0; k <= ND; ++k) {
    b[k] = chain.b[f][k];
    a[k] = chain.a[f][k];
  }
#pragma unroll
  for (int k = 0; k < ND; ++k) zi[k] = chain.zi[f][k];
  const int p = 3 * (ND + 1);
  for (int reverse = 0; reverse < 2; ++reverse) {
    const int tiles = tiles_of(pass_steps(l_max, p, reverse));
    float z[ND];
    for (int k = 0; k < tiles; ++k, ++g) {
      const int slot = g % RING;
      bar_wait(&bars.full[slot], (g / RING) & 1);
      float* t = ring + slot * (TILE * LANES) + lane;
      if (k == 0) {
        const float e0 = t[0];
#pragma unroll
        for (int j = 0; j < ND; ++j) z[j] = __fmul_rn(zi[j], e0);
      }
#pragma unroll
      for (int u = 0; u < TILE; ++u)
        t[u * LANES] = df2t<ND>(t[u * LANES], z, b, a);
      bar_arrive(&bars.done[slot]);
    }
  }
}

// the producer and the drain ------------------------------------------------
// They move W floats a lane an instruction. W = 4 when C % 4 == 0 and the
// buffers are 16-byte aligned: a lane then holds 4 adjacent channels of one
// utterance, 16 bytes of a row, and one warp instruction moves 4 steps of
// the CTA's 32 columns. Else W = 1: a lane, its own column, a step at a
// time. Lane l of mover mv has columns W*m .. W*m + W - 1 of the CTA (m =
// l % (32 / W)) at PER steps s, s + W, s + 2W, ... of a tile (s = l / (32 /
// W) + mv * TILE / MOVERS).
template <int W>
struct Unit {
  static constexpr int PER = TILE / (W * MOVERS);  // a mover's steps a tile
  int m, s;
  bool active;
  int u, c, L;
  __device__ Unit(const int* lengths, long cols, int C, int lane, int mv) {
    m = lane % (LANES / W);
    s = lane / (LANES / W) + mv * (TILE / MOVERS);
    const long col = (long)blockIdx.x * LANES + W * m;
    active = col < cols;
    u = active ? (int)(col / C) : 0;
    c = active ? (int)(col % C) : 0;
    L = active ? lengths[u] : 0;
  }
};

template <int W>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  if constexpr (W == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     smem_addr(dst)), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                     smem_addr(dst)), "l"(src) : "memory");
}

template <int W>
__device__ __forceinline__ void move(float* dst, const float* src) {
  if constexpr (W == 4)
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  else
    *dst = *src;
}

// The odd extensions of a forward pass, lane by column: ext row k < p is
// the front's step k, row p + k the back's step L + p + k.
__device__ __forceinline__ void extensions(bool first, const float* x,
                                           const float* scratch, float* ext,
                                           int lane, bool active, int u,
                                           int c, int L, int p, int T_pad,
                                           int C, int P) {
  __syncwarp();
  if (active) {
    const float* in = first
        ? x + ((long)u * T_pad) * C + c
        : scratch + ((long)u * (T_pad + 2 * P) + P) * C + c;
    const float x0 = in[0], xl = in[(long)(L - 1) * C];
    for (int k = 0; k < p; ++k) {
      ext[k * LANES + lane] =
          __fsub_rn(__fmul_rn(2.0f, x0), in[(long)(p - k) * C]);
      ext[(p + k) * LANES + lane] =
          __fsub_rn(__fmul_rn(2.0f, xl), in[(long)(L - 2 - k) * C]);
    }
  }
  __syncwarp();
}

// Hand tiles [from, to) of the current pass to the chain.
__device__ __forceinline__ void hand_over(Barriers& bars, int from, int to) {
  for (int h = from; h < to; ++h) bar_arrive(&bars.full[h % RING]);
}

template <int W>
__device__ void produce(const Chain& chain, const float* x, float* scratch,
                        const int* lengths, float* ring, float* ext,
                        Barriers& bars, int lane, int mv, bool active, int u,
                        int c, int L, int l_max, long cols, int T_pad, int C,
                        int P) {
  const long rows = (long)T_pad + 2 * P;
  const Unit<W> n(lengths, cols, C, lane, mv);
  // the unit's columns in x (row t at x_col[t * C]) and in the scratch
  // (row r at s_col[r * C]); unread for a unit past the last column
  const float* x_col = x + ((long)n.u * T_pad) * C + n.c;
  const float* s_col = scratch + ((long)n.u * rows) * C + n.c;
  int g = 0;
  for (int f = 0; f < chain.n; ++f) {
    const int p = 3 * (chain.nd[f] + 1);
    for (int reverse = 0; reverse < 2; ++reverse) {
      if (f > 0 || reverse) pass_barrier();  // the last pass is written
      const int tiles = tiles_of(pass_steps(l_max, p, reverse));
      // step q of the unit reads src[q * dir] where it reads memory:
      // forward steps p .. p + L - 1 read x[0..L), the steps before and
      // after them the extensions' table; reverse steps q < L + p read
      // y[L + 2p - 1 - q], which the forward pass left in scratch rows
      // P - p .. P + L + p - 1
      const float* src;
      long dir;
      int lo, hi;  // the steps that read memory
      if (!reverse) {
        extensions(f == 0, x, scratch, ext, lane, active, u, c, L, p,
                   T_pad, C, P);
        src = (f == 0 ? x_col : s_col + (long)P * C) - (long)p * C;
        dir = C;
        lo = p;
        hi = n.active ? p + n.L : p;
      } else {
        src = s_col + (long)(P + n.L + p - 1) * C;
        dir = -(long)C;
        lo = 0;
        hi = n.active ? n.L + p : 0;
      }
      const int ext_end = reverse ? 0 : (n.active ? n.L + 2 * p : 2 * p);
      const int first = g;
      for (int k = 0; k < tiles; ++k, ++g) {
        const int slot = g % RING;
        if (g >= RING) bar_wait(&bars.empty[slot], (g / RING - 1) & 1);
        const int q0 = k * TILE + n.s;  // the unit's steps q0 + W * i
        float* r = ring + (slot * TILE + n.s) * LANES + W * n.m;
        const float* gp = src + q0 * dir;
        if (q0 >= lo && q0 + W * (n.PER - 1) < hi) {  // all from memory
#pragma unroll
          for (int i = 0; i < n.PER; ++i, r += W * LANES, gp += W * dir)
            copy_async<W>(r, gp);
        } else {
          for (int i = 0; i < n.PER; ++i, r += W * LANES, gp += W * dir) {
            const int q = q0 + W * i;
            if (q >= lo && q < hi)
              copy_async<W>(r, gp);
            else if (q < lo)
              move<W>(r, ext + q * LANES + W * n.m);
            else if (q < ext_end)
              move<W>(r, ext + (q - n.L) * LANES + W * n.m);
          }
        }
        copies_commit();
        if (k >= LAG) {
          copies_wait<LAG>();
          __syncwarp();
          hand_over(bars, g - LAG, g - LAG + 1);
        }
      }
      copies_wait<0>();
      __syncwarp();
      hand_over(bars, first + (tiles > LAG ? tiles - LAG : 0), g);
    }
  }
}

template <int W>
__device__ void drain(const Chain& chain, float* scratch, float* out,
                      const int* lengths, float* ring, Barriers& bars,
                      int lane, int mv, int l_max, long cols, int T_pad,
                      int C, int P) {
  const long rows = (long)T_pad + 2 * P;
  const Unit<W> n(lengths, cols, C, lane, mv);
  float* s_col = scratch + ((long)n.u * rows) * C + n.c;
  float* o_col = out + ((long)n.u * T_pad) * C + n.c;
  int g = 0;
  for (int f = 0; f < chain.n; ++f) {
    const int p = 3 * (chain.nd[f] + 1);
    for (int reverse = 0; reverse < 2; ++reverse) {
      const int tiles = tiles_of(pass_steps(l_max, p, reverse));
      // step q's result goes to dst[q * dir] for q in [lo, hi): the
      // forward pass's y[q] to scratch row P - p + q; the reverse pass's
      // out[L + p - 1 - q] to scratch row P + L + p - 1 - q, or to out's
      // row L + p - 1 - q after the last filter
      float* dst;
      long dir;
      int lo, hi;
      if (!reverse) {
        dst = s_col + (long)(P - p) * C;
        dir = C;
        lo = 0;
        hi = n.active ? n.L + 2 * p : 0;
      } else {
        dst = (f + 1 == chain.n ? o_col : s_col + (long)P * C) +
              (long)(n.L + p - 1) * C;
        dir = -(long)C;
        lo = p;
        hi = n.active ? n.L + p : p;
      }
      for (int k = 0; k < tiles; ++k, ++g) {
        const int slot = g % RING;
        bar_wait(&bars.done[slot], (g / RING) & 1);
        const int q0 = k * TILE + n.s;
        const float* r = ring + (slot * TILE + n.s) * LANES + W * n.m;
        float* dp = dst + q0 * dir;
        if (q0 >= lo && q0 + W * (n.PER - 1) < hi) {
#pragma unroll
          for (int i = 0; i < n.PER; ++i, r += W * LANES, dp += W * dir)
            move<W>(dp, r);
        } else {
          for (int i = 0; i < n.PER; ++i, r += W * LANES, dp += W * dir) {
            const int q = q0 + W * i;
            if (q >= lo && q < hi) move<W>(dp, r);
          }
        }
        bar_arrive(&bars.empty[slot]);
      }
      if (f + 1 < chain.n || !reverse) {
        __threadfence_block();
        pass_barrier();  // the next pass's producer reads these rows
      }
    }
  }
}

template <int W>
__global__ void __launch_bounds__(THREADS)
filtfilt_chain_kernel(const float* __restrict__ x,
                      const int* __restrict__ lengths, float* out,
                      float* scratch, const __grid_constant__ Chain chain,
                      int B, int T_pad, int C, int P) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                  // RING x TILE x 32
  float* ext = ring + RING * TILE * LANES;  // MOVERS x 2 * MAX_PAD x 32
  Barriers& bars =
      *reinterpret_cast<Barriers*>(ext + MOVERS * 2 * MAX_PAD * LANES);
  const int warp = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  // lane l's column, for the chain, the extensions and the zeros
  const long cols = (long)B * C;
  const long col = (long)blockIdx.x * LANES + lane;
  const bool active = col < cols;
  const int u = active ? (int)(col / C) : 0;
  const int c = active ? (int)(col % C) : 0;
  const int L = active ? lengths[u] : 0;
  const int l_max = __reduce_max_sync(FULL, L);
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      bar_init(&bars.full[s], MOVERS * LANES);
      bar_init(&bars.done[s], LANES);
      bar_init(&bars.empty[s], MOVERS * LANES);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    int g = 0;
    for (int f = 0; f < chain.n; ++f) {
      if (chain.nd[f] == 2)
        chain_filter<2>(chain, f, ring, bars, lane, l_max, g);
      else if (chain.nd[f] == 3)
        chain_filter<3>(chain, f, ring, bars, lane, l_max, g);
      else
        chain_filter<1>(chain, f, ring, bars, lane, l_max, g);
    }
  } else if (warp <= MOVERS) {
    const int mv = warp - 1;
    produce<W>(chain, x, scratch, lengths, ring,
               ext + mv * 2 * MAX_PAD * LANES, bars, lane, mv, active, u, c,
               L, l_max, cols, T_pad, C, P);
  } else if (warp <= 2 * MOVERS) {
    drain<W>(chain, scratch, out, lengths, ring, bars, lane,
             warp - 1 - MOVERS, l_max, cols, T_pad, C, P);
  } else if (active) {
    float* o = out + ((long)u * T_pad + L) * C + c;
    for (int t = L; t < T_pad; ++t, o += C) *o = 0.0f;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

constexpr size_t SMEM_BYTES =
    sizeof(float) * (RING * TILE * LANES + MOVERS * 2 * MAX_PAD * LANES) +
    sizeof(Barriers);

}  // namespace

extern "C" {

// Rows of scratch, per utterance, that the kernel needs for a chain whose
// largest padlen is P: the scratch is (B, T_pad + 2P, C) float32.
int filtfilt_scratch_rows(int T_pad, int P) { return T_pad + 2 * P; }

// x, out: (B, T_pad, C) f32; lengths: (B,) int32, each in (P_f, T_pad] for
// every filter's padlen P_f (the wrapper checks); scratch: (B, T_pad + 2P,
// C) f32. nd: n_filters delays counts (1..3), host memory; coef:
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
  // 16-byte moves where a row's channels come in fours and every buffer
  // is 16-byte aligned; else a column at a time
  const bool wide = C % 4 == 0 && aligned16(x) && aligned16(out) &&
                    aligned16(scratch);
  auto kernel = wide ? filtfilt_chain_kernel<4> : filtfilt_chain_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const long cols = (long)B * C;
  const int blocks = (int)((cols + LANES - 1) / LANES);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<blocks, THREADS, SMEM_BYTES, s>>>(
      static_cast<const float*>(x), static_cast<const int*>(lengths),
      static_cast<float*>(out), static_cast<float*>(scratch), chain, B, T_pad,
      C, P);
  return (int)cudaGetLastError();
}

const char* filtfilt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

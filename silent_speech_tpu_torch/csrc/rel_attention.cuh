// Shared pieces of the relative-position attention kernels for Hopper, which
// every attention kernel uses: the dropout counter hash and its cells, and
// the warp reductions.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace relattn {

// The counter hash of the JAX kernel's interpret mode (`_hash_bits`,
// silent_speech_tpu/ops/pallas/rel_attention.py): row = query index,
// col = key index, seed = (step seed + b*H + h) mod 2^32. A launch on a
// shard of the rows or heads takes the cell of the whole batch, (step seed
// + (b_offset + b)*H_total + h_offset + h) mod 2^32, so that it draws the
// slice of the unsharded mask; (0, 0, H) is the unsharded launch.
// True when the shard's rows and heads do not fit in the batch's cells.
inline bool bad_cells(int B, int H, int b_offset, int h_offset,
                      int H_total) {
  return b_offset < 0 || h_offset < 0 || H_total < H ||
         h_offset > H_total - H || (long long)(b_offset + B) * H_total >
         0x7fffffffLL;
}

__device__ __forceinline__ unsigned hash_bits(unsigned r, unsigned c,
                                              unsigned seed) {
  unsigned x = (r * 0x9E3779B1u) ^ (c * 0x85EBCA77u) ^ seed;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace relattn

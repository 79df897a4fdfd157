// Block-wide integer sum shared by the counting collides (collide_prob.cu,
// collide_bits.cu): every thread brings its own count; the block adds them
// up by warp shuffles and shared memory and does ONE 64-bit atomicAdd. An
// integer sum is exact in any order, so the total is deterministic.
#pragma once

#include <cuda_runtime.h>

// All THREADS threads of the block must call this, once, outside any
// divergent branch. `count` is one zero-initialised unsigned 64-bit word.
template <int THREADS>
__device__ __forceinline__ void block_add(unsigned int v, unsigned long long* count) {
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps, one block");
  __shared__ unsigned int warp_sums[THREADS / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    unsigned long long s = lane < THREADS / 32 ? warp_sums[lane] : 0u;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0 && s) atomicAdd(count, s);
  }
}

// Swept-volume types collide for Hopper (sm_90a): kernel K4.
//
// Replaces gpu_voxels_tpu/ops/collide_pallas.py:
//   K4 collide_types_bit_bit (_types_kernel)  -> gv_collide_types_bit_bit
// Spec: gpu_voxels_tpu_torch/ops/collide.py collide_with_types_bit_bit at
// sv_offset 0, margin <= 24 (bitops.bit_margin_collision_check_packed),
// which equals gpu_voxels_tpu/ops/collide.py.
//
// What it computes: two bit maps a, b are uint32[8, n], plane-major (plane p
// holds bits [32p, 32p + 32) of every voxel). For each voxel i:
//   v2  = b[:, i] with bits 0..3 cleared (the non-SV nibble never matches),
//   win = OR over s in [-m, m] of v2 shifted by s bits across the 256-bit
//         vector (zero fill), rec = a[:, i] & win, hit = rec != 0.
// Outputs: the hit count (one int64), meanings[p] = OR over voxels of rec[p]
// (the colliding meanings; rec is zero where there is no hit), and with MARK
// a NEW map out = a with bit 2 of plane 0 (eBVM_COLLISION) set at hits.
// Maps are functional: out never aliases a, and all 8 planes are written in
// this pass from the words already in registers (no separate clone).
//
// What bounds it on an H100: bytes. With MARK it reads 64 B and writes 32 B
// per voxel (1.61 GB at 256^3, about 0.48 ms at the data sheet's 3.35 TB/s);
// without, it reads 64 B (1.07 GB, about 0.32 ms). The window costs
// 2 * ceil(log2(m + 1)) rounds of 8 funnel shifts and ORs per voxel, small
// beside that. Design for it: one thread per voxel in a grid-stride loop, so
// each of the 16 word loads is coalesced across a warp (consecutive voxels,
// consecutive words of one plane); the count and the meanings stay in
// registers for the whole loop, are reduced per warp (shuffles,
// __reduce_or_sync) and per block in shared memory, and each block issues
// one 64-bit atomicAdd and at most 8 atomicOr. Integer sums and ORs are
// exact in any order, so every output is deterministic.
//
// The window is built by doubling, each direction on its own: w |= shift(w,
// step) with steps 1, 2, 4, ... covers offsets [0, m] in ceil(log2(m + 1))
// rounds. Only shifts of ONE sign are composed: an intermediate offset then
// always lies between the endpoints, so nothing clipped at the vector's ends
// is lost. Shifting a down-window back up would zero-fill bits below m that
// the spec keeps (the bug recorded at collide_pallas.py:220-226).
//
// The launcher returns cudaGetLastError(); the caller raises on non-zero.
// Launches go on the caller's stream and never synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPlanes = 8;
constexpr int kMaxBlocks = 132 * 8;  // 8 blocks' worth per SM; the rest loop
constexpr uint32_t kSvMask = 0xFFFFFFF0u;
constexpr uint32_t kCollisionBit = 1u << 2;

// out bit b = w bit (b + s), 0 < s < 32, zero fill at the top of the vector
__device__ __forceinline__ void or_shifted_down(uint32_t (&w)[kPlanes], int s) {
  uint32_t t[kPlanes];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) t[p] = __funnelshift_r(w[p], p + 1 < kPlanes ? w[p + 1] : 0u, s);
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) w[p] |= t[p];
}

// out bit b = w bit (b - s), 0 < s < 32, zero fill at the bottom
__device__ __forceinline__ void or_shifted_up(uint32_t (&w)[kPlanes], int s) {
  uint32_t t[kPlanes];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) t[p] = __funnelshift_l(p > 0 ? w[p - 1] : 0u, w[p], s);
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) w[p] |= t[p];
}

template <bool MARK>
__global__ void __launch_bounds__(kThreads)
types_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
             int64_t n, int margin, unsigned long long* __restrict__ count,
             uint32_t* __restrict__ meanings) {
  uint32_t macc[kPlanes];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) macc[p] = 0u;
  unsigned int c = 0;

  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    uint32_t va[kPlanes], down[kPlanes], up[kPlanes];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      va[p] = a[p * n + i];
      down[p] = b[p * n + i];
    }
    down[0] &= kSvMask;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) up[p] = down[p];
    for (int covered = 1; covered < margin + 1;) {
      const int step = min(covered, margin + 1 - covered);
      or_shifted_down(down, step);
      or_shifted_up(up, step);
      covered += step;
    }
    uint32_t any = 0u;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      const uint32_t rec = va[p] & (down[p] | up[p]);
      macc[p] |= rec;
      any |= rec;
    }
    const bool hit = any != 0u;
    c += hit;
    if (MARK) {
      out[i] = hit ? (va[0] | kCollisionBit) : va[0];
#pragma unroll
      for (int p = 1; p < kPlanes; ++p) out[p * n + i] = va[p];
    }
  }

  __shared__ unsigned int warp_count[kWarps];
  __shared__ uint32_t warp_meanings[kWarps][kPlanes];
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) macc[p] = __reduce_or_sync(0xffffffffu, macc[p]);
  if (lane == 0) {
    warp_count[warp] = c;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) warp_meanings[warp][p] = macc[p];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_count[w];
    if (s) atomicAdd(count, s);
  } else if (threadIdx.x >= 32 && threadIdx.x < 32 + kPlanes) {
    const int p = threadIdx.x - 32;
    uint32_t m = 0u;
    for (int w = 0; w < kWarps; ++w) m |= warp_meanings[w][p];
    if (m) atomicOr(meanings + p, m);
  }
}

int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

}  // namespace

// K4: count (one int64), meanings (uint32[8]) and, when out is not null, the
// marked map out (uint32[8, n], never aliasing a). 0 <= margin <= 24.
extern "C" int gv_collide_types_bit_bit(const void* a, const void* b, void* out, int64_t n, int margin,
                                        void* count, void* meanings, void* stream) {
  if (margin < 0 || margin > 24) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(meanings, 0, kPlanes * sizeof(uint32_t), s);
  if (err != cudaSuccess) return err;
  if (n > 0) {
    const uint32_t* pa = static_cast<const uint32_t*>(a);
    const uint32_t* pb = static_cast<const uint32_t*>(b);
    unsigned long long* pc = static_cast<unsigned long long*>(count);
    uint32_t* pm = static_cast<uint32_t*>(meanings);
    if (out != nullptr)
      types_kernel<true><<<blocks_for(n), kThreads, 0, s>>>(pa, pb, static_cast<uint32_t*>(out), n, margin, pc, pm);
    else
      types_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(pa, pb, nullptr, n, margin, pc, pm);
  }
  return cudaGetLastError();
}

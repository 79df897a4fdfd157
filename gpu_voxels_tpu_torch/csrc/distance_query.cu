// A distance field's clearance query for Hopper (sm_90a): the least metric
// distance from a batch of points to their nearest obstacles, in one launch
// (gv_min_distance_to).
//
// Replaces no TPU kernel: the JAX package's query
// (gpu_voxels_tpu/maps/distance_map.py min_distance_to) is jnp that XLA
// fuses. In PyTorch it is ~40 launches (voxelize's scale, floor, clamps,
// bounds tests and linear index; the gather, the unpack, the squared
// distance, the uninitialised test, the select, the min, the square root
// and the scale), each a few microseconds of host time around a few
// microseconds of work on ~4,000 points. Spec:
// gpu_voxels_tpu_torch/ops/edt.py min_distance_to (in ops/edt_cuda.py,
// min_distance_to_plain).
//
// gv_min_distance_to: for each point p (x, y, z float32) of a [dz, dy, dx]
// packed grid (x fastest) at a side whose float32 reciprocal is `recip`,
//   c_i = floor(p_i * recip), clamped to +-2^30 (NaN -> 0);
//   d2(p) = |c - site|^2 of the site packed at c (x | y << 10 | z << 20),
//           INT_MAX where c is outside the grid or a site field is 1023;
//   out = side * sqrt(float(min_p d2(p)))
// every product and the square root rounded on its own (-fmad=false,
// -prec-sqrt=true), as torch's separate ops round them, so out is the
// spec's float32 bit for bit.
//
// What bounds it on an H100: launch latency. A query reads 12 B a point and
// one 4-byte site: ~60 KB for the UR10's ~3,800 points. What this design
// does about it: one block of 1024 threads, each folding the points a block
// width apart into its least d2, then a warp-shuffle and shared-memory min,
// and thread 0 writes the scaled root: one launch, nothing to zero first.
// A batch past ~100,000 points would want more blocks and a second stage.
//
// The launcher returns cudaGetLastError(); the caller raises on non-zero.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kUninit = 1023;            // PBA_UNINITIALISED_COORD
constexpr float kClamp = 1073741824.0f;  // 2^30

// floor_to_int32 of ops/insert.py: floor, clamped to +-2^30, NaN -> 0.
__device__ __forceinline__ int floor_to_int(float x) {
  const float f = floorf(x);
  return isnan(f) ? 0 : static_cast<int>(fminf(fmaxf(f, -kClamp), kClamp));
}

__global__ void __launch_bounds__(kThreads)
min_distance_kernel(const float* __restrict__ points, int64_t n, float recip, float side,
                    const int* __restrict__ packed, int dx, int dy, int dz, float* __restrict__ out) {
  __shared__ int warp_min[kThreads / 32];
  int best = INT_MAX;
  for (int64_t p = threadIdx.x; p < n; p += blockDim.x) {
    const int x = floor_to_int(__fmul_rn(points[3 * p], recip));
    const int y = floor_to_int(__fmul_rn(points[3 * p + 1], recip));
    const int z = floor_to_int(__fmul_rn(points[3 * p + 2], recip));
    if (x < 0 || x >= dx || y < 0 || y >= dy || z < 0 || z >= dz) continue;
    const int v = packed[(static_cast<int64_t>(z) * dy + y) * dx + x];
    const int sx = v & 0x3FF, sy = (v >> 10) & 0x3FF, sz = v >> 20;
    if (sx == kUninit || sy == kUninit || sz == kUninit) continue;
    best = min(best, (x - sx) * (x - sx) + (y - sy) * (y - sy) + (z - sz) * (z - sz));
  }
  for (int o = 16; o > 0; o /= 2) best = min(best, __shfl_down_sync(0xffffffffu, best, o));
  if (threadIdx.x % 32 == 0) warp_min[threadIdx.x / 32] = best;
  __syncthreads();
  if (threadIdx.x >= 32) return;
  best = threadIdx.x < blockDim.x / 32 ? warp_min[threadIdx.x] : INT_MAX;
  for (int o = 16; o > 0; o /= 2) best = min(best, __shfl_down_sync(0xffffffffu, best, o));
  if (threadIdx.x == 0) out[0] = __fmul_rn(__fsqrt_rn(__int2float_rn(best)), side);
}

}  // namespace

// out (one float32): side * sqrt of the least squared distance from the n
// points (float32 [n, 3]) to the obstacles their voxels of the packed int32
// [dz, dy, dx] grid hold; n >= 1.
extern "C" int gv_min_distance_to(const void* points, int64_t n, float recip, float side, const void* packed, int dx,
                                  int dy, int dz, void* out, void* stream) {
  if (n <= 0 || dx <= 0 || dy <= 0 || dz <= 0) return cudaErrorInvalidValue;
  min_distance_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), n, recip, side, static_cast<const int*>(packed), dx, dy, dz,
      static_cast<float*>(out));
  return cudaGetLastError();
}

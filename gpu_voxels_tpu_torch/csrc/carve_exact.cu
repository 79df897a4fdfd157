// Exact projective free-space carve for Hopper (sm_90a): kernel K3.
//
// Replaces gpu_voxels_tpu/ops/raycast_pallas.py
//   projective_free_space_exact_tpu (_carve_exact_kernel) -> gv_carve_exact
// Spec: gpu_voxels_tpu_torch/ops/raycast.py projective_free_space, which is
// gpu_voxels_tpu/ops/raycast.py:75-139 expression for expression.
//
// What it computes: for every voxel of a [dz, dy, dx] grid, whether a depth
// camera observes it free: its centre, in the camera frame, lies in front
// (sz > 1e-6), projects inside the image, the pixel is valid, and
// sz < depth[v, u] - eps. The mask must be bit-identical to the spec.
//
// What bounds it on an H100: the 1-byte-per-voxel mask write (16.7 MB at
// 256^3, about 5 us at 3.35 TB/s) and ~25 f32 operations with one IEEE
// division per voxel pair of (u, v); the 1.2 MB frame (640x480 f32) stays in
// the 50 MB L2, so the per-voxel gather is an L2 hit. The TPU kernel's
// pooled two-phase band refinement exists only to avoid gathers on the TPU;
// here one thread per voxel gathers its own pixel directly.
//
// Bit-identity: every product, sum and quotient is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, and the build passes
// -fmad=false), in the spec's order:
//   wx = (x + 0.5) * side - ox                     (same for y, z)
//   sx = (r00 * wx + r01 * wy) + r02 * wz          (rows of R^T)
//   u  = floor(fx * sx / safe_z + cx)
// floor() is clamped to +-2^30 before the int conversion (NaN -> 0), as the
// spec does, so a projection far outside the image stays outside. The threshold keeps
// the spec's form sz < d - eps, with eps = f32(eps_vox) * f32(side) folded
// on the host. The pose is read from device memory (row-major 4x4).
//
// The launcher returns cudaGetLastError(); the caller raises on non-zero.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kIntClamp = 1073741824.0f;  // 2^30

// floor, clamped to +-2^30, NaN -> 0: the spec's (and XLA's) int conversion
__device__ __forceinline__ int floor_to_int(float x) {
  const float f = floorf(x);
  return isnan(f) ? 0 : static_cast<int>(fminf(fmaxf(f, -kIntClamp), kIntClamp));
}

__global__ void __launch_bounds__(kThreads)
carve_exact_kernel(const float* __restrict__ depth, int h, int w, const float* __restrict__ pose,
                   float fx, float fy, float cx, float cy, float side, float eps, float invalid,
                   int dx, int dy, int n, uint8_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // R^T rows and the origin, from the row-major pose
  const float r00 = __ldg(pose + 0), r01 = __ldg(pose + 4), r02 = __ldg(pose + 8);
  const float r10 = __ldg(pose + 1), r11 = __ldg(pose + 5), r12 = __ldg(pose + 9);
  const float r20 = __ldg(pose + 2), r21 = __ldg(pose + 6), r22 = __ldg(pose + 10);
  const float ox = __ldg(pose + 3), oy = __ldg(pose + 7), oz = __ldg(pose + 11);

  const int x = i % dx;
  const int y = (i / dx) % dy;
  const int z = i / (dx * dy);
  const float wx = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(x), 0.5f), side), ox);
  const float wy = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(y), 0.5f), side), oy);
  const float wz = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(z), 0.5f), side), oz);
  const float sx = __fadd_rn(__fadd_rn(__fmul_rn(r00, wx), __fmul_rn(r01, wy)), __fmul_rn(r02, wz));
  const float sy = __fadd_rn(__fadd_rn(__fmul_rn(r10, wx), __fmul_rn(r11, wy)), __fmul_rn(r12, wz));
  const float sz = __fadd_rn(__fadd_rn(__fmul_rn(r20, wx), __fmul_rn(r21, wy)), __fmul_rn(r22, wz));

  const bool in_front = sz > 1e-6f;
  const float safe_z = in_front ? sz : 1.0f;
  const int u = floor_to_int(__fadd_rn(__fdiv_rn(__fmul_rn(fx, sx), safe_z), cx));
  const int v = floor_to_int(__fadd_rn(__fdiv_rn(__fmul_rn(fy, sy), safe_z), cy));
  bool carved = false;
  if (in_front && u >= 0 && u < w && v >= 0 && v < h) {
    const float d = __ldg(depth + static_cast<int64_t>(v) * w + u);
    carved = (d != invalid) && (sz < __fsub_rn(d, eps));
  }
  out[i] = carved;
}

}  // namespace

// out[i] = 1 where voxel i is carved free, for a [dz, dy, dx] grid (x fastest).
extern "C" int gv_carve_exact(const void* depth, int h, int w, const void* pose, float fx, float fy,
                              float cx, float cy, float side, float eps, float invalid, int dx,
                              int dy, int dz, void* out, void* stream) {
  const int64_t n = static_cast<int64_t>(dx) * dy * dz;
  if (n <= 0) return cudaGetLastError();
  if (n > INT32_MAX) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  carve_exact_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(depth), h, w, static_cast<const float*>(pose), fx, fy, cx, cy,
      side, eps, invalid, dx, dy, static_cast<int>(n), static_cast<uint8_t*>(out));
  return cudaGetLastError();
}

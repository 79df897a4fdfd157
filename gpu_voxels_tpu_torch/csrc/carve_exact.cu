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
// Bit-identity: the projection (carve_projection.cuh) rounds every f32
// operation on its own, in the spec's order. The threshold keeps the spec's
// form sz < d - eps, with eps = f32(eps_vox) * f32(side) folded on the host.
//
// The launcher returns cudaGetLastError(); the caller raises on non-zero.

#include <cuda_runtime.h>

#include <cstdint>

#include "carve_projection.cuh"

namespace {

__global__ void __launch_bounds__(carve::kThreads)
carve_exact_kernel(const float* __restrict__ depth, int h, int w, const float* __restrict__ pose,
                   float fx, float fy, float cx, float cy, float side, float eps, float invalid,
                   int dx, int dy, int n, uint8_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const carve::Projection p =
      carve::project(pose, fx, fy, cx, cy, side, h, w, i % dx, (i / dx) % dy, i / (dx * dy));
  bool carved = false;
  if (p.seen) {
    const float d = __ldg(depth + static_cast<int64_t>(p.v) * w + p.u);
    carved = (d != invalid) && (p.sz < __fsub_rn(d, eps));
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
  const int blocks = static_cast<int>((n + carve::kThreads - 1) / carve::kThreads);
  carve_exact_kernel<<<blocks, carve::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(depth), h, w, static_cast<const float*>(pose), fx, fy, cx, cy,
      side, eps, invalid, dx, dy, static_cast<int>(n), static_cast<uint8_t*>(out));
  return cudaGetLastError();
}

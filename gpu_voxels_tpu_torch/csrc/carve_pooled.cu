// Pooled conservative projective free-space carve for Hopper (sm_90a):
// kernel K6.
//
// Replaces gpu_voxels_tpu/ops/raycast_pallas.py
//   projective_free_space_tpu (_carve_kernel) -> gv_carve_pooled
// Spec: gpu_voxels_tpu_torch/ops/raycast.py projective_free_space_pooled,
// which is gpu_voxels_tpu/ops/raycast_pallas.py:97-137 expression for
// expression.
//
// What it computes: for every voxel of a [dz, dy, dx] grid, whether a depth
// camera observes it free against the P x P min-pooled depth table pm
// (f32[ph, pw], built by the wrapper in plain torch, min_pool_depth, as the
// reference builds it outside its kernel): the voxel's centre, in the camera
// frame, lies in front (sz > 1e-6), projects inside the image at (u, v), and
// sz < pm[v / P, u / P] - eps. Invalid pixels pool to -3e38 and carve
// nothing. The mask must be bit-identical to the spec, and it is a subset of
// the exact carve's (K3) because a pooled minimum is <= every pixel's depth.
//
// What bounds it on an H100: as K3, the projection's ~33 f32 operations per
// voxel (two IEEE divisions) against a 1-byte-per-voxel write; the pooled
// table (19.2 KB at 640x480, P = 8) is read through the read-only cache. The
// TPU kernel's per-tile loop over pooled cells and its supercell early
// decide exist to avoid gathers on the TPU; here one thread per voxel reads
// its one cell directly.
//
// Bit-identity: the projection is K3's (carve_projection.cuh). The threshold
// keeps the spec's form sz < pm - eps, with eps = f32(eps_vox) * f32(side)
// folded on the host.
//
// The launcher returns cudaGetLastError(); the caller raises on non-zero.

#include <cuda_runtime.h>

#include <cstdint>

#include "carve_projection.cuh"

namespace {

__global__ void __launch_bounds__(carve::kThreads)
carve_pooled_kernel(const float* __restrict__ pm, int ph, int pw, int pool, int h, int w,
                    const float* __restrict__ pose, float fx, float fy, float cx, float cy,
                    float side, float eps, int dx, int dy, int n, uint8_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const carve::Projection p =
      carve::project(pose, fx, fy, cx, cy, side, h, w, i % dx, (i / dx) % dy, i / (dx * dy));
  bool carved = false;
  if (p.seen) {
    const int cu = min(p.u / pool, pw - 1);
    const int cv = min(p.v / pool, ph - 1);
    carved = p.sz < __fsub_rn(__ldg(pm + cv * pw + cu), eps);
  }
  out[i] = carved;
}

}  // namespace

// out[i] = 1 where voxel i is carved free against the pooled table pm
// (f32[ph, pw] of a PxP-pooled h x w image), for a [dz, dy, dx] grid.
extern "C" int gv_carve_pooled(const void* pm, int ph, int pw, int pool, int h, int w, const void* pose,
                               float fx, float fy, float cx, float cy, float side, float eps, int dx,
                               int dy, int dz, void* out, void* stream) {
  const int64_t n = static_cast<int64_t>(dx) * dy * dz;
  if (n <= 0) return cudaGetLastError();
  if (n > INT32_MAX) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>((n + carve::kThreads - 1) / carve::kThreads);
  carve_pooled_kernel<<<blocks, carve::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pm), ph, pw, pool, h, w, static_cast<const float*>(pose), fx, fy, cx,
      cy, side, eps, dx, dy, static_cast<int>(n), static_cast<uint8_t*>(out));
  return cudaGetLastError();
}

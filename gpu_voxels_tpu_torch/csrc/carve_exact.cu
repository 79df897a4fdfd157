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
// What bounds it on an H100: the projection's f32 operations (33 per voxel
// with an IEEE division counted as one: 8.3 us at 256^3 and 67 T/s; a
// division is in fact a dozen machine operations and more) against a
// 1-byte-per-voxel mask write (16.7 MB, 5 us at 3.35 TB/s); the 1.2 MB
// frame (640x480 f32) stays in the 50 MB L2, so the per-voxel gather is an
// L2 hit. The TPU kernel's pooled two-phase band refinement exists only to
// avoid gathers on the TPU; here each voxel gathers its own pixel directly.
//
// What held the first form back (0.110 ms at 256^3 on an H100): one thread a
// voxel, each turning its index into (x, y, z) with divisions by dx and dy,
// loading the pose, computing the row's share of the projection again, and
// storing one byte, so a warp's store filled a quarter of a 128-byte line.
//
// What this form does: a row kernel. A thread takes kX consecutive x of one
// (y, z) row; y and z come from the block and thread indices (two divisions
// per block, none per voxel); the row's share of the projection
// (carve_projection.cuh project_row: the pose and the six products with wy
// and wz) is computed once per thread; the kX results leave as one kX-byte
// store where the row's address allows, as bytes on a ragged row end.
//
// Bit-identity: the projection rounds every f32 operation on its own, in the
// spec's order; only products are shared along a row, never a sum. The
// threshold keeps the spec's form sz < d - eps, with eps = f32(eps_vox) *
// f32(side) folded on the host.
//
// A z-slab of a larger grid (the multi-device carve, parallel/sharded.py)
// passes its first global z row z0: the row's global index z + z0 is formed
// as an integer and then converted to f32, as the spec does, which is exact
// below 2^24. z0 = 0 is the whole grid.
//
// The launcher returns cudaGetLastError(); the caller raises on non-zero.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "carve_projection.cuh"

namespace {

__global__ void __launch_bounds__(carve::kThreads)
carve_exact_kernel(const float* __restrict__ depth, int h, int w, const float* __restrict__ pose,
                   float fx, float fy, float cx, float cy, float side, float eps, float invalid,
                   int dx, int dy, int z0, int tiles_x, int tiles_y, uint8_t* __restrict__ out) {
  const carve::RowThread t = carve::row_thread(tiles_x, tiles_y);
  if (t.x0 >= dx || t.y >= dy) return;
  const carve::Row row = carve::project_row(pose, side, t.y, t.z + z0);
  uint64_t carved = 0;  // byte i: voxel x0 + i
#pragma unroll
  for (int i = 0; i < carve::kX; ++i) {
    if (t.x0 + i >= dx) break;
    const carve::Projection p = carve::project_x(row, fx, fy, cx, cy, h, w, t.x0 + i);
    if (p.seen) {
      const float d = __ldg(depth + static_cast<int64_t>(p.v) * w + p.u);
      if ((d != invalid) && (p.sz < __fsub_rn(d, eps))) carved |= 1ull << (8 * i);
    }
  }
  carve::store_row(out, carved, t, dx, dy);
}

}  // namespace

// out[i] = 1 where voxel i is carved free, for a [dz, dy, dx] grid (x fastest)
// whose z index k is global row k + z0.
extern "C" int gv_carve_exact(const void* depth, int h, int w, const void* pose, float fx, float fy,
                              float cx, float cy, float side, float eps, float invalid, int dx,
                              int dy, int dz, int z0, void* out, void* stream) {
  const int64_t n = static_cast<int64_t>(dx) * dy * dz;
  if (n <= 0) return cudaGetLastError();
  if (n > INT32_MAX) return cudaErrorInvalidValue;
  const carve::RowGrid g = carve::row_grid(dx, dy, dz);
  if (g.blocks > INT_MAX) return cudaErrorInvalidValue;
  carve_exact_kernel<<<static_cast<unsigned>(g.blocks), g.block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(depth), h, w, static_cast<const float*>(pose), fx, fy, cx, cy,
      side, eps, invalid, dx, dy, z0, g.tiles_x, g.tiles_y, static_cast<uint8_t*>(out));
  return cudaGetLastError();
}

// The voxel -> pixel projection shared by the carve kernels K3
// (carve_exact.cu) and K6 (carve_pooled.cu).
//
// Bit-identity with the plain torch spec (ops/raycast.py): every product,
// sum and quotient is rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn, and the build passes -fmad=false), in the spec's order:
//   wx = (x + 0.5) * side - ox                     (same for y, z)
//   sx = (r00 * wx + r01 * wy) + r02 * wz          (rows of R^T)
//   u  = floor(fx * sx / safe_z + cx)
// floor() is clamped to +-2^30 before the int conversion (NaN -> 0), as the
// spec does, so a projection far outside the image stays outside. The pose
// is read from device memory (row-major 4x4).
//
// The projection is split in two. project_row() holds what all voxels of one
// (y, z) row share: the pose's x column and origin and the six products
// r.1 * wy, r.2 * wz. project_x() adds what depends on x. Only products are
// shared, each rounded on its own as before; every sum is taken per voxel in
// the spec's order, so project_x(project_row(y, z), x) is project(x, y, z)
// bit for bit. A kernel whose threads walk along x (K3) calls project_row()
// once per thread; project() serves a kernel with one voxel per thread (K6).
#pragma once

#include <cuda_runtime.h>

namespace carve {

constexpr int kThreads = 256;
constexpr float kIntClamp = 1073741824.0f;  // 2^30

// floor, clamped to +-2^30, NaN -> 0: the spec's (and XLA's) int conversion
__device__ __forceinline__ int floor_to_int(float x) {
  const float f = floorf(x);
  return isnan(f) ? 0 : static_cast<int>(fminf(fmaxf(f, -kIntClamp), kIntClamp));
}

struct Projection {
  float sz;   // depth of the voxel centre along the camera's z axis
  int u, v;   // its pixel
  bool seen;  // in front of the camera (sz > 1e-6) and inside the w x h image
};

// What the voxels of one (y, z) row share.
struct Row {
  float r00, r10, r20;  // the x column of R^T
  float ox, side;       // wx = (x + 0.5) * side - ox
  float x_y, x_z;       // r01 * wy, r02 * wz
  float y_y, y_z;       // r11 * wy, r12 * wz
  float z_y, z_z;       // r21 * wy, r22 * wz
};

__device__ __forceinline__ Row project_row(const float* __restrict__ pose, float side, int y, int z) {
  // R^T rows and the origin, from the row-major pose
  const float r01 = __ldg(pose + 4), r02 = __ldg(pose + 8);
  const float r11 = __ldg(pose + 5), r12 = __ldg(pose + 9);
  const float r21 = __ldg(pose + 6), r22 = __ldg(pose + 10);
  const float oy = __ldg(pose + 7), oz = __ldg(pose + 11);
  const float wy = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(y), 0.5f), side), oy);
  const float wz = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(z), 0.5f), side), oz);
  Row r;
  r.r00 = __ldg(pose + 0);
  r.r10 = __ldg(pose + 1);
  r.r20 = __ldg(pose + 2);
  r.ox = __ldg(pose + 3);
  r.side = side;
  r.x_y = __fmul_rn(r01, wy);
  r.x_z = __fmul_rn(r02, wz);
  r.y_y = __fmul_rn(r11, wy);
  r.y_z = __fmul_rn(r12, wz);
  r.z_y = __fmul_rn(r21, wy);
  r.z_z = __fmul_rn(r22, wz);
  return r;
}

// The camera-frame depth and the pixel of the centre of voxel x of the row.
__device__ __forceinline__ Projection project_x(const Row& r, float fx, float fy, float cx, float cy, int h,
                                                int w, int x) {
  const float wx = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(x), 0.5f), r.side), r.ox);
  const float sx = __fadd_rn(__fadd_rn(__fmul_rn(r.r00, wx), r.x_y), r.x_z);
  const float sy = __fadd_rn(__fadd_rn(__fmul_rn(r.r10, wx), r.y_y), r.y_z);
  const float sz = __fadd_rn(__fadd_rn(__fmul_rn(r.r20, wx), r.z_y), r.z_z);

  const bool in_front = sz > 1e-6f;
  const float safe_z = in_front ? sz : 1.0f;
  Projection p;
  p.sz = sz;
  p.u = floor_to_int(__fadd_rn(__fdiv_rn(__fmul_rn(fx, sx), safe_z), cx));
  p.v = floor_to_int(__fadd_rn(__fdiv_rn(__fmul_rn(fy, sy), safe_z), cy));
  p.seen = in_front && p.u >= 0 && p.u < w && p.v >= 0 && p.v < h;
  return p;
}

// The camera-frame depth and the pixel of the centre of voxel (x, y, z).
__device__ __forceinline__ Projection project(const float* __restrict__ pose, float fx, float fy, float cx,
                                              float cy, float side, int h, int w, int x, int y, int z) {
  return project_x(project_row(pose, side, y, z), fx, fy, cx, cy, h, w, x);
}

}  // namespace carve

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

// The camera-frame depth and the pixel of the centre of voxel (x, y, z).
__device__ __forceinline__ Projection project(const float* __restrict__ pose, float fx, float fy, float cx,
                                              float cy, float side, int h, int w, int x, int y, int z) {
  // R^T rows and the origin, from the row-major pose
  const float r00 = __ldg(pose + 0), r01 = __ldg(pose + 4), r02 = __ldg(pose + 8);
  const float r10 = __ldg(pose + 1), r11 = __ldg(pose + 5), r12 = __ldg(pose + 9);
  const float r20 = __ldg(pose + 2), r21 = __ldg(pose + 6), r22 = __ldg(pose + 10);
  const float ox = __ldg(pose + 3), oy = __ldg(pose + 7), oz = __ldg(pose + 11);

  const float wx = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(x), 0.5f), side), ox);
  const float wy = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(y), 0.5f), side), oy);
  const float wz = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(z), 0.5f), side), oz);
  const float sx = __fadd_rn(__fadd_rn(__fmul_rn(r00, wx), __fmul_rn(r01, wy)), __fmul_rn(r02, wz));
  const float sy = __fadd_rn(__fadd_rn(__fmul_rn(r10, wx), __fmul_rn(r11, wy)), __fmul_rn(r12, wz));
  const float sz = __fadd_rn(__fadd_rn(__fmul_rn(r20, wx), __fmul_rn(r21, wy)), __fmul_rn(r22, wz));

  const bool in_front = sz > 1e-6f;
  const float safe_z = in_front ? sz : 1.0f;
  Projection p;
  p.sz = sz;
  p.u = floor_to_int(__fadd_rn(__fdiv_rn(__fmul_rn(fx, sx), safe_z), cx));
  p.v = floor_to_int(__fadd_rn(__fdiv_rn(__fmul_rn(fy, sy), safe_z), cy));
  p.seen = in_front && p.u >= 0 && p.u < w && p.v >= 0 && p.v < h;
  return p;
}

}  // namespace carve

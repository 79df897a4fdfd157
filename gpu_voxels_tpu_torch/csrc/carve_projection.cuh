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
// the spec's order, so project_x(project_row(y, z), x) is the spec's
// projection of voxel (x, y, z) bit for bit. The carve kernels are row kernels: a thread takes kX
// consecutive x of one (y, z) row (row_grid, row_thread), calls project_row()
// once and project_x() per voxel, and stores its kX results as one kX-byte
// store where the row's address allows (store_row).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace carve {

constexpr int kThreads = 256;
constexpr int kX = 8;  // voxels per thread, along x: one 8-byte store
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

// The row kernels' launch: a block is blockDim.y rows of blockDim.x threads,
// as many threads along x as a row needs, up to a warp; blockIdx.x is
// (z, y tile, x tile), x tile fastest.
struct RowGrid {
  dim3 block;
  int tiles_x, tiles_y;
  int64_t blocks;
};

inline RowGrid row_grid(int dx, int dy, int dz) {
  const int groups = (dx + kX - 1) / kX;
  int threads_x = 1;
  while (threads_x < 32 && threads_x < groups) threads_x *= 2;
  RowGrid g;
  g.block = dim3(threads_x, kThreads / threads_x);
  g.tiles_x = (groups + threads_x - 1) / threads_x;
  g.tiles_y = (dy + static_cast<int>(g.block.y) - 1) / static_cast<int>(g.block.y);
  g.blocks = static_cast<int64_t>(g.tiles_x) * g.tiles_y * dz;
  return g;
}

// This thread's row (y, z) and its first voxel x0, from the block and thread
// indices of row_grid's launch: no division per voxel.
struct RowThread {
  int x0, y, z;
};

__device__ __forceinline__ RowThread row_thread(int tiles_x, int tiles_y) {
  const int tile_x = blockIdx.x % tiles_x;
  const int tile_y = (blockIdx.x / tiles_x) % tiles_y;
  RowThread t;
  t.z = blockIdx.x / tiles_x / tiles_y;
  t.x0 = (tile_x * blockDim.x + threadIdx.x) * kX;
  t.y = tile_y * blockDim.y + threadIdx.y;
  return t;
}

// Byte i of `carved` (0 or 1) to voxel x0 + i of the thread's row of a
// [dz, dy, dx] mask: one kX-byte store where the row's address allows (dx a
// multiple of 8), bytes where it does not or where the row ends inside the
// thread's kX voxels.
__device__ __forceinline__ void store_row(uint8_t* __restrict__ out, uint64_t carved, const RowThread& t, int dx,
                                          int dy) {
  uint8_t* dst = out + (static_cast<int64_t>(t.z) * dy + t.y) * dx + t.x0;
  if (t.x0 + kX <= dx && reinterpret_cast<uintptr_t>(dst) % kX == 0) {
    *reinterpret_cast<uint64_t*>(dst) = carved;
  } else {
    for (int i = 0; i < kX && t.x0 + i < dx; ++i) dst[i] = (carved >> (8 * i)) & 1u;
  }
}

}  // namespace carve

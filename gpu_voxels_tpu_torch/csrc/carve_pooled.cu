// Pooled conservative projective free-space carve for Hopper (sm_90a):
// kernel K6, two launches on one stream.
//
// Replaces gpu_voxels_tpu/ops/raycast_pallas.py
//   projective_free_space_tpu (_carve_kernel) -> gv_carve_pooled
//   min_pool_depth (its table, built outside the Pallas kernel, l.552)
//                                             -> gv_min_pool_depth
// Spec: gpu_voxels_tpu_torch/ops/raycast.py min_pool_depth and
// carve_against_pooled (projective_free_space_pooled is the two in turn),
// which are gpu_voxels_tpu/ops/raycast_pallas.py:79-137 expression for
// expression.
//
// What it computes: the P x P min-pooled depth table pm (f32[ph, pw],
// ph = ceil(h / P), pw = ceil(w / P)) of an h x w frame, in which an invalid
// pixel pools to -3e38 (it carves nothing) and an edge cell's positions beyond
// the image to +3e38; then, for every voxel of a [dz, dy, dx] grid, whether
// the camera observes it free against pm: the voxel's centre, in the camera
// frame, lies in front (sz > 1e-6), projects inside the image at (u, v), and
// sz < pm[v / P, u / P] - eps. The mask must be bit-identical to the spec, and
// it is a subset of the exact carve's (K3) because a pooled minimum is <=
// every pixel's depth.
//
// What bounds it on an H100: as K3, the projection's ~33 f32 operations per
// voxel (two IEEE divisions) against a 1-byte-per-voxel write; the table
// (19.2 KB at 640x480, P = 8) is read through the read-only cache. The pool
// reads the frame once (1.2 MB) and writes the table. The TPU kernel's
// per-tile loop over pooled cells and its supercell early decide exist to
// avoid gathers on the TPU; here each voxel reads its one cell directly.
//
// What this design does about it: the carve is a row kernel in K3's form
// (carve_projection.cuh: row_grid, row_thread, project_row once per thread,
// project_x per voxel, store_row), so no thread divides its index and the
// row's share of the projection is computed once for kX voxels. As K3, it
// carves a z-slab of a larger grid when the launcher passes the slab's first
// global row z0: the row's global index z + z0 is formed as an integer and
// only then converted to f32 (project_row), exact below 2^24, so the slabs
// stacked equal the whole grid's mask. z0 = 0 is the whole grid. The pool
// cell of u (and of v) is pool_cell(u), no run-time division: a shift when P
// is a power of two, else the high word of a 32 x 32-bit product with a
// reciprocal computed on the host (pool_divisor), shifted. The pool is one
// launch, one thread per pooled cell.
//
// Bit-identity: the projection is K3's; only products are shared along a
// row, never a sum. The threshold keeps the spec's form sz < pm - eps, with
// eps = f32(eps_vox) * f32(side) folded on the host. The pool propagates NaN
// as torch.amin and jnp.min do (fminf would drop it, and a cell holding a NaN
// pixel would carve where the spec carves nothing); -inf and +inf pass
// through.
//
// The launchers return cudaGetLastError(); the caller raises on non-zero.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "carve_projection.cuh"

namespace {

// u / P for 0 <= u < 2^31 without a division: (mul ? umulhi(u, mul) : u) >> shift.
//
// P = 2^s: mul = 0, shift = s. Otherwise shift = s = floor(log2 P), so that
// 2^s < P < 2^(s+1), and mul = ceil(2^(32+s) / P), which is < 2^32. Let
// k = 32 + s and e = mul * P - 2^k, so 0 <= e <= P - 1 < 2^(s+1). For
// u = q * P + r (0 <= r < P): u * mul / 2^k = q + r / P + u * e / (P * 2^k),
// and u * e < 2^31 * 2^(s+1) = 2^k, so the fraction r / P + u * e / (P * 2^k)
// stays below (r + 1) / P <= 1 and floor(u * mul / 2^k) = q. umulhi(u, mul)
// is floor(u * mul / 2^32), and its shift by s is floor(u * mul / 2^k).
struct PoolDivisor {
  uint32_t mul;
  int shift;
};

PoolDivisor pool_divisor(int pool) {
  int s = 0;
  while ((int64_t{2} << s) <= pool) ++s;
  if ((pool & (pool - 1)) == 0) return {0u, s};
  return {static_cast<uint32_t>(((uint64_t{1} << (32 + s)) + pool - 1) / pool), s};
}

__device__ __forceinline__ int pool_cell(int u, uint32_t mul, int shift) {
  const uint32_t x = static_cast<uint32_t>(u);
  return static_cast<int>((mul ? __umulhi(x, mul) : x) >> shift);
}

__global__ void __launch_bounds__(carve::kThreads)
carve_pooled_kernel(const float* __restrict__ pm, int ph, int pw, uint32_t pool_mul, int pool_shift, int h,
                    int w, const float* __restrict__ pose, float fx, float fy, float cx, float cy, float side,
                    float eps, int dx, int dy, int z0, int tiles_x, int tiles_y, uint8_t* __restrict__ out) {
  const carve::RowThread t = carve::row_thread(tiles_x, tiles_y);
  if (t.x0 >= dx || t.y >= dy) return;
  const carve::Row row = carve::project_row(pose, side, t.y, t.z + z0);
  uint64_t carved = 0;  // byte i: voxel x0 + i
#pragma unroll
  for (int i = 0; i < carve::kX; ++i) {
    if (t.x0 + i >= dx) break;
    const carve::Projection p = carve::project_x(row, fx, fy, cx, cy, h, w, t.x0 + i);
    if (p.seen) {  // 0 <= u < w and 0 <= v < h
      const int cu = min(pool_cell(p.u, pool_mul, pool_shift), pw - 1);
      const int cv = min(pool_cell(p.v, pool_mul, pool_shift), ph - 1);
      if (p.sz < __fsub_rn(__ldg(pm + cv * pw + cu), eps)) carved |= 1ull << (8 * i);
    }
  }
  carve::store_row(out, carved, t, dx, dy);
}

constexpr int kPoolThreads = 128;
constexpr float kInvalidDepth = -3.0e38f;  // an invalid pixel pools to this: it carves nothing
constexpr float kBeyondImage = 3.0e38f;    // an edge cell's positions beyond the image: min-neutral

// One thread per pooled cell: the minimum over its P x P pixels, the spec's
// (raycast.min_pool_depth) bit for bit. A NaN pixel makes the cell NaN; a
// cell that reaches past the image also takes the padding value +3e38.
__global__ void __launch_bounds__(kPoolThreads)
min_pool_kernel(const float* __restrict__ depth, int h, int w, int pool, float invalid, int pw, int cells,
                float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  const int cv = i / pw;
  const int u0 = (i - cv * pw) * pool, v0 = cv * pool;
  const int u1 = w - u0 < pool ? w : u0 + pool;
  const int v1 = h - v0 < pool ? h : v0 + pool;
  float m = (u1 - u0 < pool || v1 - v0 < pool) ? kBeyondImage : INFINITY;
  for (int v = v0; v < v1; ++v) {
    const float* row = depth + static_cast<int64_t>(v) * w;
    for (int u = u0; u < u1; ++u) {
      float x = __ldg(row + u);
      x = (x == invalid) ? kInvalidDepth : x;
      if (isnan(x) || x < m) m = x;  // once m is NaN no x is below it
    }
  }
  out[i] = m;
}

}  // namespace

// out = the P x P min-pool (f32[ceil(h/P), ceil(w/P)]) of an h x w depth image.
extern "C" int gv_min_pool_depth(const void* depth, int h, int w, int pool, float invalid, void* out,
                                 void* stream) {
  if (pool < 1 || h < 0 || w < 0) return cudaErrorInvalidValue;
  const int64_t ph = (static_cast<int64_t>(h) + pool - 1) / pool;
  const int64_t pw = (static_cast<int64_t>(w) + pool - 1) / pool;
  const int64_t cells = ph * pw;  // <= h * w
  if (cells <= 0) return cudaGetLastError();
  if (static_cast<int64_t>(h) * w > INT32_MAX) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>((cells + kPoolThreads - 1) / kPoolThreads);
  min_pool_kernel<<<blocks, kPoolThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(depth), h, w, pool, invalid, static_cast<int>(pw), static_cast<int>(cells),
      static_cast<float*>(out));
  return cudaGetLastError();
}

// out[i] = 1 where voxel i is carved free against the pooled table pm
// (f32[ph, pw] of a PxP-pooled h x w image), for a [dz, dy, dx] grid whose z
// index k is global row k + z0.
extern "C" int gv_carve_pooled(const void* pm, int ph, int pw, int pool, int h, int w, const void* pose,
                               float fx, float fy, float cx, float cy, float side, float eps, int dx,
                               int dy, int dz, int z0, void* out, void* stream) {
  if (pool < 1) return cudaErrorInvalidValue;
  if (static_cast<int64_t>(ph) * pw > INT32_MAX) return cudaErrorInvalidValue;
  const int64_t n = static_cast<int64_t>(dx) * dy * dz;
  if (n <= 0) return cudaGetLastError();
  if (n > INT32_MAX) return cudaErrorInvalidValue;
  const carve::RowGrid g = carve::row_grid(dx, dy, dz);
  if (g.blocks > INT_MAX) return cudaErrorInvalidValue;
  const PoolDivisor div = pool_divisor(pool);
  carve_pooled_kernel<<<static_cast<unsigned>(g.blocks), g.block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pm), ph, pw, div.mul, div.shift, h, w, static_cast<const float*>(pose), fx,
      fy, cx, cy, side, eps, dx, dy, z0, g.tiles_x, g.tiles_y, static_cast<uint8_t*>(out));
  return cudaGetLastError();
}

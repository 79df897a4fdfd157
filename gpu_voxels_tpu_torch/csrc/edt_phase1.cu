// The exact EDT's grids before K5 for Hopper (sm_90a): the obstacle merge in
// one launch (gv_merge_occupied) and PBA phase 1, the Z flood, in another
// (gv_flood_z).
//
// Replaces no TPU kernel: the JAX package's merge (ops/edt.py
// with_obstacles) and Z flood (ops/edt_envelope.py flood_z, _nearest_scan)
// are jnp that XLA fuses into a few TPU programs. In PyTorch the same
// arithmetic is ~8 full-grid passes for the merge (the int8 -> int32 cast,
// the compare, the position grid, two selects) and ~15 for the flood (the
// unpack, the site test, a cummax, a flipped cummin, ~10 selects, the
// repack): ~60 launches a 256^3 field. Specs: gpu_voxels_tpu_torch/ops/edt.py
// merge_occupied and ops/edt_envelope.py flood_z_plain (in ops/edt_cuda.py,
// merge_occupied_plain and flood_z_plain).
//
// gv_merge_occupied: one pass over the N voxels of a [dz, dy, dx] grid (x
// fastest) whose z index k is global row k + z0:
//   out[i] = prob[i] >= threshold ? x | y << 10 | (z + z0) << 20 : packed[i]
// (int8 log-odds compared as int; the coordinates packed in unsigned
// arithmetic, so every bit is torch's int32 one).
//
// gv_flood_z: for each (y, x) column of a [dz, dy, dx] packed grid (every
// extent <= 1024), a site is a voxel holding its own x, y, z with
// x != PBA_UNINITIALISED_COORD; for each z, with `down` the last site at or
// below z and `up` the first at or above it,
//   g1[z, y, x]   = min(dd, du), dd = (z - down)^2 (MISS if none), du alike
//   pay1[z, y, x] = x | y << 10 | near << 20, near = dd <= du ? down : up,
//                   1023 where the column has no site
// so on equal distance the lower z wins, as the spec's `dd <= du`.
//
// What bounds them on an H100: bytes. The flood reads 4 B a voxel and
// writes 8 (g1 and pay1): 201 MB, 0.060 ms at 256^3 and 3.35 TB/s. The
// merge reads 5 B a voxel and writes 4: 151 MB, 0.045 ms. The arithmetic is
// a few integer operations a voxel.
//
// What the flood's design does about it: a block owns 32 consecutive x of
// one y row over every z, so each warp-wide load or store is one 128-byte
// run along x. Its 8 warps take 32-z words of the columns in turn: a warp
// loads a word's 32 rows at once (32 independent loads a thread in flight;
// at 256^3 there are only 65,536 columns), tests them and keeps the word of
// site bits in shared memory (32 words of 32 columns, 4 KB: dz <= 1024).
// After one barrier each warp writes its words' rows: `down` and `up` are a
// count of leading zeros and a find-first-set on the word, or on the nearest
// non-empty word below or above it. The grid is read once and each output
// written once. The merge takes 4 voxels at a time, a 16-byte load of packed
// and a store of out and a 4-byte load of prob, so a warp's every load and
// store is one contiguous run; a thread issues the loads of 4 such quads
// (a block's width apart) before it computes any, and steps x, y, z from
// each quad's first voxel. Where packed or out is not 16-byte aligned, or
// prob not 4-byte aligned (a view), it takes one voxel a thread.
//
// The launchers return cudaGetLastError(); the caller raises on non-zero.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kMiss = 1 << 27;      // edt_envelope.MISS: no site
constexpr int kUninit = 1023;       // PBA_UNINITIALISED_COORD
constexpr int kCols = 32;           // x columns a flood block: a warp's lanes
constexpr int kWarps = 8;           // warps a flood block, each over 32-z words
constexpr int kMaxWords = 32;       // 32-z words a column: dz <= 1024
constexpr int kThreads = 256;       // threads a merge block
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks' worth per SM
constexpr int kQuads = 4;           // quads (4 voxels) a merge thread takes a step on the vector path

__global__ void __launch_bounds__(kCols * kWarps)
flood_z_kernel(const int* __restrict__ packed, int* __restrict__ g1, int* __restrict__ pay1, int dx, int dy,
               int dz) {
  __shared__ unsigned sites[kMaxWords][kCols];  // bit b of sites[w][l]: z = 32 w + b of lane l's column
  const int lane = threadIdx.x % kCols, warp = threadIdx.x / kCols;
  const int x = blockIdx.x * kCols + lane, y = blockIdx.y;
  const bool live = x < dx;
  const int words = (dz + 31) / 32;
  const int64_t plane = static_cast<int64_t>(dx) * dy;
  const int64_t column = static_cast<int64_t>(y) * dx + x;
  const int own_xy = x | (y << 10);

  for (int w = warp; w < words; w += kWarps) {
    int v[32];
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const int z = 32 * w + b;
      v[b] = (live && z < dz) ? packed[column + z * plane] : -1;  // -1 is never a site
    }
    unsigned bits = 0u;
#pragma unroll
    for (int b = 0; b < 32; ++b) bits |= static_cast<unsigned>(v[b] == (own_xy | ((32 * w + b) << 20))) << b;
    sites[w][lane] = x == kUninit ? 0u : bits;
  }
  __syncthreads();
  if (!live) return;

  for (int w = warp; w < words; w += kWarps) {
    const unsigned bits = sites[w][lane];
    int below = -1, above = -1;  // the last site under word w, the first over it
    for (int k = w - 1; k >= 0; --k) {
      const unsigned s = sites[k][lane];
      if (s != 0u) {
        below = 32 * k + 31 - __clz(s);
        break;
      }
    }
    for (int k = w + 1; k < words; ++k) {
      const unsigned s = sites[k][lane];
      if (s != 0u) {
        above = 32 * k + __ffs(s) - 1;
        break;
      }
    }
    const int zn = min(32, dz - 32 * w);
#pragma unroll 4
    for (int b = 0; b < zn; ++b) {
      const int z = 32 * w + b;
      const unsigned le = bits & (0xffffffffu >> (31 - b));  // bits 0..b
      const unsigned ge = bits >> b;                          // bits b..31, from bit 0
      const int down = le != 0u ? 32 * w + 31 - __clz(le) : below;
      const int up = ge != 0u ? z + __ffs(ge) - 1 : above;
      const int dd = down >= 0 ? (z - down) * (z - down) : kMiss;
      const int du = up >= 0 ? (up - z) * (up - z) : kMiss;
      const int near = dd <= du ? down : up;  // -1 only where the column has no site
      const int64_t i = column + z * plane;
      g1[i] = min(dd, du);
      pay1[i] = own_xy | ((near < 0 ? kUninit : near) << 20);
    }
  }
}

// x | y << 10 | z << 20 in unsigned arithmetic: torch's int32 bits
__device__ __forceinline__ int own_packed(int x, int y, int z) {
  return static_cast<int>(static_cast<unsigned>(x) | (static_cast<unsigned>(y) << 10) |
                          (static_cast<unsigned>(z) << 20));
}

__global__ void __launch_bounds__(kThreads)
merge_vec_kernel(const int* __restrict__ packed, const int8_t* __restrict__ prob, int* __restrict__ out, int n,
                 int dx, int dy, int z0, int threshold) {
  const int quads = n / 4;
  const int step = gridDim.x * blockDim.x * kQuads;
  for (int base = blockIdx.x * blockDim.x * kQuads + threadIdx.x; base < quads; base += step) {
    int4 v[kQuads];
    unsigned pw[kQuads];
#pragma unroll
    for (int k = 0; k < kQuads; ++k) {  // every load first: kQuads 16-byte and 4-byte loads in flight
      const int q = base + k * blockDim.x;
      v[k] = q < quads ? reinterpret_cast<const int4*>(packed)[q] : make_int4(0, 0, 0, 0);
      pw[k] = q < quads ? reinterpret_cast<const unsigned*>(prob)[q] : 0u;
    }
#pragma unroll
    for (int k = 0; k < kQuads; ++k) {
      const int q = base + k * blockDim.x;
      if (q >= quads) break;
      const int i0 = 4 * q, row = i0 / dx;
      int x = i0 - row * dx, y = row % dy, z = row / dy + z0;
      int o[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // byte j of the word: voxel i0 + j
        if (static_cast<int8_t>((pw[k] >> (8u * j)) & 0xffu) >= threshold) o[j] = own_packed(x, y, z);
        if (++x == dx) {
          x = 0;
          if (++y == dy) y = 0, ++z;
        }
      }
      reinterpret_cast<int4*>(out)[q] = make_int4(o[0], o[1], o[2], o[3]);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {  // the last n % 4 voxels
    for (int i = 4 * quads; i < n; ++i) {
      const int row = i / dx;
      out[i] = prob[i] >= threshold ? own_packed(i - row * dx, row % dy, row / dy + z0) : packed[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
merge_scalar_kernel(const int* __restrict__ packed, const int8_t* __restrict__ prob, int* __restrict__ out, int n,
                    int dx, int dy, int z0, int threshold) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; j < n; j += stride) {
    const int i = static_cast<int>(j), row = i / dx;
    out[i] = prob[i] >= threshold ? own_packed(i - row * dx, row % dy, row / dy + z0) : packed[i];
  }
}

unsigned grid_of(int64_t items) {
  const int64_t blocks = (items + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

// int32 g1 and pay1 [dz, dy, dx]: PBA phase 1 of the packed int32 grid
// `packed` of the same shape; every extent at most 1024.
extern "C" int gv_flood_z(const void* packed, void* g1, void* pay1, int dx, int dy, int dz, void* stream) {
  if (dx <= 0 || dy <= 0 || dz <= 0) return cudaGetLastError();
  if (dx > 1024 || dy > 1024 || dz > kCols * kMaxWords) return cudaErrorInvalidValue;
  const dim3 grid((dx + kCols - 1) / kCols, dy);
  flood_z_kernel<<<grid, kCols * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(packed), static_cast<int*>(g1), static_cast<int*>(pay1), dx, dy, dz);
  return cudaGetLastError();
}

// out[N] int32: `packed` with every voxel whose log-odds prob[i] (int8) is
// >= threshold made an obstacle holding its own coordinates, z + z0 its
// global row; N voxels of a grid dx wide and dy deep.
extern "C" int gv_merge_occupied(const void* packed, const void* prob, void* out, int64_t n, int dx, int dy, int z0,
                                 int threshold, void* stream) {
  if (n <= 0) return cudaGetLastError();
  if (n > INT32_MAX || dx <= 0 || dy <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const int*>(packed);
  const auto* pr = static_cast<const int8_t*>(prob);
  auto* o = static_cast<int*>(out);
  const int m = static_cast<int>(n);
  if (aligned(packed, 16) && aligned(out, 16) && aligned(prob, 4)) {
    // at least one thread: with fewer than 4 voxels it takes them all
    const unsigned g = grid_of(std::max<int64_t>((n / 4 + kQuads - 1) / kQuads, 1));
    merge_vec_kernel<<<g, kThreads, 0, s>>>(p, pr, o, m, dx, dy, z0, threshold);
  } else {
    merge_scalar_kernel<<<grid_of(n), kThreads, 0, s>>>(p, pr, o, m, dx, dy, z0, threshold);
  }
  return cudaGetLastError();
}

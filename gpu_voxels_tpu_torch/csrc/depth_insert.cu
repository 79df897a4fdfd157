// A depth frame's update of an int8 log-odds map for Hopper (sm_90a): the
// frame's hit counts in one launch (S1) and the log-odds update in another
// (S2), on either side of the carve (K3 or K6).
//
// Replaces no TPU kernel: the JAX package's frame update
// (gpu_voxels_tpu/ops/raycast.py insert_depth_image and
// depth_image_to_point_cloud) is plain jnp that XLA fuses into a few TPU
// programs. In PyTorch the same arithmetic is ~40 elementwise launches for
// the hits (back-projection, the pose's product, the finite and in-map
// tests, the linear index, a zeroed buffer and index_add_) and ~12 full-grid
// passes for the update, each a few microseconds of host time around
// microseconds of work. Spec: gpu_voxels_tpu_torch/ops/raycast.py
// depth_hits and log_odds_update (in ops/raycast_cuda.py, depth_hits_plain
// and log_odds_update_plain).
//
// S1, gv_depth_hits: int32 counts[N] of a [dz, dy, dx] grid (x fastest),
// zeroed by a memset on the same stream, then one thread a pixel:
//   valid = depth != invalid;
//   x = (u - cx) * z / fx, y = (v - cy) * z / fy (IEEE division);
//   world_i = ((m[i][0] x + m[i][1] y) + m[i][2] z) + m[i][3];
//   skipped unless every world_i is finite; c_i = floor(world_i * recip),
//   clamped to +-2^30 (floor_to_int32), recip = f32(1 / side) from the host;
//   c_z -= z0 (the slab's first global row, as an integer);
//   skipped unless 0 <= c < (dx, dy, dz); atomicAdd(counts[c], 1).
// The pose is the sensor-to-world 4 x 4 (row-major): a pose given on the
// host (the sensor's, computed there) travels in the launch's arguments
// (Frame), so it costs no upload; a pose already on the card is read there.
//
// S2, gv_log_odds_update: one pass over the voxels,
//   h = robot[i] ? 0 : counts[i]        (robot mask optional)
//   delta = h * 72 + (free[i] && h == 0 ? -10 : 0)
//   out[i] = delta != 0 ? clamp(data[i] + delta, -127, 127) : data[i]
// in int32 arithmetic that wraps as torch's does, so out is the spec's byte
// for byte.
//
// What bounds them on an H100: launch latency. S1 reads the 1.2 MB frame
// and adds one atomic per valid pixel (307,200 at 640 x 480) into counts
// that the memset writes (4 B a voxel: 9 MB at 150 x 150 x 100, 67 MB at
// 256^3); S2 reads 6 B a voxel (data, free, counts; 7 with the robot mask)
// and writes 1: 16 MB or ~5 us for the monitor's 2.25 M voxels, 117 MB or
// ~35 us at 256^3. What this design does about it: one launch each and no
// host read; S2 moves 16 voxels a thread with 16-byte loads of data, free
// and the mask and four 16-byte loads of counts, where every pointer is
// 16-byte aligned (the wrapper's outputs always are; a map that is a view
// may not be), and one voxel a thread otherwise.
//
// Rounding: every product, sum and division of S1 is an explicitly rounded
// intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn: no fused multiply-add, IEEE
// division), in the order written above, as torch's separate elementwise ops
// round them on the CPU. On the
// card the plain version divides by fx as a product with the reciprocal
// (torch's CUDA division by a scalar) and takes the pose's product in
// cuBLAS, which orders and fuses its sums its own way: the kernel and the
// plain version agree to a few float32 ulps, so a point within ~1e-4 voxel
// of a cell boundary may be counted in either cell.
//
// The launchers return cudaGetLastError(); the caller raises on non-zero.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks' worth per SM
constexpr int kOccupied = 72;         // SENSOR_MODEL_OCCUPIED
constexpr int kFree = -10;            // SENSOR_MODEL_FREE
constexpr int kMinP = -127, kMaxP = 127;
constexpr int kVec = 16;              // voxels a thread on the vector path
constexpr float kClamp = 1073741824.0f;  // 2^30

// The frame's scalars, and the pose's first three rows where it comes
// from the host, passed by value in the kernel's parameters.
struct Frame {
  float m[12];
  float fx, fy, cx, cy, invalid, recip;
  int w, dx, dy, dz, z0;
  int64_t pixels;
};

// floor_to_int32 of ops/insert.py: floor, clamped to +-2^30, NaN -> 0
// (carve_projection.cuh's).
__device__ __forceinline__ int floor_to_int(float x) {
  const float f = floorf(x);
  return isnan(f) ? 0 : static_cast<int>(fminf(fmaxf(f, -kClamp), kClamp));
}

// m may point into the launch's parameters (Frame): a generic address.
__global__ void __launch_bounds__(kThreads)
depth_hits_kernel(const float* __restrict__ depth, const float* pose, const __grid_constant__ Frame f,
                  int* __restrict__ counts) {
  const float* m = pose != nullptr ? pose : f.m;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; p < f.pixels; p += stride) {
    const float z = depth[p];
    if (z == f.invalid) continue;  // the spec's valid = depth != invalid (NaN stays valid)
    const int v = static_cast<int>(p / f.w);
    const int u = static_cast<int>(p - static_cast<int64_t>(v) * f.w);
    const float x = __fdiv_rn(__fmul_rn(__fsub_rn(static_cast<float>(u), f.cx), z), f.fx);
    const float y = __fdiv_rn(__fmul_rn(__fsub_rn(static_cast<float>(v), f.cy), z), f.fy);
    int c[3];
    bool finite = true;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float* r = m + 4 * i;
      const float rxy = __fadd_rn(__fmul_rn(r[0], x), __fmul_rn(r[1], y));
      const float wi = __fadd_rn(__fadd_rn(rxy, __fmul_rn(r[2], z)), r[3]);
      finite = finite && isfinite(wi);
      c[i] = floor_to_int(__fmul_rn(wi, f.recip));
    }
    if (!finite) continue;
    c[2] -= f.z0;
    if (c[0] < 0 || c[0] >= f.dx || c[1] < 0 || c[1] >= f.dy || c[2] < 0 || c[2] >= f.dz) continue;
    atomicAdd(counts + (static_cast<int64_t>(c[2]) * f.dy + c[1]) * f.dx + c[0], 1);
  }
}

// One voxel's update; unsigned products and sums wrap as torch's int32 do.
__device__ __forceinline__ int8_t updated(int8_t data, int count, bool carved, bool robot) {
  const unsigned h = robot ? 0u : static_cast<unsigned>(count);
  const int delta = static_cast<int>(h * static_cast<unsigned>(kOccupied) +
                                     ((carved && h == 0u) ? static_cast<unsigned>(kFree) : 0u));
  if (delta == 0) return data;
  const int s = static_cast<int>(static_cast<unsigned>(data) + static_cast<unsigned>(delta));
  return static_cast<int8_t>(s < kMinP ? kMinP : (s > kMaxP ? kMaxP : s));
}

template <bool kMask>
__global__ void __launch_bounds__(kThreads)
log_odds_vec_kernel(const int8_t* __restrict__ data, const int* __restrict__ counts, const uint8_t* __restrict__ freed,
                    const uint8_t* __restrict__ robot, int8_t* __restrict__ out, int64_t n) {
  const int64_t chunks = (n + kVec - 1) / kVec;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; c < chunks; c += stride) {
    const int64_t i0 = c * kVec;
    if (i0 + kVec > n) {  // the ragged last chunk, voxel by voxel
      for (int64_t i = i0; i < n; ++i) out[i] = updated(data[i], counts[i], freed[i] != 0, kMask && robot[i] != 0);
      continue;
    }
    const uint4 d4 = *reinterpret_cast<const uint4*>(data + i0);
    const uint4 f4 = *reinterpret_cast<const uint4*>(freed + i0);
    const uint4 r4 = kMask ? *reinterpret_cast<const uint4*>(robot + i0) : make_uint4(0, 0, 0, 0);
    const unsigned dw[4] = {d4.x, d4.y, d4.z, d4.w}, fw[4] = {f4.x, f4.y, f4.z, f4.w};
    const unsigned rw[4] = {r4.x, r4.y, r4.z, r4.w};
    unsigned ow[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      const int4 h = reinterpret_cast<const int4*>(counts + i0)[q];
      const int hq[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // byte k of word q: voxel i0 + 4 q + k
        const unsigned sh = 8u * k;
        const int8_t o = updated(static_cast<int8_t>((dw[q] >> sh) & 0xffu), hq[k], ((fw[q] >> sh) & 0xffu) != 0u,
                                 kMask && ((rw[q] >> sh) & 0xffu) != 0u);
        ow[q] |= static_cast<unsigned>(static_cast<uint8_t>(o)) << sh;
      }
    }
    *reinterpret_cast<uint4*>(out + i0) = make_uint4(ow[0], ow[1], ow[2], ow[3]);
  }
}

template <bool kMask>
__global__ void __launch_bounds__(kThreads)
log_odds_scalar_kernel(const int8_t* __restrict__ data, const int* __restrict__ counts,
                       const uint8_t* __restrict__ freed, const uint8_t* __restrict__ robot,
                       int8_t* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    out[i] = updated(data[i], counts[i], freed[i] != 0, kMask && robot[i] != 0);
  }
}

unsigned grid_of(int64_t items) {
  const int64_t blocks = (items + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

bool aligned(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// counts[N] of a [dz, dy, dx] grid whose z index k is global row k + z0: the
// pixels of an h x w depth frame that land in each voxel. pose: the 4 x 4 on
// the card, or NULL and host_pose the 4 x 4 on the host.
extern "C" int gv_depth_hits(const void* depth, int h, int w, const void* pose, const void* host_pose, float fx,
                             float fy, float cx, float cy, float invalid, float recip, int dx, int dy, int dz, int z0,
                             void* counts, void* stream) {
  const int64_t n = static_cast<int64_t>(dx) * dy * dz;
  if (n <= 0) return cudaGetLastError();
  if (n > INT32_MAX || h < 0 || w < 0 || (pose == nullptr && host_pose == nullptr)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(counts, 0, static_cast<size_t>(n) * sizeof(int), s);
  if (err != cudaSuccess) return err;
  Frame f{};
  if (pose == nullptr) std::memcpy(f.m, host_pose, sizeof(f.m));
  f.fx = fx; f.fy = fy; f.cx = cx; f.cy = cy; f.invalid = invalid; f.recip = recip;
  f.w = w; f.dx = dx; f.dy = dy; f.dz = dz; f.z0 = z0;
  f.pixels = static_cast<int64_t>(h) * w;
  if (f.pixels == 0) return cudaGetLastError();
  depth_hits_kernel<<<grid_of(f.pixels), kThreads, 0, s>>>(static_cast<const float*>(depth),
                                                           static_cast<const float*>(pose), f,
                                                           static_cast<int*>(counts));
  return cudaGetLastError();
}

// out[i] = data[i] updated by counts[i] hits and the carve's free[i], a voxel
// of robot (NULL: none) taking no hits; bool arrays are one byte a voxel.
extern "C" int gv_log_odds_update(const void* data, const void* counts, const void* freed, const void* robot, void* out,
                                  int64_t n, void* stream) {
  if (n <= 0) return cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const int8_t*>(data);
  const auto* c = static_cast<const int*>(counts);
  const auto* fr = static_cast<const uint8_t*>(freed);
  const auto* rb = static_cast<const uint8_t*>(robot);
  auto* o = static_cast<int8_t*>(out);
  if (aligned(data) && aligned(counts) && aligned(freed) && aligned(robot) && aligned(out)) {
    const unsigned g = grid_of((n + kVec - 1) / kVec);
    if (robot != nullptr) {
      log_odds_vec_kernel<true><<<g, kThreads, 0, s>>>(d, c, fr, rb, o, n);
    } else {
      log_odds_vec_kernel<false><<<g, kThreads, 0, s>>>(d, c, fr, rb, o, n);
    }
  } else if (robot != nullptr) {
    log_odds_scalar_kernel<true><<<grid_of(n), kThreads, 0, s>>>(d, c, fr, rb, o, n);
  } else {
    log_odds_scalar_kernel<false><<<grid_of(n), kThreads, 0, s>>>(d, c, fr, rb, o, n);
  }
  return cudaGetLastError();
}

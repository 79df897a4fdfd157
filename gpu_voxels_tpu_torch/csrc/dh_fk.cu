// Forward kinematics of a Denavit-Hartenberg chain for Hopper (sm_90a): the
// chain's per-link products and the per-link transform of its clouds, fused
// into one launch.
//
// Replaces no TPU kernel: the JAX package's FK (gpu_voxels_tpu/robot/dh.py,
// link_matrices and MetaPointCloud.transformed_per_cloud) is plain jnp that
// XLA fuses into a few TPU programs. In PyTorch the same arithmetic is ~25
// elementwise launches a link plus a batched transform, ~180 launches for a
// UR10, each a few microseconds of host time around nanoseconds of work.
// Spec: gpu_voxels_tpu_torch/robot/dh_cuda.py dh_chain_plain and
// dh_fk_points_plain (transforms.dh_matrix, then the batched 4x4 products of
// KinematicChain.link_matrices, then MetaPointCloud.transformed_per_cloud).
//
// What it computes: for a state t with joint values v[t, 0..L-1] and link
// i's DH parameters (d, theta, a, alpha) and joint type, DH_i is
// transforms.dh_matrix's matrix (the joint value added to theta for a
// revolute joint, to d for a prismatic one), and link i's cloud moves by
// DH_0 * ... * DH_{i-1}, the identity for the first link: the transform is
// taken BEFORE the link's own matrix (KinematicChain.cu:93-126).
// gv_dh_fk_points writes every cloud point p moved by its link's product,
// out[t, p] = R p + t; gv_dh_chain writes the products themselves,
// out[t, c] for each cloud c (bottom row 0 0 0 1).
//
// What bounds it on an H100: launch latency. The work is 7 products of 4x4
// matrices a state and a 3x3 rotation and translation a point; the bytes
// are ~12 B written per point and state (a 34-state motion check of the
// UR10's ~3,800 points writes 1.55 MB, under 1 us at 3.35 TB/s).
//
// What this design does about it: one launch per FK call and no host read.
// One state given on the host (a monitor's joint reading, a stored
// configuration) travels in the launch's own arguments (HostValues), so it
// costs no upload either; a batch is read from device memory.
// A block takes one state and a run of kThreads points; its first warp
// computes the state's prefix products (3 x 4 each, the fourth row being
// 0 0 0 1) into shared memory, twelve lanes holding one entry each and
// exchanging the row they multiply by shuffles, then every thread moves its
// point. Each block recomputes its state's chain: 7 tiny products cost less
// than a second launch or a trip through device memory. Blocks walk a flat
// (state, run of points) index in a grid-stride loop, so any number of
// states fits (gridDim.y would stop at 65,535) and offsets are int64.
//
// Rounding: nvcc builds this file with -fmad=false and without fast math,
// so cosf and sinf are the precise ones torch's CUDA cos and sin call, and
// every product and sum is rounded on its own, as torch's separate
// elementwise ops round them. A product entry is summed over k = 0..3 in
// order, the fourth row included (its zero terms are exact); a point is
// ((r0 x + r1 y) + r2 z) + t. cuBLAS, which the plain version calls for its
// products, may fuse and order those sums otherwise, so the kernel and the
// plain version agree to a few float32 ulps, not bit for bit.
//
// The launchers return cudaGetLastError(); the caller raises on non-zero.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxLinks = 64;  // the wrapper refuses longer chains
constexpr int kThreads = 256;  // points per block and iteration
constexpr int kPrismatic = 1;  // transforms.PRISMATIC
constexpr int64_t kMaxBlocks = int64_t{1} << 20;
constexpr unsigned kFull = 0xffffffffu;

// One state's joint values passed by value in the kernel's parameters.
struct HostValues {
  float v[kMaxLinks];
};

// The values of a launch: device values[T, L], or else (values == NULL, T = 1)
// the L floats at host_values, copied into the launch's arguments.
bool host_state(const void* values, const void* host_values, int64_t T, int L, HostValues* out) {
  if (values != nullptr) return true;
  if (host_values == nullptr || T != 1) return false;
  std::memcpy(out->v, host_values, sizeof(float) * L);
  return true;
}

// Called by one whole warp. Writes prefix[i * 12 + r * 4 + c] = entry (r, c)
// of DH_0 * ... * DH_{i-1} for i < L. Lane r * 4 + c (< 12) holds that entry
// of the running product.
// v may point into the launch's parameters (HostValues): a generic address.
__device__ void chain_prefix(const float* v, const float* __restrict__ params,
                             const int* __restrict__ joint_types, int L, float* prefix) {
  const int lane = threadIdx.x & 31;
  const int r = lane >> 2, c = lane & 3;  // lanes >= 12 compute entries nobody stores
  float acc = (r == c) ? 1.0f : 0.0f;
  for (int i = 0; i < L; ++i) {
    if (lane < 12) prefix[i * 12 + lane] = acc;
    const float d = params[i * 4], theta = params[i * 4 + 1], a = params[i * 4 + 2], alpha = params[i * 4 + 3];
    const float value = v[i];
    float d_c = d, th_c = theta;
    if (joint_types[i] == kPrismatic) {
      d_c = d + value;
    } else {
      th_c = theta + value;
    }
    const float ca = cosf(alpha), sa = sinf(alpha);
    const float ct = cosf(th_c), st = sinf(th_c);
    // column c of DH_i (transforms.dh_matrix's rows, read down)
    float m0, m1, m2, m3;
    if (c == 0) {
      m0 = ct; m1 = st; m2 = 0.0f; m3 = 0.0f;
    } else if (c == 1) {
      m0 = -st * ca; m1 = ct * ca; m2 = sa; m3 = 0.0f;
    } else if (c == 2) {
      m0 = st * sa; m1 = -ct * sa; m2 = ca; m3 = 0.0f;
    } else {
      m0 = a * ct; m1 = a * st; m2 = d_c; m3 = 1.0f;
    }
    const int row = (r & 7) * 4;  // keeps every source lane inside the warp
    const float a0 = __shfl_sync(kFull, acc, row);
    const float a1 = __shfl_sync(kFull, acc, row + 1);
    const float a2 = __shfl_sync(kFull, acc, row + 2);
    const float a3 = __shfl_sync(kFull, acc, row + 3);
    acc = a0 * m0 + a1 * m1 + a2 * m2 + a3 * m3;
  }
}

__global__ void __launch_bounds__(kThreads)
dh_fk_points_kernel(const float* __restrict__ values, const __grid_constant__ HostValues host,
                    const float* __restrict__ params,
                    const int* __restrict__ joint_types, const int* __restrict__ cloud_link,
                    const int* __restrict__ point_cloud, const float* __restrict__ points,
                    float* __restrict__ out, int L, int64_t P, int64_t runs, int64_t total) {
  __shared__ float prefix[kMaxLinks * 12];
  for (int64_t b = blockIdx.x; b < total; b += gridDim.x) {
    const int64_t t = b / runs;
    const int64_t p = (b - t * runs) * kThreads + threadIdx.x;
    if (threadIdx.x < 32) chain_prefix(values ? values + t * L : host.v, params, joint_types, L, prefix);
    __syncthreads();
    if (p < P) {
      const float* m = prefix + cloud_link[point_cloud[p]] * 12;
      const float x = points[p * 3], y = points[p * 3 + 1], z = points[p * 3 + 2];
      float* o = out + (t * P + p) * 3;
      o[0] = m[0] * x + m[1] * y + m[2] * z + m[3];
      o[1] = m[4] * x + m[5] * y + m[6] * z + m[7];
      o[2] = m[8] * x + m[9] * y + m[10] * z + m[11];
    }
    __syncthreads();  // the next state's chain overwrites prefix
  }
}

// One warp a state: the chain, then the C clouds' 4 x 4 products.
__global__ void __launch_bounds__(32)
dh_chain_kernel(const float* __restrict__ values, const __grid_constant__ HostValues host,
                const float* __restrict__ params,
                const int* __restrict__ joint_types, const int* __restrict__ cloud_link,
                float* __restrict__ out, int64_t T, int L, int C) {
  __shared__ float prefix[kMaxLinks * 12];
  for (int64_t t = blockIdx.x; t < T; t += gridDim.x) {
    chain_prefix(values ? values + t * L : host.v, params, joint_types, L, prefix);
    __syncwarp();
    float* o = out + t * C * 16;
    for (int e = threadIdx.x; e < C * 16; e += 32) {
      const int row = (e >> 2) & 3, col = e & 3;
      o[e] = row < 3 ? prefix[cloud_link[e >> 4] * 12 + row * 4 + col] : (col == 3 ? 1.0f : 0.0f);
    }
    __syncwarp();
  }
}

unsigned grid_of(int64_t blocks) { return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks); }

}  // namespace

extern "C" int gv_dh_fk_points(const void* values, const void* host_values, const void* params,
                               const void* joint_types, const void* cloud_link, const void* point_cloud,
                               const void* points, void* out, int64_t T, int L, int C, int64_t P, void* stream) {
  if (T <= 0 || P <= 0) return cudaGetLastError();
  HostValues host{};
  if (L < 1 || L > kMaxLinks || C < 1 || !host_state(values, host_values, T, L, &host)) return cudaErrorInvalidValue;
  const int64_t runs = (P + kThreads - 1) / kThreads;
  const int64_t total = T * runs;
  dh_fk_points_kernel<<<grid_of(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), host, static_cast<const float*>(params),
      static_cast<const int*>(joint_types),
      static_cast<const int*>(cloud_link), static_cast<const int*>(point_cloud), static_cast<const float*>(points),
      static_cast<float*>(out), L, P, runs, total);
  return cudaGetLastError();
}

extern "C" int gv_dh_chain(const void* values, const void* host_values, const void* params, const void* joint_types,
                           const void* cloud_link, void* out, int64_t T, int L, int C, void* stream) {
  if (T <= 0) return cudaGetLastError();
  HostValues host{};
  if (L < 1 || L > kMaxLinks || C < 1 || !host_state(values, host_values, T, L, &host)) return cudaErrorInvalidValue;
  dh_chain_kernel<<<grid_of(T), 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), host, static_cast<const float*>(params), static_cast<const int*>(joint_types),
      static_cast<const int*>(cloud_link), static_cast<float*>(out), T, L, C);
  return cudaGetLastError();
}

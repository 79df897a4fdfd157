// Bit x bit counting collide for Hopper (sm_90a): kernel K7.
//
// Replaces gpu_voxels_tpu/ops/collide_pallas.py:
//   K7 count_bit_bit (_count_bit_kernel)  -> gv_count_bit_bit
// Spec: gpu_voxels_tpu_torch/ops/collide.py count_bit_bit, which equals
// gpu_voxels_tpu/ops/collide.py count_bit_bit (dims and offset included).
//
// What it computes: two bit maps a, b are uint32[8, n], plane-major (plane p
// holds bits [32p, 32p + 32) of every voxel). Over the offset-sliced ranges
// a[:, a0 + i] and b[:, b0 + i], i in [0, len), the number of i where both
// 256-bit vectors are !noneButEmpty: the OR of the 8 words with bit 0 of
// plane 0 (eBVM_FREE) masked out is non-zero on both sides. The words are
// unsigned: the mask is 0xFFFFFFFE and the test is != 0.
//
// What bounds it on an H100: bytes. It reads 64 B per voxel pair and does 16
// ORs, 2 compares and an add: 1.07 GB at 256^3 (about 0.32 ms at the data
// sheet's 3.35 TB/s), 8.59 GB at 512^3 (about 2.56 ms). Design for that: one
// grid-stride pass that reads every word once, coalesced (consecutive
// threads, consecutive words of one plane), with all 16 loads of a step
// independent; the count stays in a register and each block does one
// 64-bit atomicAdd (block_reduce.cuh). Nothing is padded, copied or tiled:
// the ragged ends are masked in the kernel, and the kernel takes the base
// pointers with a0, b0 and len, because an offset view starts a0 (b0) words
// into EVERY plane.
//
// Alignment: plane p of a starts at word p * n + a0. When n is a multiple of
// 4 every plane of a map starts at the same address mod 16; when, besides,
// a + a0 and b + b0 share their address mod 16, the vector variant runs a
// scalar head up to the next 16-byte boundary, a uint4 body (4 voxels per
// thread and step) and a scalar tail. Otherwise (a ragged n, or offsets that
// differ mod 4) the launcher picks the scalar variant: 4-byte loads, still
// coalesced and still one pass.
//
// The launcher zeroes the count on the stream, returns cudaGetLastError(),
// and never synchronises; the caller raises on non-zero.

#include <cuda_runtime.h>

#include <cstdint>

#include "block_reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPlanes = 8;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks' worth per SM; the rest loop
constexpr uint32_t kOccMask = 0xFFFFFFFEu;  // plane 0 without eBVM_FREE

// 1 iff voxel ia of a and voxel ib of b are both !noneButEmpty
__device__ __forceinline__ unsigned int one(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                            int64_t n, int64_t ia, int64_t ib) {
  uint32_t fa = a[ia] & kOccMask;
  uint32_t fb = b[ib] & kOccMask;
#pragma unroll
  for (int p = 1; p < kPlanes; ++p) {
    fa |= a[p * n + ia];
    fb |= b[p * n + ib];
  }
  return (fa != 0u) & (fb != 0u);
}

__device__ __forceinline__ uint4 or4(uint4 x, uint4 y) {
  return make_uint4(x.x | y.x, x.y | y.y, x.z | y.z, x.w | y.w);
}

// Vector variant: n % 4 == 0 and a + a0 + head, b + b0 + head are 16-byte
// aligned, so every plane's slice is too.
__global__ void __launch_bounds__(kThreads)
count_bits_vec_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, int64_t n,
                      int64_t a0, int64_t b0, int64_t head, int64_t nvec, int64_t len,
                      unsigned long long* __restrict__ count) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  unsigned int c = 0;
  // scalar head [0, head) and tail [head + 4 * nvec, len): fewer than 4 each
  const int64_t tail = head + 4 * nvec;
  if (tid < head) c += one(a, b, n, a0 + tid, b0 + tid);
  if (tail + tid < len) c += one(a, b, n, a0 + tail + tid, b0 + tail + tid);

  const uint32_t* pa = a + a0 + head;
  const uint32_t* pb = b + b0 + head;
  for (int64_t j = tid; j < nvec; j += stride) {
    uint4 wa[kPlanes], wb[kPlanes];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      wa[p] = reinterpret_cast<const uint4*>(pa + p * n)[j];
      wb[p] = reinterpret_cast<const uint4*>(pb + p * n)[j];
    }
    uint4 fa = make_uint4(wa[0].x & kOccMask, wa[0].y & kOccMask, wa[0].z & kOccMask, wa[0].w & kOccMask);
    uint4 fb = make_uint4(wb[0].x & kOccMask, wb[0].y & kOccMask, wb[0].z & kOccMask, wb[0].w & kOccMask);
#pragma unroll
    for (int p = 1; p < kPlanes; ++p) {
      fa = or4(fa, wa[p]);
      fb = or4(fb, wb[p]);
    }
    c += ((fa.x != 0u) & (fb.x != 0u)) + ((fa.y != 0u) & (fb.y != 0u)) +
         ((fa.z != 0u) & (fb.z != 0u)) + ((fa.w != 0u) & (fb.w != 0u));
  }
  block_add<kThreads>(c, count);
}

// Scalar variant: any n, any pair of offsets.
__global__ void __launch_bounds__(kThreads)
count_bits_scalar_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, int64_t n,
                         int64_t a0, int64_t b0, int64_t len, unsigned long long* __restrict__ count) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  unsigned int c = 0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < len; i += stride)
    c += one(a, b, n, a0 + i, b0 + i);
  block_add<kThreads>(c, count);
}

int blocks_for(int64_t work) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

}  // namespace

// K7: *count = #{i < len : occupied(a[:, a0 + i]) && occupied(b[:, b0 + i])};
// a and b are uint32[8, n], count is one int64. The caller guarantees
// 0 <= a0, b0 and a0 + len <= n, b0 + len <= n.
extern "C" int gv_count_bit_bit(const void* a, const void* b, int64_t n, int64_t a0, int64_t b0,
                                int64_t len, void* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return err;
  if (len > 0) {
    if (a0 < 0 || b0 < 0 || a0 + len > n || b0 + len > n) return cudaErrorInvalidValue;
    const uint32_t* pa = static_cast<const uint32_t*>(a);
    const uint32_t* pb = static_cast<const uint32_t*>(b);
    unsigned long long* pc = static_cast<unsigned long long*>(count);
    const uintptr_t xa = reinterpret_cast<uintptr_t>(pa + a0);
    const uintptr_t xb = reinterpret_cast<uintptr_t>(pb + b0);
    const bool same_phase = n % 4 == 0 && ((xa ^ xb) & 15u) == 0;
    const int64_t head = static_cast<int64_t>(((16u - (xa & 15u)) & 15u) / 4u);
    if (same_phase && len >= head + 4) {
      const int64_t nvec = (len - head) / 4;
      count_bits_vec_kernel<<<blocks_for(nvec), kThreads, 0, s>>>(pa, pb, n, a0, b0, head, nvec, len, pc);
    } else {
      count_bits_scalar_kernel<<<blocks_for(len), kThreads, 0, s>>>(pa, pb, n, a0, b0, len, pc);
    }
  }
  return cudaGetLastError();
}

// Prob x prob collision sweeps for Hopper (sm_90a): kernels K1 and K2.
//
// Replaces gpu_voxels_tpu/ops/collide_pallas.py:
//   K1 count_prob_prob     (_count_prob_kernel)       -> gv_count_prob_prob
//   K2 count_and_mark_prob (_count_mark_prob_kernel)  -> gv_count_and_mark_prob
// Spec: gpu_voxels_tpu_torch/ops/collide.py (count_prob_prob,
// count_and_mark_prob), which equals gpu_voxels_tpu/ops/collide.py.
//
// What it computes: over two int8 log-odds slices a[0, len), b[0, len) (the
// offset-sliced flat maps), the number of i with a[i] >= t1 && b[i] >= t2,
// compared in int; K2 also writes out = a with 127 at every hit.
//
// What bounds it on an H100: bytes. There is one compare per byte, so the
// sweep is a pure stream: K1 reads 2 bytes per voxel (268 MB at 512^3, a
// floor of about 80 us at the data sheet's 3.35 TB/s), K2 also writes 1
// (402 MB, about 120 us). Design for that: one grid-stride pass with 16-byte
// loads (uint4, 16 voxels per load), the count kept per thread in a
// register, reduced per warp by shuffles and per block in shared memory, and
// ONE 64-bit atomicAdd per block (block_reduce.cuh). An integer sum is exact
// in any order, so the count is deterministic. The ragged edges are masked in
// the kernel; nothing is padded or copied.
//
// Alignment: with an offset, a + sa and b + sb start at arbitrary byte
// addresses, not necessarily misaligned by the same amount. When a, b (and
// out for K2) share their address mod 16, the kernel runs a scalar head up to
// the next 16-byte boundary, the vector body, and a scalar tail; otherwise
// the launcher picks the scalar variant (1 byte per thread per step), which
// is slower but still one pass.
//
// Each launcher returns cudaGetLastError(); the caller raises on non-zero.
// Launches go on the caller's stream and never synchronise.

#include <cuda_runtime.h>

#include <cstdint>

#include "block_reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks' worth per SM
constexpr int8_t kCollision = 127;   // MAX_PROBABILITY: eBVM_COLLISION mark

template <bool MARK>
__device__ __forceinline__ unsigned int one(const int8_t* a, const int8_t* b, int8_t* out,
                                            int64_t i, int t1, int t2) {
  const int8_t va = a[i];
  const bool hit = (static_cast<int>(va) >= t1) & (static_cast<int>(b[i]) >= t2);
  if (MARK) out[i] = hit ? kCollision : va;
  return hit;
}

// Vector variant: a, b (and out) are 16-byte aligned at a + head.
template <bool MARK>
__global__ void __launch_bounds__(kThreads)
count_vec_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                 int8_t* __restrict__ out, int64_t head, int64_t nvec, int64_t n,
                 int t1, int t2, unsigned long long* __restrict__ count) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  unsigned int c = 0;
  // scalar head [0, head) and tail [head + 16 * nvec, n): fewer than 16 each
  const int64_t tail = head + 16 * nvec;
  if (tid < head) c += one<MARK>(a, b, out, tid, t1, t2);
  if (tail + tid < n) c += one<MARK>(a, b, out, tail + tid, t1, t2);

  const uint4* va4 = reinterpret_cast<const uint4*>(a + head);
  const uint4* vb4 = reinterpret_cast<const uint4*>(b + head);
  uint4* vo4 = MARK ? reinterpret_cast<uint4*>(out + head) : nullptr;
  for (int64_t j = tid; j < nvec; j += stride) {
    const uint4 wa = va4[j];
    const uint4 wb = vb4[j];
    const int8_t* ea = reinterpret_cast<const int8_t*>(&wa);
    const int8_t* eb = reinterpret_cast<const int8_t*>(&wb);
    uint4 wo;
    int8_t* eo = reinterpret_cast<int8_t*>(&wo);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const bool hit = (static_cast<int>(ea[k]) >= t1) & (static_cast<int>(eb[k]) >= t2);
      c += hit;
      if (MARK) eo[k] = hit ? kCollision : ea[k];
    }
    if (MARK) vo4[j] = wo;
  }
  block_add<kThreads>(c, count);
}

// Scalar variant for views whose addresses differ mod 16.
template <bool MARK>
__global__ void __launch_bounds__(kThreads)
count_scalar_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                    int8_t* __restrict__ out, int64_t n, int t1, int t2,
                    unsigned long long* __restrict__ count) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  unsigned int c = 0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride)
    c += one<MARK>(a, b, out, i, t1, t2);
  block_add<kThreads>(c, count);
}

int blocks_for(int64_t work) {
  const int64_t b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

template <bool MARK>
void launch(const int8_t* a, const int8_t* b, int8_t* out, int64_t n, int t1, int t2,
            unsigned long long* count, cudaStream_t stream) {
  const uintptr_t pa = reinterpret_cast<uintptr_t>(a);
  const uintptr_t pb = reinterpret_cast<uintptr_t>(b);
  const uintptr_t po = reinterpret_cast<uintptr_t>(out);
  const bool same_phase = ((pa ^ pb) & 15u) == 0 && (!MARK || ((pa ^ po) & 15u) == 0);
  const int64_t head = static_cast<int64_t>((16u - (pa & 15u)) & 15u);
  if (same_phase && n >= head + 16) {
    const int64_t nvec = (n - head) / 16;
    count_vec_kernel<MARK><<<blocks_for(nvec), kThreads, 0, stream>>>(
        a, b, out, head, nvec, n, t1, t2, count);
  } else {
    count_scalar_kernel<MARK><<<blocks_for(n), kThreads, 0, stream>>>(a, b, out, n, t1, t2, count);
  }
}

}  // namespace

// K1: *count = #{i < n : a[i] >= t1 && b[i] >= t2}; count is one int64.
extern "C" int gv_count_prob_prob(const void* a, const void* b, int64_t n, int t1, int t2,
                                  void* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return err;
  if (n > 0)
    launch<false>(static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), nullptr, n, t1,
                  t2, static_cast<unsigned long long*>(count), s);
  return cudaGetLastError();
}

// K2: K1's count over a[a_start, a_start + len) x b[0, len), plus the full
// marked map: out = a, with 127 at every hit inside the slice.
extern "C" int gv_count_and_mark_prob(const void* a, const void* b, void* out, int64_t n_total,
                                      int64_t a_start, int64_t len, int t1, int t2, void* count,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* pa = static_cast<const int8_t*>(a);
  int8_t* po = static_cast<int8_t*>(out);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return err;
  // voxels outside the slice (|offset| of them) are copied unchanged
  if (a_start > 0) {
    err = cudaMemcpyAsync(po, pa, a_start, cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return err;
  }
  const int64_t rest = n_total - a_start - len;
  if (rest > 0) {
    err = cudaMemcpyAsync(po + a_start + len, pa + a_start + len, rest, cudaMemcpyDeviceToDevice, s);
    if (err != cudaSuccess) return err;
  }
  if (len > 0)
    launch<true>(pa + a_start, static_cast<const int8_t*>(b), po + a_start, len, t1, t2,
                 static_cast<unsigned long long*>(count), s);
  return cudaGetLastError();
}

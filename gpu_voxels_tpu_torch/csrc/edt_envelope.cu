// Min-plus lower envelope for Hopper (sm_90a): kernel K5, the exact EDT's
// per-axis pass.
//
// Replaces gpu_voxels_tpu/ops/edt_envelope.py
//   envelope_pass (_envelope_kernel) -> gv_envelope_pass
// Spec: gpu_voxels_tpu_torch/ops/edt_envelope.py envelope_plain, the port
// of the reference's _envelope_xla.
//
// What it computes: for a grid laid out [A, n, C] (element (a, q, c) at
// (a * n + q) * C + c), along each line (a, :, c),
//   out[a, y, c] = min_q (y - q)^2 + g[a, q, c]
// and the winner's payload. A candidate with g >= MISS (2^27) is no site;
// ties go to the smallest q; an output with no candidate below MISS is MISS
// with payload PBA_UNINITIALISED_PACKED. The Y pass of a [dz, dy, dx] grid
// is (A, n, C) = (dz, dy, dx); the X pass is (dz * dy, dx, 1): both read the
// grid in place, so no transposes are needed. All values are exact in int32:
// (y - q)^2 + g < 1023^2 + 2^27.
//
// Design: one thread per line runs the linear-time lower envelope of the
// line's parabolas (Felzenszwalb-Huttenlocher / Meijster) over its sites
// only, in integers. For sites i < j, i is no worse than j exactly at
// x <= S(i, j) = floor((j^2 - i^2 + g_j - g_i) / (2 (j - i))), so a new site j
// takes over from S + 1 and pops the top while S + 1 <= the top's start;
// ties thus stay with the smaller q at every x, as in the spec (the first
// minimiser is non-decreasing in x, so the envelope's segments are ordered
// by site). The work per line is O(n) whatever the scene, where a search
// outward from each voxel costs O(distance) per voxel (this kernel's first
// form: 25 ms for the Y pass at 512^3 with 20,000 obstacles, ~82 rows per
// voxel). A block is one warp and 32 lines: it stages their g values in
// shared memory (coalesced: rows of 32 columns in the Y pass, runs of one
// line in the X pass; the line stride is odd, so the lanes' reads of one
// position hit 32 banks), each lane builds its stack of (site, start, g) in
// local memory, and the outputs go back through the same shared buffer, so
// the global writes are coalesced too. The payload is read once per segment
// of the envelope.
//
// What bounds it on an H100: 16 B per voxel and pass (g and the payload read
// once, both outputs written once): 2.15 GB, 0.64 ms at 512^3 and 3.35 TB/s.
// One warp per block and 32 * n * 4 bytes of shared memory per block leave
// few warps per SM, so the sequential per-line loop is latency-bound.
//
// The launcher returns cudaGetLastError(); the caller raises on non-zero.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kLines = 32;   // lines per block: one warp, one lane per line
constexpr int kMaxN = 1024;  // packed coordinates have 10 bits
constexpr int kMiss = 1 << 27;
constexpr int kUninitPacked = (1 << 30) - 1;  // x = y = z = 1023

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int64_t line_base(int64_t ln, int n, int C) {  // element (a, 0, c)
  return C == 1 ? ln * n : (ln / C) * n * C + ln % C;
}

// The block's lines between global memory and the shared buffer (line l at
// s[l * stride]). C == 1: each line is contiguous, the warp moves runs of
// one line; C > 1: the lines are columns, the warp moves rows of 32 columns.
template <bool kToShared>
__device__ __forceinline__ void move_lines(int* s, int stride, const int* src, int* dst, int64_t line0,
                                           int lines, int n, int C) {
  const int lane = threadIdx.x;
  if (C == 1) {
    for (int l = 0; l < lines; ++l) {
      const int64_t base = (line0 + l) * n;
      for (int q = lane; q < n; q += kLines) {
        if (kToShared) s[l * stride + q] = __ldg(src + base + q);
        else dst[base + q] = s[l * stride + q];
      }
    }
  } else if (lane < lines) {
    const int64_t base = line_base(line0 + lane, n, C);
    for (int q = 0; q < n; ++q) {
      const int64_t at = base + static_cast<int64_t>(q) * C;
      if (kToShared) s[lane * stride + q] = __ldg(src + at);
      else dst[at] = s[lane * stride + q];
    }
  }
}

__global__ void __launch_bounds__(kLines)
envelope_kernel(const int* __restrict__ g, const int* __restrict__ pay, int* __restrict__ od,
                int* __restrict__ op, int64_t n_lines, int n, int C) {
  extern __shared__ int s[];
  const int stride = n | 1;  // odd: one position of the 32 lines spans 32 banks
  const int lane = threadIdx.x;
  const int64_t line0 = static_cast<int64_t>(blockIdx.x) * kLines;
  const int lines = static_cast<int>(min(static_cast<int64_t>(kLines), n_lines - line0));
  move_lines<true>(s, stride, g, nullptr, line0, lines, n, C);
  __syncwarp();

  // the lower envelope: entries (site | start << 16, g of the site)
  int2 stk[kMaxN];
  int top = -1;
  int* gs = s + lane * stride;
  if (lane < lines) {
    int tv = 0, tz = 0, tg = 0;  // the top entry
    for (int j = 0; j < n; ++j) {
      const int gj = gs[j];
      if (gj >= kMiss) continue;
      int sep = 0;
      while (top >= 0) {
        sep = floor_div(j * j - tv * tv + gj - tg, 2 * (j - tv));
        if (sep + 1 > tz) break;  // the top keeps [tz, sep]
        if (--top >= 0) {
          tv = stk[top].x & 0xFFFF;
          tz = stk[top].x >> 16;
          tg = stk[top].y;
        }
      }
      const int start = top < 0 ? 0 : sep + 1;
      if (start < n) {
        stk[++top] = make_int2(j | (start << 16), gj);
        tv = j;
        tz = start;
        tg = gj;
      }
    }
  }
  __syncwarp();  // every lane has read its g values: the buffer takes the outputs

  // distances, then payloads, each through the shared buffer
  for (int pass = 0; pass < 2; ++pass) {
    if (lane < lines) {
      const int64_t base = line_base(line0 + lane, n, C);
      int k = 0, v = 0, gv = kMiss, pv = kUninitPacked;
      int next = INT_MAX;  // where entry k + 1 starts
      if (top >= 0) {
        v = stk[0].x & 0xFFFF;
        gv = stk[0].y;
        if (pass) pv = __ldg(pay + base + static_cast<int64_t>(v) * C);
        next = top >= 1 ? stk[1].x >> 16 : INT_MAX;
      }
      for (int x = 0; x < n; ++x) {
        while (x >= next) {
          ++k;
          v = stk[k].x & 0xFFFF;
          gv = stk[k].y;
          if (pass) pv = __ldg(pay + base + static_cast<int64_t>(v) * C);
          next = k < top ? stk[k + 1].x >> 16 : INT_MAX;
        }
        const int d = (x - v) * (x - v) + gv;  // gv = MISS when the line has no site
        gs[x] = d < kMiss ? (pass ? pv : d) : (pass ? kUninitPacked : kMiss);
      }
    }
    __syncwarp();
    move_lines<false>(s, stride, nullptr, pass ? op : od, line0, lines, n, C);
    __syncwarp();
  }
}

}  // namespace

// The envelope along the middle axis of [A, n, C] int32 grids g and pay.
extern "C" int gv_envelope_pass(const void* g, const void* pay, void* od, void* op, int64_t A, int n,
                                int64_t C, void* stream) {
  if (A <= 0 || n <= 0 || C <= 0) return cudaGetLastError();
  if (n > kMaxN || C > INT_MAX) return cudaErrorInvalidValue;
  const int64_t n_lines = A * C;
  const int64_t blocks = (n_lines + kLines - 1) / kLines;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(kLines) * (n | 1) * sizeof(int);
  const cudaError_t err = cudaFuncSetAttribute(envelope_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  envelope_kernel<<<static_cast<unsigned>(blocks), kLines, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(g), static_cast<const int*>(pay), static_cast<int*>(od),
      static_cast<int*>(op), n_lines, n, static_cast<int>(C));
  return cudaGetLastError();
}

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
// What bounds it on an H100: 16 B per voxel and pass (g and the payload read
// once, both outputs written once): 2.15 GB, 0.64 ms at 512^3 and 3.35 TB/s.
// The arithmetic is a few tens of integer operations per position.
//
// The algorithm: one thread per line runs the linear-time lower envelope of
// the line's parabolas (Felzenszwalb-Huttenlocher / Meijster) over its sites
// only, in integers. For sites i < j, i is no worse than j exactly at
// x <= S(i, j) = floor(num / den), num = j^2 - i^2 + g_j - g_i,
// den = 2 (j - i) > 0, so a new site j takes over from S + 1 and pops the top
// (site i, start tz) while S + 1 <= tz. floor(num / den) >= tz is
// num >= tz * den (|num| < 2^28, tz * den < 2^21), so a pop costs a multiply
// and a compare; the one division left is the new entry's start, and there
// num >= 0. Starts grow strictly along the stack, so ties stay with the
// smaller q at every x, as in the spec, and the output is one walk over
// positions and stack together, from the last position down.
//
// What held the first form back (6.6 ms along Y and 11.3 ms along X at 512^3
// on an H100, ten and seventeen times the bound): a block was one warp that
// staged its 32 whole lines in shared memory, 65.7 KB at n = 512, so an SM
// held three warps (96 threads of 2,048); it moved its lines three times (g
// in, distances out, payloads out) with nothing else on the SM to hide a
// load's latency, walked the stack once per output, and every pop test was
// an integer division.
//
// What this form does: nothing is staged whole.
// - C > 1 (the Y pass): lane l of a warp owns column c0 + l, so the warp's
//   reads of one position are one 128-byte row, coalesced as they stand.
//   They do not depend on the stack, so each thread keeps kAhead rows in
//   flight in registers. The walk writes both outputs directly, and reads a
//   segment's payload one segment ahead. No shared memory; blocks of 4 warps.
// - C == 1 (the X pass): a warp's 32 lines are contiguous runs, streamed
//   through 32 x 33 int32 tiles: lane k copies g[line0 + l][32 t + k] for
//   l = 0..31 with cp.async (32 independent 128-byte rows in flight) into a
//   ring of two tiles, so tile t + 1 arrives while lane l consumes
//   tile[l][0..31] of tile t (stride 33: 32 banks). The outputs leave the
//   other way through the same two tiles: the walk writes a tile of
//   distances and a tile of winning sites, and the coalesced write-out
//   gathers each payload at its site (neighbouring positions have
//   neighbouring or equal sites, so the gathers share cache lines). 8,448 B
//   of shared memory per warp; ragged ends are masked.
//   TMA is not used: a tile is 32 separate 128-byte runs of 4-byte elements,
//   which cp.async moves without a descriptor per shape.
// With the stack work switched off both arms run at the byte bound, so what
// is left above it is the stack, which lives in local memory (8 B per
// position and thread, sized by n: 256, 512 or 1024 records; the card
// reserves that for every thread it can hold: 2,048 threads x 132 SMs x 4 KB
// = 1.1 GB at n <= 512, 2.2 GB at n <= 1024). Lanes at different depths
// scatter a push over as many 128-byte lines of it, so a warp lays its
// stacks out by how dense its lines are (see Entry).
// Occupancy on an H100 (cudaFuncGetAttributes and
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, through
// gv_envelope_occupancy; nvcc 12.9), at every n:
//   Y pass: 56 registers, no shared memory, 36 warps per SM;
//   X pass: 70 registers, 33,792 B of shared memory per block, 24 warps.
//
// The launcher returns cudaGetLastError(); the caller raises on non-zero.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 4;    // warps per block, one lane per line
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;    // positions per tile of the X pass
constexpr int kAhead = 8;    // rows in flight per thread in the Y pass
constexpr int kDenseShare = 4;  // a warp's lines are dense where 1 in 4 sampled positions holds a site
constexpr int kMaxN = 1024;  // packed coordinates have 10 bits
constexpr int kMiss = 1 << 27;
constexpr int kUninitPacked = (1 << 30) - 1;  // x = y = z = 1023

// The envelope under construction is a stack of entries (site, start, g of
// the site), kept as records rec[slot] = (start | link << 16, g) in local
// memory. How a warp lays its stacks out depends on what it sees of its
// lines:
// - dense lines (most lanes push at most positions): an entry's slot is its
//   site's position j, and link names the entry below (its site + 1; 0:
//   none). All lanes of a warp work on the same j at the same time, so a
//   push is a store at one index for the whole warp (two 128-byte lines of
//   local memory), where the lanes' different depths would scatter it over
//   up to 64 lines; and a record names the site below, so the walk can ask
//   for that site's payload while its record is still on the way.
// - sparse lines: an entry's slot is its depth on the stack, and link is its
//   site. A line's few entries then stay in a few lines that all lanes share
//   and L1 keeps, where positions would spread them over the whole array.
// The top entry is also in registers.
struct Entry {
  int v = -1;      // the site; -1: no entry
  int z = 0;       // its start
  int g = kMiss;   // its g: MISS where there is no entry
  int slot = -1;   // its record
  int below = -1;  // the record of the entry below; -1: none
};

template <bool kDense>
__device__ __forceinline__ Entry entry_at(const int2* rec, int slot) {
  const int2 r = rec[slot];
  Entry e;
  e.v = kDense ? slot : r.x >> 16;
  e.z = r.x & 0xFFFF;
  e.g = r.y;
  e.slot = slot;
  e.below = kDense ? (r.x >> 16) - 1 : slot - 1;
  return e;
}

// Site j with value gj < MISS joins the envelope of the sites before it.
template <bool kDense>
__device__ __forceinline__ void add_site(int2* rec, Entry& top, int j, int gj, int n) {
  int num = 0, den = 1;
  while (top.v >= 0) {
    num = (j - top.v) * (j + top.v) + gj - top.g;
    den = 2 * (j - top.v);
    if (num >= top.z * den) break;  // floor(num / den) + 1 > z: the top keeps [z, floor(num / den)]
    if (top.below >= 0) top = entry_at<kDense>(rec, top.below);
    else top = Entry();
  }
  // num >= z * den >= 0 where an entry is left
  const int start = top.v >= 0 ? static_cast<int>(static_cast<unsigned>(num) / static_cast<unsigned>(den)) + 1 : 0;
  if (start < n) {
    const int slot = kDense ? j : top.slot + 1;
    rec[slot] = make_int2(start | ((kDense ? top.slot + 1 : j) << 16), gj);
    top.below = top.slot;
    top.slot = slot;
    top.v = j;
    top.z = start;
    top.g = gj;
  }
}

// The walk over a finished envelope runs from the last position down, from
// the top entry along the stack, with the entry below read one segment
// ahead.
struct Walk {
  Entry at;     // the entry whose segment holds x
  Entry ahead;  // the entry below it, where there is one
};

template <bool kDense>
__device__ __forceinline__ Walk begin_walk(const int2* rec, const Entry& top) {
  Walk w;
  w.at = top;
  if (top.below >= 0) w.ahead = entry_at<kDense>(rec, top.below);
  return w;
}

// Moves to the entry below if x lies before the current start (starts grow
// strictly along the stack, so one step per position is enough); true if it
// moved.
template <bool kDense>
__device__ __forceinline__ bool descend(Walk& w, const int2* rec, int x) {
  if (x >= w.at.z) return false;
  w.at = w.ahead;
  if (w.at.below >= 0) w.ahead = entry_at<kDense>(rec, w.at.below);
  return true;
}

// One line of the Y pass: rows kAhead ahead in registers, the envelope, the
// outputs written directly.
template <bool kDense>
__device__ __forceinline__ void column(int2* rec, const int* __restrict__ g, const int* __restrict__ pay,
                                       int* __restrict__ od, int* __restrict__ op, int n, int64_t step,
                                       bool owner) {
  Entry top;
  int cur[kAhead], nxt[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) cur[u] = u < n ? __ldg(g + u * step) : kMiss;
  for (int j0 = 0; j0 < n; j0 += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {  // the next rows, before this group's stack work
      const int j = j0 + kAhead + u;
      nxt[u] = j < n ? __ldg(g + j * step) : kMiss;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (cur[u] < kMiss) add_site<kDense>(rec, top, j0 + u, cur[u], n);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) cur[u] = nxt[u];
  }

  Walk w = begin_walk<kDense>(rec, top);
  int pv = kUninitPacked, pv_ahead = kUninitPacked;  // payloads of the entry at x and of the one below
  if (w.at.v >= 0) pv = __ldg(pay + w.at.v * step);
  if (w.at.below >= 0) pv_ahead = __ldg(pay + w.ahead.v * step);
  for (int x = n - 1; x >= 0; --x) {
    if (descend<kDense>(w, rec, x)) {
      pv = pv_ahead;
      if (w.at.below >= 0) pv_ahead = __ldg(pay + w.ahead.v * step);
    }
    const int d = (x - w.at.v) * (x - w.at.v) + w.at.g;  // g = MISS when the line has no site
    const bool hit = d < kMiss;
    if (owner) {
      od[x * step] = hit ? d : kMiss;
      op[x * step] = hit ? pv : kUninitPacked;
    }
  }
}

// C > 1: the lines are columns; thread ln owns line (ln / C, :, ln % C).
template <int kStack>
__global__ void __launch_bounds__(kThreads)
envelope_columns_kernel(const int* __restrict__ g, const int* __restrict__ pay, int* __restrict__ od,
                        int* __restrict__ op, int64_t n_lines, int n, int C) {
  // a thread past the last line stays for the warp-wide counts, on the last line, and writes nothing
  const int64_t ln = min(static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x, n_lines - 1);
  const bool owner = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x < n_lines;
  const int64_t base = (ln / C) * n * C + ln % C;  // element (a, 0, c)
  const int64_t step = C;
  g += base;
  pay += base;
  od += base;
  op += base;

  // dense or sparse, by a sample of kAhead rows spread over the warp's lines
  int sites = 0;
#pragma unroll
  for (int u = 0; u < kAhead; ++u) sites += __ldg(g + (u * n / kAhead) * step) < kMiss;
  const bool dense = __reduce_add_sync(0xFFFFFFFFu, sites) * kDenseShare >= kAhead * 32;
  int2 rec[kStack];
  if (dense) column<true>(rec, g, pay, od, op, n, step, owner);
  else column<false>(rec, g, pay, od, op, n, step, owner);
}

__device__ __forceinline__ void cp_async4(int* shared, const int* global) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(global) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits until at most kPending of this thread's groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// C == 1: the lines are contiguous runs of n; a warp owns 32 of them.
template <int kStack>
__global__ void __launch_bounds__(kThreads)
envelope_rows_kernel(const int* __restrict__ g, const int* __restrict__ pay, int* __restrict__ od,
                     int* __restrict__ op, int64_t n_lines, int n, int /*C*/) {
  __shared__ int tiles[kWarps][2][kTile][kTile + 1];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t line0 = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kTile;
  if (line0 >= n_lines) return;  // the warps share nothing: no block-wide barrier below
  const int lines = static_cast<int>(min(static_cast<int64_t>(kTile), n_lines - line0));
  const int n_tiles = (n + kTile - 1) / kTile;
  int(*ring)[kTile][kTile + 1] = tiles[warp];
  g += line0 * n;
  pay += line0 * n;
  od += line0 * n;
  op += line0 * n;

  // lane k copies position 32 t + k of every line into tile t % 2
  auto fetch = [&](int t) {
    const int q = t * kTile + lane;
    if (t < n_tiles && q < n) {
#pragma unroll 8
      for (int l = 0; l < lines; ++l) cp_async4(&ring[t % 2][l][lane], g + static_cast<int64_t>(l) * n + q);
    }
    cp_async_commit();
  };

  int2 rec[kStack];
  Entry top;
  // the X pass reads the Y pass's output, where every position of a line
  // holds a site wherever its plane holds one: the dense layout
  constexpr bool kDense = true;
  fetch(0);
  for (int t = 0; t < n_tiles; ++t) {
    fetch(t + 1);
    cp_async_wait<1>();  // tile t has arrived
    __syncwarp();
    if (lane < lines) {
      const int* row = ring[t % 2][lane];
      const int width = min(kTile, n - t * kTile);
      for (int k = 0; k < width; ++k) {
        const int gj = row[k];
        if (gj < kMiss) add_site<kDense>(rec, top, t * kTile + k, gj, n);
      }
    }
    __syncwarp();  // tile t % 2 is free for tile t + 2
  }

  // the outputs, from the last tile down: a tile of distances and a tile of
  // winning sites (-1: none)
  int(*sd)[kTile + 1] = ring[0];
  int(*sv)[kTile + 1] = ring[1];
  Walk w = begin_walk<kDense>(rec, top);
  for (int t = n_tiles - 1; t >= 0; --t) {
    if (lane < lines) {
      for (int k = min(kTile, n - t * kTile) - 1; k >= 0; --k) {
        const int x = t * kTile + k;
        descend<kDense>(w, rec, x);
        const int d = (x - w.at.v) * (x - w.at.v) + w.at.g;  // g = MISS when the line has no site
        const bool hit = d < kMiss;
        sd[lane][k] = hit ? d : kMiss;
        sv[lane][k] = hit ? w.at.v : -1;
      }
    }
    __syncwarp();
    const int q = t * kTile + lane;
    if (q < n) {
#pragma unroll 8
      for (int l = 0; l < lines; ++l) {
        const int64_t at = static_cast<int64_t>(l) * n;
        const int v = sv[l][lane];
        od[at + q] = sd[l][lane];
        op[at + q] = v < 0 ? kUninitPacked : __ldg(pay + at + v);
      }
    }
    __syncwarp();
  }
}

using Kernel = void (*)(const int*, const int*, int*, int*, int64_t, int, int);

// The arm and the stack size for a pass.
Kernel kernel_for(int n, int64_t C) {
  if (C == 1) {
    return n <= 256 ? envelope_rows_kernel<256> : n <= 512 ? envelope_rows_kernel<512> : envelope_rows_kernel<1024>;
  }
  return n <= 256 ? envelope_columns_kernel<256>
                  : n <= 512 ? envelope_columns_kernel<512> : envelope_columns_kernel<1024>;
}

}  // namespace

// The envelope along the middle axis of [A, n, C] int32 grids g and pay.
extern "C" int gv_envelope_pass(const void* g, const void* pay, void* od, void* op, int64_t A, int n,
                                int64_t C, void* stream) {
  if (A <= 0 || n <= 0 || C <= 0) return cudaGetLastError();
  if (n > kMaxN || C > INT_MAX) return cudaErrorInvalidValue;
  const int64_t n_lines = A * C;
  // a thread per line; in the rows arm a warp's 32 lines may end ragged
  const int64_t blocks = C == 1 ? (n_lines + kTile * kWarps - 1) / (kTile * kWarps) : (n_lines + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel_for(n, C)<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(g), static_cast<const int*>(pay), static_cast<int*>(od),
      static_cast<int*>(op), n_lines, n, static_cast<int>(C));
  return cudaGetLastError();
}

// What the card holds of the kernel that a pass of line length n and inner
// extent C launches: out[0..4] = resident warps per SM, registers per
// thread, static shared bytes per block, local bytes per thread, threads
// per block.
extern "C" int gv_envelope_occupancy(int n, int64_t C, void* out) {
  if (n <= 0 || n > kMaxN || C <= 0) return cudaErrorInvalidValue;
  const Kernel kernel = kernel_for(n, C);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  int* o = static_cast<int*>(out);
  o[0] = blocks * kWarps;
  o[1] = attr.numRegs;
  o[2] = static_cast<int>(attr.sharedSizeBytes);
  o[3] = static_cast<int>(attr.localSizeBytes);
  o[4] = kThreads;
  return cudaSuccess;
}

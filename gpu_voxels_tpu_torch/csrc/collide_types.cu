// Swept-volume types collide for Hopper (sm_90a): kernel K4.
//
// Replaces gpu_voxels_tpu/ops/collide_pallas.py:
//   K4 collide_types_bit_bit (_types_kernel)  -> gv_collide_types_bit_bit
// Spec: gpu_voxels_tpu_torch/ops/collide.py collide_with_types_bit_bit at
// sv_offset 0, margin <= 24 (bitops.bit_margin_collision_check_packed),
// which equals gpu_voxels_tpu/ops/collide.py.
//
// What it computes: two bit maps a, b are uint32[8, n], plane-major (plane p
// holds bits [32p, 32p + 32) of every voxel). For each voxel i:
//   v2  = b[:, i] with bits 0..3 cleared (the non-SV nibble never matches),
//   win = OR over s in [-m, m] of v2 shifted by s bits across the 256-bit
//         vector (zero fill), rec = a[:, i] & win, hit = rec != 0.
// Outputs: the hit count (one int64), meanings[p] = OR over voxels of rec[p]
// (the colliding meanings; rec is zero where there is no hit), and with a
// mark a NEW map out = a with bit 2 of plane 0 (eBVM_COLLISION) set at hits.
// An optional b_valid (uint8[n]) makes column i of b all-zero where it is 0:
// the voxel lists' bit check passes its match mask so, with no partner
// payload built for it.
//
// Occupancy gating, as the TPU kernel's (collide_pallas.py:309-377) but per
// voxel: given both maps' summaries occ_a, occ_b (uint8[n], !noneButEmpty,
// i.e. eBVM_FREE left out), a voxel can hit only if it is LIVE:
//   occ_b[i] != 0 and (occ_a[i] != 0 or (m >= 4 and a[0, i] & 1)).
// The summary leaves out bit 0, and from m = 4 an SV bit of b shifted down
// reaches bit 0 of a (collide_pallas.py:336-347): such a voxel reads a's
// plane 0 word first. A summary may be conservative (1 where the voxel is
// empty); one that misses a set bit would drop hits.
//
// What bounds it on an H100: bytes, and what the data needs. Ungated it
// reads 64 B per voxel (1.07 GB at 256^3, about 0.32 ms at the data sheet's
// 3.35 TB/s); gated it reads the two summaries (2 B per voxel, 33.5 MB at
// 256^3, about 0.010 ms) and 64 B per live voxel only. A mark adds the copy:
// the new map is 32 B read and 32 B written per voxel whatever is live
// (about 0.33 ms at 256^3 with the summaries), as the reference's
// a_planes.at[0].set(...) copies too.
//
// Design. Without gates (no summaries, no mask) every voxel is read, one
// per thread and step in a grid-stride loop, all 16 words of a step
// independent and each load coalesced across the warp (dense_kernel). With
// gates a warp owns chunks of 512 voxels (gated_kernel). Each lane loads 16
// bytes of every gate it is given (one uint4, coalesced: a warp reads 512 B
// of each summary at once) and folds them into a 16-bit live mask; a warp
// with no live voxel in its chunk moves on with no plane load at all.
// Otherwise the chunk runs in 16 rounds of 32 voxels, one per lane, so each
// plane load is coalesced across the warp; a shuffle hands every lane its
// voxel's live bit, a ballot skips the rounds with none, and only live
// lanes load planes. Liveness is never read on the host: the grid is fixed
// by n. With a mark the two take different forms: gated, out already holds a
// copy of a (the caller's cudaMemcpyAsync, ~3 TB/s) and the kernel ORs
// eBVM_COLLISION into plane 0 at the hits only; ungated, the kernel writes
// every voxel's 8 words of out in the same pass. Each is the faster on its
// side on an H100 (PERF.md section 6 keeps the times of the other forms).
//
// One launch a call: no memset. Each block leaves its count and meanings in
// the workspace, the last block to finish (a ticket counter) reduces them
// into count and meanings and sets the ticket back to 0 for the next call
// on the stream. Integer sums and ORs are exact in any order, so every
// output is deterministic.
//
// The window is built by doubling, each direction on its own: w |= shift(w,
// step) with steps 1, 2, 4, ... covers offsets [0, m] in ceil(log2(m + 1))
// rounds. Only shifts of ONE sign are composed: an intermediate offset then
// always lies between the endpoints, so nothing clipped at the vector's ends
// is lost. Shifting a down-window back up would zero-fill bits below m that
// the spec keeps (the bug recorded at collide_pallas.py:220-226).
//
// The launcher returns cudaGetLastError(); the caller raises on non-zero.
// Launches go on the caller's stream and never synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPlanes = 8;
constexpr int kChunk = 512;              // voxels per warp and chunk: 16 per lane
constexpr int kMaxBlocks = 132 * 8;      // 8 blocks' worth per SM; the rest loop
constexpr uint32_t kSvMask = 0xFFFFFFF0u;
constexpr uint32_t kCollisionBit = 1u << 2;
constexpr unsigned kFull = 0xffffffffu;
// workspace (uint32 words): the ticket, a pad, then per block a 64-bit count
// and 8 meanings words
constexpr int64_t kWorkspaceWords = 2 + 2 * kMaxBlocks + kPlanes * kMaxBlocks;

struct Gates {
  const uint8_t* occ_a;  // both summaries or neither
  const uint8_t* occ_b;
  const uint8_t* b_valid;  // or null
  bool vec;                // every gate given starts on a 16-byte boundary
};

// out bit b = w bit (b + s), 0 < s < 32, zero fill at the top of the vector
__device__ __forceinline__ void or_shifted_down(uint32_t (&w)[kPlanes], int s) {
  uint32_t t[kPlanes];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) t[p] = __funnelshift_r(w[p], p + 1 < kPlanes ? w[p + 1] : 0u, s);
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) w[p] |= t[p];
}

// out bit b = w bit (b - s), 0 < s < 32, zero fill at the bottom
__device__ __forceinline__ void or_shifted_up(uint32_t (&w)[kPlanes], int s) {
  uint32_t t[kPlanes];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) t[p] = __funnelshift_l(p > 0 ? w[p - 1] : 0u, w[p], s);
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) w[p] |= t[p];
}

// bit k set iff byte g + k of p is non-zero, k < 16; bytes at or past n read 0.
// g is a multiple of 16, so with vec the uint4 load is aligned.
__device__ __forceinline__ uint32_t nonzero16(const uint8_t* __restrict__ p, int64_t g, int64_t n, bool vec) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (vec && g + 16 <= n) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + g));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else {
    for (int k = 0; k < 16 && g + k < n; ++k) w[k >> 2] |= static_cast<uint32_t>(p[g + k]) << (8 * (k & 3));
  }
  uint32_t m = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t nz = __vcmpne4(w[k], 0u);  // 0xff in every non-zero byte
    m |= (((nz >> 7) & 1u) | ((nz >> 14) & 2u) | ((nz >> 21) & 4u) | ((nz >> 28) & 8u)) << (4 * k);
  }
  return m;
}

// rec = a & window(b) for one voxel whose 8 words of a are in va; returns hit
__device__ __forceinline__ bool record(const uint32_t (&va)[kPlanes], const uint32_t* __restrict__ b, int64_t n,
                                       int64_t i, int margin, uint32_t (&macc)[kPlanes]) {
  uint32_t down[kPlanes], up[kPlanes];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) down[p] = b[p * n + i];
  down[0] &= kSvMask;
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) up[p] = down[p];
  for (int covered = 1; covered < margin + 1;) {
    const int step = min(covered, margin + 1 - covered);
    or_shifted_down(down, step);
    or_shifted_up(up, step);
    covered += step;
  }
  uint32_t any = 0u;
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    const uint32_t rec = va[p] & (down[p] | up[p]);
    macc[p] |= rec;
    any |= rec;
  }
  return any != 0u;
}

// The block's count and meanings into the workspace; the last block reduces
// all of them into count and meanings and resets the ticket.
__device__ void finish(unsigned int c, uint32_t (&macc)[kPlanes], uint32_t* __restrict__ ws,
                       unsigned long long* __restrict__ count, uint32_t* __restrict__ meanings) {
  __shared__ unsigned long long warp_count[kWarps];
  __shared__ uint32_t warp_meanings[kWarps][kPlanes];
  __shared__ bool last;
  unsigned int* ticket = ws;
  unsigned long long* block_count = reinterpret_cast<unsigned long long*>(ws + 2);
  uint32_t* block_meanings = ws + 2 + 2 * kMaxBlocks;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  unsigned long long s = c;
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(kFull, s, o);
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) macc[p] = __reduce_or_sync(kFull, macc[p]);
  if (lane == 0) {
    warp_count[warp] = s;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) warp_meanings[warp][p] = macc[p];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t = 0;
    uint32_t m[kPlanes] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    for (int w = 0; w < kWarps; ++w) {
      t += warp_count[w];
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) m[p] |= warp_meanings[w][p];
    }
    block_count[blockIdx.x] = t;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) block_meanings[blockIdx.x * kPlanes + p] = m[p];
    __threadfence();  // the partials are visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  __threadfence();
  unsigned long long t = 0;
  uint32_t m[kPlanes] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
  for (int k = threadIdx.x; k < gridDim.x; k += kThreads) {
    t += __ldcg(block_count + k);
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) m[p] |= __ldcg(block_meanings + k * kPlanes + p);
  }
  for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(kFull, t, o);
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) m[p] = __reduce_or_sync(kFull, m[p]);
  __syncthreads();  // the block's own partials above are read; reuse the arrays
  if (lane == 0) {
    warp_count[warp] = t;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) warp_meanings[warp][p] = m[p];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_count[w];
    *count = total;
    *ticket = 0u;
  } else if (threadIdx.x >= 32 && threadIdx.x < 32 + kPlanes) {
    const int p = threadIdx.x - 32;
    uint32_t v = 0u;
    for (int w = 0; w < kWarps; ++w) v |= warp_meanings[w][p];
    meanings[p] = v;
  }
}

// Ungated: one voxel per thread and step, all 16 words loaded at once; a
// mark writes the whole new map.
template <bool MARK>
__global__ void __launch_bounds__(kThreads)
dense_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
             int64_t n, int margin, uint32_t* __restrict__ ws, unsigned long long* __restrict__ count,
             uint32_t* __restrict__ meanings) {
  uint32_t macc[kPlanes];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) macc[p] = 0u;
  unsigned int c = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    uint32_t va[kPlanes];
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) va[p] = a[p * n + i];
    const bool hit = record(va, b, n, i, margin, macc);
    c += hit;
    if (MARK) {
      out[i] = hit ? (va[0] | kCollisionBit) : va[0];
#pragma unroll
      for (int p = 1; p < kPlanes; ++p) out[p * n + i] = va[p];
    }
  }
  finish(c, macc, ws, count, meanings);
}

// Gated: a warp per 512-voxel chunk, planes loaded for the live voxels only;
// a mark sets the hits' bit in out, which already holds a's copy.
template <bool MARK>
__global__ void __launch_bounds__(kThreads)
gated_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
             int64_t n, int margin, Gates gates, uint32_t* __restrict__ ws,
             unsigned long long* __restrict__ count, uint32_t* __restrict__ meanings) {
  uint32_t macc[kPlanes];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) macc[p] = 0u;
  unsigned int c = 0;
  const int lane = threadIdx.x & 31;
  const bool hazard = margin >= 4;
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;

  for (int64_t ch = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5); ch < chunks; ch += warps) {
    const int64_t base = ch * kChunk;
    const int64_t g = base + 16 * lane;
    // bits 0..15: live candidates among voxels g .. g + 15; bits 16..31: the
    // candidates that are live only if a's bit 0 is set
    uint32_t live = g + 16 <= n ? 0xffffu : (g < n ? (1u << (n - g)) - 1u : 0u);
    uint32_t free_only = 0u;
    if (gates.occ_a != nullptr) {
      const uint32_t oa = nonzero16(gates.occ_a, g, n, gates.vec);
      live &= nonzero16(gates.occ_b, g, n, gates.vec) & (hazard ? 0xffffu : oa);
      free_only = ~oa;
    }
    if (gates.b_valid != nullptr) live &= nonzero16(gates.b_valid, g, n, gates.vec);
    if (!__any_sync(kFull, live != 0u)) continue;  // a dead chunk: no plane load
    const uint32_t bits = live | ((live & free_only) << 16);

#pragma unroll 1
    for (int r = 0; r < kChunk / 32; ++r) {
      const uint32_t src = __shfl_sync(kFull, bits, 2 * r + (lane >> 4));
      const int k = lane & 15;
      const bool on = (src >> k) & 1u;
      const bool check_free = (src >> (16 + k)) & 1u;
      if (!__any_sync(kFull, on)) continue;  // a dead round
      if (!on) continue;
      const int64_t i = base + 32 * r + lane;
      uint32_t va[kPlanes];
      va[0] = a[i];
      if (check_free && !(va[0] & 1u)) continue;
#pragma unroll
      for (int p = 1; p < kPlanes; ++p) va[p] = a[p * n + i];
      if (record(va, b, n, i, margin, macc)) {
        ++c;
        if (MARK) out[i] = va[0] | kCollisionBit;
      }
    }
  }
  finish(c, macc, ws, count, meanings);
}

int blocks_for(int64_t n, int64_t per_block) {
  const int64_t b = (n + per_block - 1) / per_block;
  return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

template <bool MARK>
void launch(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n, int margin, const Gates& gates,
            uint32_t* ws, unsigned long long* count, uint32_t* meanings, cudaStream_t s) {
  if (gates.occ_a != nullptr || gates.b_valid != nullptr)
    gated_kernel<MARK><<<blocks_for(n, kChunk * kWarps), kThreads, 0, s>>>(a, b, out, n, margin, gates, ws, count,
                                                                        meanings);
  else
    dense_kernel<MARK><<<blocks_for(n, kThreads), kThreads, 0, s>>>(a, b, out, n, margin, ws, count, meanings);
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// K4: count (one int64), meanings (uint32[8]) and, when out is not null, the
// marked map out (uint32[8, n], never aliasing a). occ_a and occ_b (uint8[n])
// gate it when both are given; b_valid (uint8[n]) zeroes b's columns where it
// is 0. Gated (summaries or b_valid given), out must already hold a copy of
// a; ungated, the kernel writes all of it. 0 <= margin <= 24. ws is the
// stream's workspace of ws_words uint32 words, zero before its first use;
// every call leaves it so.
extern "C" int gv_collide_types_bit_bit(const void* a, const void* b, void* out, int64_t n, int margin,
                                        const void* occ_a, const void* occ_b, const void* b_valid, void* ws,
                                        int64_t ws_words, void* count, void* meanings, void* stream) {
  if (margin < 0 || margin > 24 || (occ_a == nullptr) != (occ_b == nullptr) || ws_words < kWorkspaceWords || n < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Gates gates{static_cast<const uint8_t*>(occ_a), static_cast<const uint8_t*>(occ_b),
                    static_cast<const uint8_t*>(b_valid), aligned16(occ_a) && aligned16(occ_b) && aligned16(b_valid)};
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  uint32_t* pw = static_cast<uint32_t*>(ws);
  unsigned long long* pc = static_cast<unsigned long long*>(count);
  uint32_t* pm = static_cast<uint32_t*>(meanings);
  if (out == nullptr)
    launch<false>(pa, pb, nullptr, n, margin, gates, pw, pc, pm, s);
  else
    launch<true>(pa, pb, static_cast<uint32_t*>(out), n, margin, gates, pw, pc, pm, s);
  return cudaGetLastError();
}

// the workspace gv_collide_types_bit_bit needs, in uint32 words
extern "C" int gv_collide_types_workspace_words(void* out) {
  *static_cast<int64_t*>(out) = kWorkspaceWords;
  return 0;
}

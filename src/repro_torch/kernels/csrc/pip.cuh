// Shared device code of the crossing-number kernels (cascade.cu,
// gather_pip.cu, pip.cu): the per-edge crossing test, the warp sum, and
// the crossing count of one point against a run of edge-pool blocks
// (cascade.cu's walk).  bbox.cu and segment.cu use only its launch
// geometry (kWarp, kThreads, kWarpsPerBlock, warp_grid).
//
// Bit-equality with the numpy / XLA references rests on two rules:
//   * every product and difference rounds on its own (no FMA
//     contraction).  The build passes -fmad=false; the explicit _rn
//     intrinsics keep that true even if the flag is dropped;
//   * where a warp shares one point's edges (pool_crossings in
//     cascade.cu, one queued boundary point a warp; crossings_gathered
//     in pip.cu), every lane computes the point's scalar path
//     identically, so each branch below is warp-uniform and the
//     full-mask shuffles are safe.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;

// Half-open crossing rule of kernels/ref.py: edge (x1, y1)-(x2, y2) is
// crossed by the +x ray from (px, py) iff it straddles py and the
// intersection lies right of px (multiplication-only form).
__device__ __forceinline__ int crosses(float px, float py, float x1,
                                       float y1, float x2, float y2) {
  const bool straddle = (y1 > py) != (y2 > py);
  const float lhs = __fmul_rn(__fsub_rn(px, x1), __fsub_rn(y2, y1));
  const float rhs = __fmul_rn(__fsub_rn(py, y1), __fsub_rn(x2, x1));
  return (straddle && ((lhs < rhs) == (y2 > y1))) ? 1 : 0;
}

// Butterfly sum: every lane ends with the warp's total.
__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Crossings of (px, py) against edge-pool blocks first .. first+nblk-1.
// ``blocks`` is [NB, 4, BE] struct-of-arrays (x1 / y1 / x2 / y2 rows of
// BE edges each); the lanes stride over a block's BE edges, so a warp
// reads each row as contiguous 128-byte segments.
__device__ __forceinline__ int pool_crossings(
    const float* __restrict__ blocks, int be, int first, int nblk,
    float px, float py, int lane) {
  int acc = 0;
  for (int b = 0; b < nblk; ++b) {
    const float* blk = blocks + static_cast<int64_t>(first + b) * 4 * be;
    for (int e = lane; e < be; e += kWarp) {
      acc += crosses(px, py, blk[e], blk[be + e], blk[2 * be + e],
                     blk[3 * be + e]);
    }
  }
  return warp_sum(acc);
}

// Grid size for one warp per row.
inline unsigned warp_grid(int64_t rows) {
  return static_cast<unsigned>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace repro_torch

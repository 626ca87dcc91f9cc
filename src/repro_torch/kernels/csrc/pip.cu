// Crossing-number PIP over dense edge tables (port of
// src/repro/kernels/pip.py), natural layouts, no padding to tile
// multiples:
//
//   * crossings_gathered — each point against its own [E, 4] table
//     ([N, E, 4]; the Pallas kernel wanted [N, 4, E] for its lane axis).
//     One warp per row; lane j loads edge j as one 16-byte float4, so a
//     warp reads its row as one contiguous run, and the ragged tail of E
//     is masked by the loop bound.
//   * crossings_one — every point against one shared [E, 4] table.  One
//     thread per point; each block stages the table through shared
//     memory a tile at a time, so the table is read from device memory
//     once per block, and every thread runs the whole tile.
#include "pip.cuh"

namespace repro_torch {
namespace {

__global__ void __launch_bounds__(kThreads) crossings_gathered_kernel(
    const float* __restrict__ points, const float4* __restrict__ edges,
    int* __restrict__ out, int64_t rows, int e) {
  const int lane = threadIdx.x % kWarp;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (r >= rows) return;
  const float px = points[2 * r];
  const float py = points[2 * r + 1];
  const float4* row = edges + r * e;
  int acc = 0;
  for (int j = lane; j < e; j += kWarp) {
    const float4 q = row[j];
    acc += crosses(px, py, q.x, q.y, q.z, q.w);
  }
  acc = warp_sum(acc);
  if (lane == 0) out[r] = acc;
}

constexpr int kEdgeTile = kThreads;   // edges staged per tile

__global__ void __launch_bounds__(kThreads) crossings_one_kernel(
    const float2* __restrict__ points, const float4* __restrict__ edges,
    int* __restrict__ out, int64_t n, int e) {
  __shared__ float4 tile[kEdgeTile];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  // Threads past the end still stage their share of every tile.
  const float2 p = i < n ? points[i] : make_float2(0.f, 0.f);
  int acc = 0;
  for (int t0 = 0; t0 < e; t0 += kEdgeTile) {
    const int len = min(kEdgeTile, e - t0);
    __syncthreads();              // the previous tile is no longer read
    if (threadIdx.x < len) tile[threadIdx.x] = edges[t0 + threadIdx.x];
    __syncthreads();
    for (int k = 0; k < len; ++k) {
      const float4 q = tile[k];
      acc += crosses(p.x, p.y, q.x, q.y, q.z, q.w);
    }
  }
  if (i < n) out[i] = acc;
}

}  // namespace
}  // namespace repro_torch

extern "C" int repro_crossings_one(const void* points, const void* edges,
                                   void* out, int64_t n, int e,
                                   void* stream) {
  using namespace repro_torch;
  const unsigned grid = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  crossings_one_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(points), static_cast<const float4*>(edges),
      static_cast<int*>(out), n, e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_crossings_gathered(const void* points,
                                        const void* edges, void* out,
                                        int64_t rows, int e, void* stream) {
  using namespace repro_torch;
  crossings_gathered_kernel<<<warp_grid(rows), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float4*>(edges),
      static_cast<int*>(out), rows, e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// Bounding-box filter of the simple cascade (port of
// src/repro/kernels/bbox.py): open-interval membership of points in
// boxes (xmin, xmax, ymin, ymax).  Pure strict comparisons on f32, no
// arithmetic, so the results are exact: a NaN coordinate compares false
// everywhere, and an empty box (xmin > xmax) never matches.
//
//   * bbox_mask          — [N, M] int8 membership in one shared [M, 4]
//                          box table (the state level).  One thread per
//                          output byte, so consecutive threads write
//                          consecutive bytes of a point's row; the small
//                          box table is read through the read-only cache.
//   * bbox_count_select  — per point, over its own gathered [C, 4] boxes:
//                          the number of containing boxes and the largest
//                          containing slot (-1 if none).  One warp per
//                          point; lane j loads box j as one float4, so a
//                          warp reads its row contiguously; a ballot
//                          gives the containing set 32 slots at a time.
#include "pip.cuh"

namespace repro_torch {
namespace {

__device__ __forceinline__ bool in_box(float px, float py, float4 b) {
  return (px > b.x) && (px < b.y) && (py > b.z) && (py < b.w);
}

__global__ void __launch_bounds__(kThreads) bbox_mask_kernel(
    const float2* __restrict__ points, const float4* __restrict__ boxes,
    int8_t* __restrict__ out, int64_t total, int m) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < total; t += stride) {
    const int64_t i = t / m;
    const int j = static_cast<int>(t - i * m);
    const float2 p = __ldg(points + i);
    out[t] = in_box(p.x, p.y, __ldg(boxes + j)) ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kThreads) bbox_count_select_kernel(
    const float2* __restrict__ points, const float4* __restrict__ boxes,
    int* __restrict__ count, int* __restrict__ sel, int64_t rows, int c) {
  const int lane = threadIdx.x % kWarp;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (r >= rows) return;          // warp-uniform: r is the same on all lanes
  const float2 p = points[r];
  const float4* row = boxes + r * c;
  int cnt = 0;
  int best = -1;
  for (int base = 0; base < c; base += kWarp) {
    const int j = base + lane;
    const bool inside = j < c && in_box(p.x, p.y, row[j]);
    const unsigned m = __ballot_sync(0xffffffffu, inside);
    cnt += __popc(m);
    if (m) best = base + 31 - __clz(m);
  }
  if (lane == 0) {
    count[r] = cnt;
    sel[r] = best;
  }
}

// Grid for a grid-stride loop over ``total`` items: one item per thread
// up to a cap, so very large outputs loop instead of over-launching.
inline unsigned stride_grid(int64_t total) {
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < (1 << 20) ? blocks : (1 << 20));
}

}  // namespace
}  // namespace repro_torch

extern "C" int repro_bbox_mask(const void* points, const void* boxes,
                               void* out, int64_t n, int m, void* stream) {
  using namespace repro_torch;
  const int64_t total = n * m;
  bbox_mask_kernel<<<stride_grid(total), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(points), static_cast<const float4*>(boxes),
      static_cast<int8_t*>(out), total, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_bbox_count_select(const void* points, const void* boxes,
                                       void* count, void* sel, int64_t rows,
                                       int c, void* stream) {
  using namespace repro_torch;
  bbox_count_select_kernel<<<warp_grid(rows), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(points), static_cast<const float4*>(boxes),
      static_cast<int*>(count), static_cast<int*>(sel), rows, c);
  return static_cast<int>(cudaGetLastError());
}

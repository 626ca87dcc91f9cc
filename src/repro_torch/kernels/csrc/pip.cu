// Gathered-edge PIP (port of src/repro/kernels/pip.py::crossings_gathered):
// the crossing count of each point against its own dense edge table.
//
// Takes the natural [N, E, 4] layout (the Pallas kernel wanted [N, 4, E]
// for its lane axis).  One warp per row; lane j loads edge j as one
// 16-byte float4, so a warp reads its row as one contiguous run, and the
// ragged tail of E is masked by the loop bound (no padding to tile
// multiples).
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

}  // namespace
}  // namespace repro_torch

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

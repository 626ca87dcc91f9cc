// Candidate PIP over the blocked-CSR edge pool (port of
// src/repro/kernels/gather_pip.py::crossings_candidates): the crossing
// count of each point against its own candidate's pool blocks
// first[r] .. first[r]+nblk[r]-1.
//
// One warp per row, lanes over the block's BE edges, warp sum.  A row
// with nblk == 0 (no candidate) writes 0 without loading anything.  The
// caller runs rows in candidate-id order (core/resolve.py::_pip_ids), so
// neighbouring warps read the same pool blocks and L2 serves the repeats
// that the TPU kernel skipped by revisiting its VMEM block.
#include "pip.cuh"

namespace repro_torch {
namespace {

__global__ void __launch_bounds__(kThreads) crossings_candidates_kernel(
    const int* __restrict__ first, const int* __restrict__ nblk,
    const float* __restrict__ points, const float* __restrict__ blocks,
    int* __restrict__ out, int64_t rows, int be) {
  const int lane = threadIdx.x % kWarp;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (r >= rows) return;
  const int nb = nblk[r];
  int c = 0;
  if (nb > 0) {
    c = pool_crossings(blocks, be, first[r], nb, points[2 * r],
                       points[2 * r + 1], lane);
  }
  if (lane == 0) out[r] = c;
}

}  // namespace
}  // namespace repro_torch

extern "C" int repro_crossings_candidates(const void* first,
                                          const void* nblk,
                                          const void* points,
                                          const void* blocks, void* out,
                                          int64_t rows, int be,
                                          void* stream) {
  using namespace repro_torch;
  crossings_candidates_kernel<<<warp_grid(rows), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(first), static_cast<const int*>(nblk),
      static_cast<const float*>(points), static_cast<const float*>(blocks),
      static_cast<int*>(out), rows, be);
  return static_cast<int>(cudaGetLastError());
}

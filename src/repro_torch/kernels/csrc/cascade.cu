// One-pass cascade (port of src/repro/kernels/cascade.py::assign_cascade):
// quantize -> Morton code -> top-grid bucket -> fixed-iteration binary
// search over cell_lo -> interior block id, or, for a boundary cell, a
// bbox-gated walk over the K candidate slots with crossing counts over
// the candidate's edge-pool blocks.  First odd count wins; no match falls
// back to the slot-0 owner.
//
// One warp per point.  Every lane runs the scalar stages redundantly
// (the loads broadcast within the warp), so the boundary walk is
// warp-uniform and the 32 lanes share each candidate's BE-edge blocks.
// The TPU kernel's double-buffered DMA (_pip_dma) becomes plain global
// loads through L1/L2.
#include "pip.cuh"

namespace repro_torch {
namespace {

constexpr int kOutside = -(1 << 30);   // kernels/cascade.py OUTSIDE

__device__ __forceinline__ int part1by1(int x) {
  x &= 0x0000FFFF;
  x = (x | (x << 8)) & 0x00FF00FF;
  x = (x | (x << 4)) & 0x0F0F0F0F;
  x = (x | (x << 2)) & 0x33333333;
  x = (x | (x << 1)) & 0x55555555;
  return x;
}

// Grid coordinate of a quantized float.  The clamp comes before the
// cast: an off-extent, FAR (1e30), infinite or NaN coordinate maps into
// [0, nmax] (fmaxf returns 0 for NaN), so the bucket and cell_lo reads
// below stay in bounds.  Such a point has in_ext false, so its outputs
// do not depend on the value.  In-extent values are the same as the
// reference's cast-then-clip.
__device__ __forceinline__ int grid_coord(float f, float nmax) {
  return static_cast<int>(fminf(fmaxf(f, 0.0f), nmax));
}

__global__ void __launch_bounds__(kThreads) assign_cascade_kernel(
    const float* __restrict__ points, const float* __restrict__ quant,
    const int* __restrict__ cell_lo, const int* __restrict__ cell_hi,
    const int* __restrict__ cell_val, const int* __restrict__ top_start,
    const int* __restrict__ cand, const float* __restrict__ bbox,
    const int* __restrict__ first, const int* __restrict__ count,
    const float* __restrict__ blocks, int* __restrict__ bid_out,
    int* __restrict__ flags_out, int* __restrict__ nrest_out,
    int* __restrict__ nskip_out, int64_t n, int max_level, int gbits,
    int iters, int k, int n_cells, int n_brows, int n_poly, int be) {
  const int lane = threadIdx.x % kWarp;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (i >= n) return;
  const float px = points[2 * i];
  const float py = points[2 * i + 1];

  // -- stage 1: quantize + Morton ------------------------------------------
  const float span = static_cast<float>(1 << max_level);
  const float fx = __fmul_rn(__fsub_rn(px, quant[0]), quant[2]);
  const float fy = __fmul_rn(__fsub_rn(py, quant[1]), quant[3]);
  const bool in_ext = fx >= 0.0f && fx < span && fy >= 0.0f && fy < span;
  const float nmax = static_cast<float>((1 << max_level) - 1);
  const int code = (part1by1(grid_coord(fy, nmax)) << 1) |
                   part1by1(grid_coord(fx, nmax));

  // -- stage 2: bucket + fixed-iteration binary search ---------------------
  int l = 0;
  int h = n_cells;
  if (gbits > 0) {
    const int bucket = code >> (2 * (max_level - gbits));
    l = max(top_start[bucket] - 1, 0);
    h = top_start[bucket + 1];
  }
  for (int it = 0; it < iters; ++it) {
    const bool active = l < h;
    // l and h are never negative, so C's truncating division is the
    // reference's floor division (l + h) // 2.
    const int mid = (l + h) / 2;
    const bool go_right = cell_lo[min(max(mid, 0), n_cells - 1)] <= code;
    const int nl = (active && go_right) ? mid + 1 : l;
    const int nh = (active && !go_right) ? mid : h;
    l = nl;
    h = nh;
  }
  const int cidx = min(max(l - 1, 0), n_cells - 1);
  const bool in_cell =
      cell_lo[cidx] <= code && code <= cell_hi[cidx] && in_ext;
  const int v = in_cell ? cell_val[cidx] : kOutside;

  // -- stages 3+4: bbox filter + crossing counts over the K slots ----------
  const bool boundary = v < 0 && v > kOutside;
  int bid = v >= 0 ? v : -1;
  int nrest = 0;
  int nskip = 0;
  bool slot0_hit = false;
  if (boundary) {
    const int* row = cand + static_cast<int64_t>(
                                min(max(-(v + 1), 0), n_brows - 1)) * k;
    int best = -1;
    for (int s = 0; s < k; ++s) {
      const int pid = row[s];
      const bool valid = pid >= 0;
      if (s > 0) nrest += valid;
      const bool attempt = valid && best < 0;   // first match wins
      const int safe = min(max(pid, 0), n_poly - 1);
      const float* bb = bbox + static_cast<int64_t>(safe) * 4;
      const bool inb = px > bb[0] && px < bb[1] && py > bb[2] && py < bb[3];
      nskip += attempt && !inb;
      bool inside = false;
      if (attempt && inb) {
        inside = (pool_crossings(blocks, be, first[safe], count[safe], px,
                                 py, lane) & 1) == 1;
      }
      if (inside) best = pid;
      if (s == 0) slot0_hit = inside;
    }
    bid = best >= 0 ? best : (row[0] >= 0 ? row[0] : -1);
  }
  if (lane == 0) {
    bid_out[i] = bid;
    flags_out[i] = static_cast<int>(boundary) |
                   (static_cast<int>(slot0_hit) << 1);
    nrest_out[i] = nrest;
    nskip_out[i] = nskip;
  }
}

}  // namespace
}  // namespace repro_torch

extern "C" int repro_assign_cascade(
    const void* points, const void* quant, const void* cell_lo,
    const void* cell_hi, const void* cell_val, const void* top_start,
    const void* cand, const void* bbox, const void* first,
    const void* count, const void* blocks, void* bid, void* flags,
    void* nrest, void* nskip, int64_t n, int max_level, int gbits,
    int iters, int k, int n_cells, int n_brows, int n_poly, int be,
    void* stream) {
  using namespace repro_torch;
  assign_cascade_kernel<<<warp_grid(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float*>(quant),
      static_cast<const int*>(cell_lo), static_cast<const int*>(cell_hi),
      static_cast<const int*>(cell_val), static_cast<const int*>(top_start),
      static_cast<const int*>(cand), static_cast<const float*>(bbox),
      static_cast<const int*>(first), static_cast<const int*>(count),
      static_cast<const float*>(blocks), static_cast<int*>(bid),
      static_cast<int*>(flags), static_cast<int*>(nrest),
      static_cast<int*>(nskip), n, max_level, gbits, iters, k, n_cells,
      n_brows, n_poly, be);
  return static_cast<int>(cudaGetLastError());
}

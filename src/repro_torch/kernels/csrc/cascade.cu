// One-pass cascade (port of src/repro/kernels/cascade.py::assign_cascade):
// quantize -> Morton code -> top-grid bucket -> fixed-iteration binary
// search over cell_lo -> interior block id, or, for a boundary cell, a
// bbox-gated walk over the K candidate slots with crossing counts over
// the candidate's edge-pool blocks.  First odd count wins; no match falls
// back to the slot-0 owner.
//
// What bounds it on an H100: the point stream, 8 bytes in and 16 out per
// point through HBM (2^24 points: 0.4 GB, 0.12 ms at 3.35 TB/s); the
// cell tables and the pool are a few MB and stay in L2.  Most points are
// interior (85 % of the main path's), and their cost is the chain of
// dependent L2 reads of the bucket and the binary search: latency, which
// only many points in flight can hide.  Then the boundary points' edge
// tests: every candidate whose bbox holds the point reads its pool
// blocks, BE = 256 edges each, most of them zero padding when polygons
// are small.  The design:
//   * stage 1, one thread per point: a coalesced float2 load, the
//     quantize, the clamp-then-cast grid coordinate, the Morton code,
//     the bucket (top_start staged in shared memory when it is small)
//     and the search.  A block holds 256 points, so the card keeps
//     every resident thread's search in flight;
//   * interior, off-extent and no-cell points write their four outputs
//     at once, coalesced;
//   * boundary points go into a queue in shared memory (__ballot_sync,
//     __popc and one shared counter per block): point index, x, y and
//     candidate row;
//   * stage 2, after one __syncthreads: the block's 8 warps take the
//     queued points in turn, one warp per point, and run the slot walk
//     with the lanes striding over each pool block's BE edges
//     (pool_crossings, pip.cuh).  Every value the walk branches on is
//     the queued point's, so the walk is warp-uniform and the full-mask
//     shuffles are safe.  Lane 0 writes the point's outputs.
// The queue holds at most the block's 256 points, so it cannot overflow.
// The outputs are integers from the same arithmetic as the one-warp-per-
// point kernel before it, so they are bit-equal to it and to the twin.
#include "pip.cuh"

namespace repro_torch {
namespace {

constexpr int kOutside = -(1 << 30);   // kernels/cascade.py OUTSIDE
// top_start is staged in shared memory up to gbits = 6 (4,097 ints).
constexpr int kMaxSharedTop = (1 << 12) + 1;

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
    const float2* __restrict__ points, const float* __restrict__ quant,
    const int* __restrict__ cell_lo, const int* __restrict__ cell_hi,
    const int* __restrict__ cell_val, const int* __restrict__ top_start,
    const int* __restrict__ cand, const float* __restrict__ bbox,
    const int* __restrict__ first, const int* __restrict__ count,
    const float* __restrict__ blocks, int* __restrict__ bid_out,
    int* __restrict__ flags_out, int* __restrict__ nrest_out,
    int* __restrict__ nskip_out, int64_t n, int max_level, int gbits,
    int iters, int k, int n_cells, int n_brows, int n_poly, int be,
    int top_shared) {
  extern __shared__ int s_top[];           // [top_shared]
  __shared__ int q_idx[kThreads];          // the boundary queue
  __shared__ float q_px[kThreads];
  __shared__ float q_py[kThreads];
  __shared__ int q_row[kThreads];
  __shared__ int q_len;

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  for (int j = tid; j < top_shared; j += kThreads) s_top[j] = top_start[j];
  if (tid == 0) q_len = 0;
  __syncthreads();
  const int* top = top_shared ? s_top : top_start;

  // -- stage 1: one thread per point ---------------------------------------
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
  bool boundary = false;
  float px = 0.0f;
  float py = 0.0f;
  int v = kOutside;
  if (i < n) {
    const float2 pt = points[i];
    px = pt.x;
    py = pt.y;
    const float span = static_cast<float>(1 << max_level);
    const float fx = __fmul_rn(__fsub_rn(px, quant[0]), quant[2]);
    const float fy = __fmul_rn(__fsub_rn(py, quant[1]), quant[3]);
    const bool in_ext = fx >= 0.0f && fx < span && fy >= 0.0f && fy < span;
    const float nmax = static_cast<float>((1 << max_level) - 1);
    const int code = (part1by1(grid_coord(fy, nmax)) << 1) |
                     part1by1(grid_coord(fx, nmax));
    int l = 0;
    int h = n_cells;
    if (gbits > 0) {
      const int bucket = code >> (2 * (max_level - gbits));
      l = max(top[bucket] - 1, 0);
      h = top[bucket + 1];
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
    v = in_cell ? cell_val[cidx] : kOutside;
    boundary = v < 0 && v > kOutside;
    if (!boundary) {
      bid_out[i] = v >= 0 ? v : -1;
      flags_out[i] = 0;
      nrest_out[i] = 0;
      nskip_out[i] = 0;
    }
  }

  // -- the boundary queue --------------------------------------------------
  const unsigned ballot = __ballot_sync(0xffffffffu, boundary);
  int slot = 0;
  if (lane == 0 && ballot) slot = atomicAdd(&q_len, __popc(ballot));
  slot = __shfl_sync(0xffffffffu, slot, 0) +
         __popc(ballot & ((1u << lane) - 1u));
  if (boundary) {
    q_idx[slot] = static_cast<int>(i - static_cast<int64_t>(blockIdx.x) *
                                           kThreads);
    q_px[slot] = px;
    q_py[slot] = py;
    q_row[slot] = min(max(-(v + 1), 0), n_brows - 1);
  }
  __syncthreads();

  // -- stage 2: one warp per queued point: bbox filter + crossing counts ---
  const int n_queued = q_len;
  for (int qi = tid / kWarp; qi < n_queued; qi += kWarpsPerBlock) {
    const int64_t pi = static_cast<int64_t>(blockIdx.x) * kThreads + q_idx[qi];
    const float qx = q_px[qi];
    const float qy = q_py[qi];
    const int* row = cand + static_cast<int64_t>(q_row[qi]) * k;
    int best = -1;
    int nrest = 0;
    int nskip = 0;
    bool slot0_hit = false;
    for (int s = 0; s < k; ++s) {
      const int pid = row[s];
      const bool valid = pid >= 0;
      if (s > 0) nrest += valid;
      const bool attempt = valid && best < 0;   // first match wins
      const int safe = min(max(pid, 0), n_poly - 1);
      const float* bb = bbox + static_cast<int64_t>(safe) * 4;
      const bool inb = qx > bb[0] && qx < bb[1] && qy > bb[2] && qy < bb[3];
      nskip += attempt && !inb;
      bool inside = false;
      if (attempt && inb) {
        inside = (pool_crossings(blocks, be, first[safe], count[safe], qx,
                                 qy, lane) & 1) == 1;
      }
      if (inside) best = pid;
      if (s == 0) slot0_hit = inside;
    }
    if (lane == 0) {
      bid_out[pi] = best >= 0 ? best : (row[0] >= 0 ? row[0] : -1);
      flags_out[pi] = 1 | (static_cast<int>(slot0_hit) << 1);
      nrest_out[pi] = nrest;
      nskip_out[pi] = nskip;
    }
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
  const int top_n = gbits > 0 ? (1 << (2 * gbits)) + 1 : 0;
  const int top_shared = top_n <= kMaxSharedTop ? top_n : 0;
  const unsigned grid =
      static_cast<unsigned>((n + kThreads - 1) / kThreads);
  assign_cascade_kernel<<<grid, kThreads,
                          top_shared * static_cast<int>(sizeof(int)),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(points), static_cast<const float*>(quant),
      static_cast<const int*>(cell_lo), static_cast<const int*>(cell_hi),
      static_cast<const int*>(cell_val), static_cast<const int*>(top_start),
      static_cast<const int*>(cand), static_cast<const float*>(bbox),
      static_cast<const int*>(first), static_cast<const int*>(count),
      static_cast<const float*>(blocks), static_cast<int*>(bid),
      static_cast<int*>(flags), static_cast<int*>(nrest),
      static_cast<int*>(nskip), n, max_level, gbits, iters, k, n_cells,
      n_brows, n_poly, be, top_shared);
  return static_cast<int>(cudaGetLastError());
}

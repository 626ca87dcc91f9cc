// Crossing-number PIP over dense edge tables (port of
// src/repro/kernels/pip.py), natural layouts, no padding to tile
// multiples:
//
//   * crossings_gathered, replacing the Pallas crossings_gathered
//     (src/repro/kernels/pip.py:113): each point against its own [E, 4]
//     table ([N, E, 4]; the Pallas kernel wanted [N, 4, E] for its lane
//     axis).  Bound by reading the gathered table.  One warp per row;
//     lane j loads edge j as one 16-byte float4, so a warp reads its row
//     as one contiguous run, and the ragged tail of E is masked by the
//     loop bound.
//   * crossings_one, replacing the Pallas crossings_one
//     (src/repro/kernels/pip.py:86): every point against one shared
//     [E, 4] table.  Bound by the crossing tests: 6 fp32 operations each
//     against 12 bytes a point.  The earlier design (one point a thread,
//     every thread running crosses() on each raw edge of a staged tile)
//     spent ~15-20 instruction slots a test: it recomputed each edge's
//     y2 - y1, x2 - x1 and y2 > y1 for every point, and each shared-memory
//     load of an edge served one point.  Design: each block stages a tile
//     of the table in shared memory as precomputed terms (x1, y1, dx =
//     x2 - x1, dy = y2 - y1; y2 and up = y2 > y1), rounded by the same
//     IEEE operations crosses() performs, so a test is two subtractions,
//     two products, three compares and the logic; staging drops the
//     edges with y1 == y2 (they never straddle: bit-safe); and each
//     thread holds kOnePoints points in registers, so every shared-memory
//     load of an edge serves all of them.
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

constexpr int kOneTile = kThreads;   // edges staged per tile
constexpr int kOnePoints = 4;        // points a thread holds

// One staged edge: (x1, y1, dx, dy) and (y2, up ? 1 : 0).
struct OneTile {
  float4 a[kOneTile];
  float2 b[kOneTile];
  int warp_kept[kWarpsPerBlock];
};

__global__ void __launch_bounds__(kThreads) crossings_one_kernel(
    const float2* __restrict__ points, const float4* __restrict__ edges,
    int* __restrict__ out, int64_t n, int e) {
  __shared__ OneTile tile;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  // Point k of this thread is row base + k * kThreads: each of the
  // kOnePoints loads and stores is coalesced over the block.
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kThreads * kOnePoints + threadIdx.x;
  float px[kOnePoints], py[kOnePoints];
  int acc[kOnePoints];
#pragma unroll
  for (int k = 0; k < kOnePoints; ++k) {
    const int64_t i = base + static_cast<int64_t>(k) * kThreads;
    // Rows past the end compute on a dummy point and store nothing.
    const float2 p = i < n ? points[i] : make_float2(0.f, 0.f);
    px[k] = p.x;
    py[k] = p.y;
    acc[k] = 0;
  }
  for (int t0 = 0; t0 < e; t0 += kOneTile) {
    // Stage this tile's edges with y1 != y2, packed to the front in
    // order (a ballot and a prefix over the block's warps).
    const int j = t0 + threadIdx.x;
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    bool keep = false;
    if (j < e) {
      q = edges[j];
      keep = !(q.y == q.w);
    }
    const unsigned kept = __ballot_sync(0xffffffffu, keep);
    __syncthreads();              // the previous tile is no longer read
    if (lane == 0) tile.warp_kept[warp] = __popc(kept);
    __syncthreads();
    int slot = __popc(kept & ((1u << lane) - 1u));
    int len = 0;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) {
      const int c = tile.warp_kept[w];
      slot += w < warp ? c : 0;
      len += c;
    }
    if (keep) {
      tile.a[slot] = make_float4(q.x, q.y, __fsub_rn(q.z, q.x),
                                 __fsub_rn(q.w, q.y));
      tile.b[slot] = make_float2(q.w, q.w > q.y ? 1.f : 0.f);
    }
    __syncthreads();
    for (int s = 0; s < len; ++s) {
      const float4 a = tile.a[s];
      const float2 b = tile.b[s];
      const bool up = b.y != 0.f;
#pragma unroll
      for (int k = 0; k < kOnePoints; ++k) {
        // crosses() with the edge's own terms precomputed.
        const bool straddle = (a.y > py[k]) != (b.x > py[k]);
        const float lhs = __fmul_rn(__fsub_rn(px[k], a.x), a.w);
        const float rhs = __fmul_rn(__fsub_rn(py[k], a.y), a.z);
        acc[k] += (straddle && ((lhs < rhs) == up)) ? 1 : 0;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kOnePoints; ++k) {
    const int64_t i = base + static_cast<int64_t>(k) * kThreads;
    if (i < n) out[i] = acc[k];
  }
}

}  // namespace
}  // namespace repro_torch

extern "C" int repro_crossings_one(const void* points, const void* edges,
                                   void* out, int64_t n, int e,
                                   void* stream) {
  using namespace repro_torch;
  constexpr int64_t kRows = static_cast<int64_t>(kThreads) * kOnePoints;
  const unsigned grid = static_cast<unsigned>((n + kRows - 1) / kRows);
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

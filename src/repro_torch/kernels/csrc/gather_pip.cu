// Candidate PIP over the blocked-CSR edge pool, replacing the Pallas
// crossings_candidates (src/repro/kernels/gather_pip.py:151): the
// crossing count of each row's point against the live edges of its
// candidate polygon pids[r] (pid < 0: no candidate, count 0).
//
// What bounds it on the card.  A row brings 12 bytes (its id and point)
// and takes 4 out; its polygon's first / count / live entries and edges
// are a few hundred bytes that every row of that polygon reads again,
// from L1 / L2.  The crossing tests are few: the census's block polygons
// have 4-14 live edges (8.2 on average) in 256-edge pool blocks, so the
// work the inputs need is the per-row bytes, ~16 B a row.  The earlier
// design (a warp a row, lanes over every block's BE lanes) ran ~97 % of
// its loads and tests on zero padding.
//
// Design: one thread a row; the thread walks edge i = 0 .. n-1 of its
// polygon, n = min(live[pid], count[pid] * be), edge i at block
// first + i / be, lane i % be, and stops there, so no edge past the live
// count is read.  Rows arrive sorted by candidate id
// (core/resolve.py::_pip_ids), so the 32 threads of a warp almost always
// share a polygon: their edge loads are one broadcast each and the loop
// is warp-uniform.  Rows without a candidate (sorted last) write 0 and
// load nothing but their id.  The kernel reads the pool's per-polygon
// tables by id itself, so ``ops.pip_candidates`` gathers no per-row
// first / count / live arrays.
//
// Bit-safety: build_edge_pool packs a polygon's live edges at positions
// 0 .. n_live-1 and zero-fills the rest; an all-zero edge has y1 == y2,
// so it never straddles, and the count stopped at the live count is the
// same integer as the count over whole blocks.
#include "pip.cuh"

namespace repro_torch {
namespace {

__global__ void __launch_bounds__(kThreads) crossings_candidates_kernel(
    const int* __restrict__ pids, const float2* __restrict__ points,
    const int* __restrict__ first, const int* __restrict__ count,
    const int* __restrict__ live, const float* __restrict__ blocks,
    int* __restrict__ out, int64_t rows, int n_poly, int be) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= rows) return;
  const int pid = pids[r];
  int c = 0;
  if (pid >= 0) {
    const int p = min(pid, n_poly - 1);          // ops' clamp of the id
    const int64_t n = min(static_cast<int64_t>(live[p]),
                          static_cast<int64_t>(count[p]) * be);
    if (n > 0) {
      const float2 q = points[r];
      const float* blk = blocks + static_cast<int64_t>(first[p]) * 4 * be;
      for (int64_t i0 = 0; i0 < n; i0 += be, blk += 4 * be) {
        const int m = static_cast<int>(min(static_cast<int64_t>(be), n - i0));
        for (int e = 0; e < m; ++e) {
          c += crosses(q.x, q.y, blk[e], blk[be + e], blk[2 * be + e],
                       blk[3 * be + e]);
        }
      }
    }
  }
  out[r] = c;
}

}  // namespace
}  // namespace repro_torch

extern "C" int repro_crossings_candidates(
    const void* pids, const void* points, const void* first,
    const void* count, const void* live, const void* blocks, void* out,
    int64_t rows, int n_poly, int be, void* stream) {
  using namespace repro_torch;
  const unsigned grid =
      static_cast<unsigned>((rows + kThreads - 1) / kThreads);
  crossings_candidates_kernel<<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pids), static_cast<const float2*>(points),
      static_cast<const int*>(first), static_cast<const int*>(count),
      static_cast<const int*>(live), static_cast<const float*>(blocks),
      static_cast<int*>(out), rows, n_poly, be);
  return static_cast<int>(cudaGetLastError());
}

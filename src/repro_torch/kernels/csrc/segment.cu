// Per-segment count / sum / min / max over stable-sorted ids (port of
// src/repro/kernels/segment.py::segment_reduce_sorted, the analytics
// layer's per-block aggregation).
//
// The Pallas kernel matches every (row tile, segment tile) pair with a
// [bp, bs] one-hot compare: O(N * S) work that a TPU's vector unit
// absorbs.  Here the sort does the matching: segment s is the one
// contiguous run of rows whose id is s, [start[s], start[s + 1]).  What
// bounds the card is reading the values once (4 bytes a row); the ids are
// only searched (S + 1 searches) and read at the ends of each warp's
// rows.  With no values (occupancy counts) only the searches and the 16
// bytes a segment out remain, so that case is bound by the searches'
// latency and by the launch itself.
//
// Rows whose id lies outside [0, S) land in no segment: being sorted,
// they sit before start[0] (negative ids) or from start[S] on, and no
// segment's run reaches them.
//
// Search.  start[s] is the lower bound of s in the ids, found by one warp
// with a 33-way search: the lanes probe 32 evenly spaced rows of the open
// range, a ballot of ``ids[probe] < s`` narrows it to one of the 33 gaps,
// and a range of at most 32 rows ends it with one probe a lane.  At 2^24
// rows that is 5 dependent rounds instead of a binary search's 24; the
// first rounds probe the same rows for every bound and hit L2.  (Three
// probes a lane, 4 rounds, measured slower: a round's probes are 32-byte
// sectors read from memory, and they tripled.)
//
// No values: one launch, segment_counts.  A block searches the bounds of
// its kSegsPerBlock segments plus one, a warp each, into shared memory,
// then writes (count, 0, 0, 0) for a non-empty segment and (0, 0.0, +inf,
// -inf) for an empty one.  No row is read beyond the searches.
//
// Values: two launches.
//   1. segment_bounds — start[s] for s in [0, S], a warp each; it also
//                       zeroes each segment's ticket.  It lets launch 2
//                       start at once (programmatic dependent launch).
//   2. segment_tiles  — one block of kTileWarps warps per tile of kTile
//                       rows; each warp takes kWarpRows of them.  A warp
//                       first copies its rows into shared memory (16-byte
//                       asynchronous copies; single rows where the column
//                       does not start on a 16-byte boundary or the rows
//                       end mid-quad), so they stream while launch 1 still
//                       searches and while the warp reads its ids.  Then,
//                       32 segments at a time, a lane reads one segment's
//                       bounds; the empty ones the warp owns (their start
//                       lies in its rows) are written at once, and each
//                       segment with rows here is reduced by the warp.  A
//                       segment inside the warp's rows is written out; one
//                       that crosses their edges leaves a partial.  Warp 0
//                       then joins the warps' partials in warp order: a
//                       segment inside the tile is written out, one that
//                       crosses the tile's edge leaves a partial in the
//                       tile's slot 0 (it began in an earlier tile) or
//                       slot 1 (it begins here) and takes its ticket (an
//                       integer atomic with release / acquire order); the
//                       tile that gives its last partial folds them all in
//                       tile order, one warp.
//
// Determinism, with no float atomics: every sum is taken in a fixed order
// that depends only on the segment's bounds (tiles, warps' rows and quads
// are fixed row ranges).  Within a warp's rows a lane adds its head row,
// its quads (rows 4q .. 4q + 3: x, y, z, w) in quad order, then its tail
// row, and the lanes combine with a fixed xor butterfly; warps' parts
// join in warp order, and tiles' partials fold lane-strided in tile order
// through the same butterfly.  So two launches on the same input give
// bit-equal sums, and so does a column that does not start on a 16-byte
// boundary; an integer-valued column below 2^24 sums exactly in any
// order, so there it equals the bincount oracle bit for bit.  count, min
// and max are order-free.  min / max propagate NaN, as torch.amin / amax
// do.
#include "pip.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = kWarpsPerBlock;
constexpr int kWarpRows = 2048;           // rows a warp reduces
constexpr int kTileWarps = 4;             // warps a tile block
constexpr int kTileThreads = kTileWarps * kWarp;
constexpr int kTile = kWarpRows * kTileWarps;   // rows a tile block
constexpr int kSegsPerBlock = kWarps - 1;  // segments a counts block
constexpr int kSlot = 3;                   // partial = (sum, min, max)
constexpr int kProbes = kWarp;             // a search round's probes

struct Acc {
  float sum;
  float mn;
  float mx;
};

__device__ __forceinline__ Acc acc_empty() {
  return {0.0f, __int_as_float(0x7f800000), __int_as_float(0xff800000)};
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (b < a || b != b) ? b : a;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ Acc combine(Acc a, Acc b) {
  return {__fadd_rn(a.sum, b.sum), nan_min(a.mn, b.mn), nan_max(a.mx, b.mx)};
}

__device__ __forceinline__ Acc add_value(Acc a, float v) {
  return {__fadd_rn(a.sum, v), nan_min(a.mn, v), nan_max(a.mx, v)};
}

// Xor butterfly: every lane ends with the warp's total.  Float addition
// is commutative, so the two lanes of each pair compute the same bits.
__device__ __forceinline__ Acc warp_combine(Acc a) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    Acc o;
    o.sum = __shfl_xor_sync(0xffffffffu, a.sum, off);
    o.mn = __shfl_xor_sync(0xffffffffu, a.mn, off);
    o.mx = __shfl_xor_sync(0xffffffffu, a.mx, off);
    a = combine(a, o);
  }
  return a;
}

// Lower bound of s in ids[0, n): the first row whose id is >= s (n if
// none).  Called by a whole warp with the same s; every lane returns it.
__device__ __forceinline__ int64_t warp_lower_bound(
    const int* __restrict__ ids, int64_t n, int s, int lane) {
  int64_t lo = 0;
  int64_t hi = n;                          // the answer lies in [lo, hi]
  while (hi - lo > kProbes) {              // warp-uniform
    const int64_t probe = lo + (hi - lo) * (lane + 1) / (kProbes + 1);
    const unsigned below = __ballot_sync(0xffffffffu,
                                         __ldg(ids + probe) < s);
    const int c = __popc(below);           // probes below s: a prefix
    const int64_t p_prev =
        __shfl_sync(0xffffffffu, probe, c > 0 ? c - 1 : 0);
    const int64_t p_next = __shfl_sync(0xffffffffu, probe,
                                       c < kProbes ? c : kProbes - 1);
    if (c > 0) lo = p_prev + 1;
    if (c < kProbes) hi = p_next;
  }
  const bool below = lane < hi - lo && __ldg(ids + lo + lane) < s;
  return lo + __popc(__ballot_sync(0xffffffffu, below));
}

__device__ __forceinline__ void write_out(int s, int64_t n_rows, Acc a,
                                          int* count, float* sum,
                                          float* vmin, float* vmax) {
  count[s] = static_cast<int>(n_rows);
  sum[s] = a.sum;
  vmin[s] = a.mn;
  vmax[s] = a.mx;
}

__global__ void __launch_bounds__(kThreads) segment_counts_kernel(
    const int* __restrict__ ids, int64_t n, int n_segments,
    int* __restrict__ count, float* __restrict__ sum,
    float* __restrict__ vmin, float* __restrict__ vmax) {
  __shared__ int64_t bound[kWarps];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int s0 = blockIdx.x * kSegsPerBlock;
  const int s = s0 + warp;                 // bounds s0 .. s0 + kSegsPerBlock
  if (s <= n_segments) {
    const int64_t b = warp_lower_bound(ids, n, s, lane);
    if (lane == 0) bound[warp] = b;
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < kSegsPerBlock && s0 + t < n_segments) {
    const int64_t n_rows = bound[t + 1] - bound[t];
    const Acc a = n_rows > 0 ? Acc{0.0f, 0.0f, 0.0f} : acc_empty();
    write_out(s0 + t, n_rows, a, count, sum, vmin, vmax);
  }
}

__global__ void __launch_bounds__(kThreads) segment_bounds_kernel(
    const int* __restrict__ ids, int64_t n, int n_segments,
    int64_t* __restrict__ start, int* __restrict__ tickets) {
  // Launch 2 may start now: it streams its rows, then waits for this
  // grid to finish before it reads start or the tickets.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int lane = threadIdx.x % kWarp;
  const int s = blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (s > n_segments) return;              // warp-uniform
  const int64_t b = warp_lower_bound(ids, n, s, lane);
  if (lane == 0) {
    start[s] = b;
    if (s < n_segments) tickets[s] = 0;
  }
}

// Rows [b, e) of one segment inside the rows staged at ``tv`` (rows
// lo ..), added by lane ``part`` of ``parts``: first one head row (rows
// before the first whole quad, a quad being rows 4q .. 4q + 3), then
// quads part, part + parts, ..., then one tail row.
__device__ __forceinline__ Acc tile_rows(const float* tv, int64_t lo,
                                         int64_t b, int64_t e, int part,
                                         int parts) {
  Acc a = acc_empty();
  const int rb = static_cast<int>(b - lo);
  const int re = static_cast<int>(e - lo);
  int qb = (rb + 3) & ~3;                  // first whole quad's row
  if (qb > re) qb = re;
  int qe = re & ~3;                        // past the last whole quad
  if (qe < qb) qe = qb;
  if (rb + part < qb) a = add_value(a, tv[rb + part]);
  const float4* quads = reinterpret_cast<const float4*>(tv + qb);
  const int n_quads = (qe - qb) >> 2;
#pragma unroll 4
  for (int q = part; q < n_quads; q += parts) {
    const float4 v = quads[q];
    a = add_value(add_value(add_value(add_value(a, v.x), v.y), v.z), v.w);
  }
  if (qe + part < re) a = add_value(a, tv[qe + part]);
  return a;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(a), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A warp's last step for segment s (bounds [b, e)) whose rows in tile
// [lo, hi) summed to ``a`` (valid in lane 0): the result when the segment
// lies inside the tile; else a partial in the tile's slot 0 (the segment
// began in an earlier tile) or slot 1 (it begins here), and the tile that
// gives the segment's last partial (its ticket: an integer atomic with
// release / acquire order) folds them all in tile order.  Every lane of
// the warp calls it.
__device__ void finish(int s, int64_t b, int64_t e, int64_t tile,
                       int64_t lo, int64_t hi, Acc a, int lane,
                       float* partials, int* tickets, int* count,
                       float* sum, float* vmin, float* vmax) {
  if (b >= lo && e <= hi) {
    if (lane == 0) write_out(s, e - b, a, count, sum, vmin, vmax);
    return;
  }
  const int64_t t0 = b / kTile;
  const int64_t t1 = (e - 1) / kTile;
  bool last = false;
  if (lane == 0) {
    float* p = partials + (tile * 2 + (b < lo ? 0 : 1)) * kSlot;
    p[0] = a.sum;
    p[1] = a.mn;
    p[2] = a.mx;
    // Release: the partial is visible before the ticket counts it.
    int given;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(given) : "l"(tickets + s) : "memory");
    last = given == static_cast<int>(t1 - t0);
  }
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  __threadfence();
  Acc f = acc_empty();
#pragma unroll 4
  for (int64_t u = t0 + lane; u <= t1; u += kWarp) {
    const float* p = partials + (u * 2 + (u == t0 ? 1 : 0)) * kSlot;
    f = combine(f, Acc{__ldcg(p), __ldcg(p + 1), __ldcg(p + 2)});
  }
  f = warp_combine(f);
  if (lane == 0) write_out(s, e - b, f, count, sum, vmin, vmax);
}

template <bool kVec>
__global__ void __launch_bounds__(kTileThreads) segment_tiles_kernel(
    const int* __restrict__ ids, const float* __restrict__ values,
    const int64_t* __restrict__ start, int64_t n, int n_segments,
    int n_tiles, float* __restrict__ partials, int* __restrict__ tickets,
    int* __restrict__ count, float* __restrict__ sum,
    float* __restrict__ vmin, float* __restrict__ vmax) {
  __shared__ __align__(16) float tv[kTile];
  // Per warp, the segments that cross its edges: slot 0 the one that
  // began before its rows, slot 1 the one that begins there and runs on.
  __shared__ Acc cross_acc[kTileWarps][2];
  __shared__ int64_t cross_b[kTileWarps][2];
  __shared__ int64_t cross_e[kTileWarps][2];
  __shared__ int cross_s[kTileWarps][2];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int64_t tile = blockIdx.x;
  const int64_t lo = tile * kTile;
  const int64_t hi = lo + kTile < n ? lo + kTile : n;
  const int64_t wlo = lo + int64_t{warp} * kWarpRows;
  const int64_t whi = wlo + kWarpRows < hi ? wlo + kWarpRows : hi;
  float* wv = tv + warp * kWarpRows;
  // 1. The warp's rows into shared memory (16-byte asynchronous copies;
  // single rows where the column is not 16-byte aligned or it ends
  // mid-quad), streaming while the warp reads its bounds.
  for (int q = lane; q < kWarpRows / 4; q += kWarp) {
    const int64_t r = wlo + 4 * q;
    if (kVec && r + 4 <= whi) {
      cp_async16(wv + 4 * q, values + r);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        wv[4 * q + c] = r + c < whi ? __ldg(values + r + c) : 0.0f;
      }
    }
  }
  cp_async_commit();
  if (lane < 2) cross_s[warp][lane] = -1;
  if (wlo < whi) {                         // warp-uniform
    // 2. Segments with rows here lie in [ids[wlo], ids[whi - 1]], clamped
    // to [0, S); the warp owns the segments whose start lies in its rows
    // (the last rows: up to n), from one past the id before them to one
    // past their last id, and writes the empty ones among them.
    auto clamp_seg = [n_segments](int64_t x) {
      return static_cast<int>(x < 0 ? 0 : (x > n_segments ? n_segments : x));
    };
    const int id_lo = __ldg(ids + wlo);
    const int id_hi = __ldg(ids + whi - 1);
    const int own_lo =
        wlo == 0 ? 0 : clamp_seg(int64_t{__ldg(ids + wlo - 1)} + 1);
    const int own_hi =
        whi == n ? n_segments : clamp_seg(int64_t{id_hi} + 1);
    const int f = id_lo < 0 ? 0 : id_lo;
    const int l = id_hi < n_segments ? id_hi + 1 : n_segments;
    const int s_lo = f < own_lo ? f : own_lo;
    const int s_hi = l > own_hi ? l : own_hi;  // exclusive
    // Launch 1 (the bounds and the tickets) must be done from here on.
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    cp_async_wait_all();
    __syncwarp();
    // The bounds of 32 segments at a time, a lane each; the empty owned
    // ones written at once, then each segment with rows here reduced by
    // the warp.
    for (int base = s_lo; base < s_hi; base += kWarp) {
      const int my_s = base + lane;
      const bool mine = my_s < s_hi;
      const int64_t my_b = mine ? start[my_s] : 0;
      const int64_t my_e = mine ? start[my_s + 1] : 0;
      if (mine && my_b == my_e && my_s >= own_lo && my_s < own_hi) {
        write_out(my_s, 0, acc_empty(), count, sum, vmin, vmax);
      }
      unsigned todo = __ballot_sync(
          0xffffffffu, mine && my_b != my_e && my_b < whi && my_e > wlo);
      while (todo) {
        const int i = __ffs(todo) - 1;
        todo &= todo - 1;
        const int s = base + i;
        const int64_t b = __shfl_sync(0xffffffffu, my_b, i);
        const int64_t e = __shfl_sync(0xffffffffu, my_e, i);
        const Acc a = warp_combine(tile_rows(wv, wlo, b > wlo ? b : wlo,
                                             e < whi ? e : whi, lane, kWarp));
        if (lane == 0) {
          if (b >= wlo && e <= whi) {
            write_out(s, e - b, a, count, sum, vmin, vmax);
          } else {
            const int slot = b < wlo ? 0 : 1;
            cross_acc[warp][slot] = a;
            cross_b[warp][slot] = b;
            cross_e[warp][slot] = e;
            cross_s[warp][slot] = s;
          }
        }
      }
    }
  }
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  cp_async_wait_all();
  __syncthreads();
  if (warp != 0) return;
  // 3. Warp 0 joins the warps' edges in warp order: lane w < kTileWarps the
  // segment that begins in warp w's rows and runs on, lane kTileWarps the one
  // that began before the block.  A joined segment inside the block is
  // written out; one that crosses the block's edge goes on to finish().
  int s = -1;
  Acc a = acc_empty();
  int64_t b = 0;
  int64_t e = 0;
  if (lane <= kTileWarps) {
    const int w0 = lane < kTileWarps ? lane : 0;
    const int slot = lane < kTileWarps ? 1 : 0;
    s = cross_s[w0][slot];
    if (s >= 0) {
      a = cross_acc[w0][slot];
      b = cross_b[w0][slot];
      e = cross_e[w0][slot];
      for (int w = w0 + 1; w < kTileWarps && cross_s[w][0] == s; ++w) {
        a = combine(a, cross_acc[w][0]);
      }
      if (b >= lo && e <= hi) {
        write_out(s, e - b, a, count, sum, vmin, vmax);
        s = -1;
      }
    }
  }
  unsigned todo = __ballot_sync(0xffffffffu, s >= 0);
  while (todo) {
    const int i = __ffs(todo) - 1;
    todo &= todo - 1;
    Acc ai;
    ai.sum = __shfl_sync(0xffffffffu, a.sum, i);
    ai.mn = __shfl_sync(0xffffffffu, a.mn, i);
    ai.mx = __shfl_sync(0xffffffffu, a.mx, i);
    finish(__shfl_sync(0xffffffffu, s, i), __shfl_sync(0xffffffffu, b, i),
           __shfl_sync(0xffffffffu, e, i), tile, lo, hi, ai, lane, partials,
           tickets, count, sum, vmin, vmax);
  }
}

}  // namespace
}  // namespace repro_torch

// ids [n] i32 sorted ascending (ids outside [0, n_segments) land in no
// segment; the caller parks them at n_segments); values [n] f32 (4-byte
// aligned), or null for a zero column (n > 0 with values).  Scratch, used
// only with values (else it may be null): start [n_segments + 1] i64,
// partials [tiles, 2, 3] f32 and tickets [n_segments] i32, tiles =
// ceil(n / kTile) (repro_segment_tile_rows).  Outputs count [n_segments]
// i32 and sum / min / max [n_segments] f32, n_segments > 0.  *launched
// is set to the launches made: 1 without values, 2 with.
extern "C" int repro_segment_reduce_sorted(
    const void* ids, const void* values, void* start, void* partials,
    void* tickets, void* count, void* sum, void* vmin, void* vmax,
    int64_t n, int n_segments, void* stream, int* launched) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  int* c = static_cast<int*>(count);
  float* su = static_cast<float*>(sum);
  float* mn = static_cast<float*>(vmin);
  float* mx = static_cast<float*>(vmax);
  *launched = 0;
  if (values == nullptr) {
    segment_counts_kernel<<<(n_segments + kSegsPerBlock - 1) / kSegsPerBlock,
                            kThreads, 0, st>>>(id, n, n_segments, c, su, mn,
                                               mx);
    *launched = 1;
    return static_cast<int>(cudaGetLastError());
  }
  int* tk = static_cast<int*>(tickets);
  segment_bounds_kernel<<<(n_segments + 1 + kWarps - 1) / kWarps, kThreads,
                          0, st>>>(id, n, n_segments,
                                   static_cast<int64_t*>(start), tk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  *launched = 1;
  const float* v = static_cast<const float*>(values);
  const bool vec = reinterpret_cast<uintptr_t>(v) % 16 == 0;
  auto kernel = vec ? &segment_tiles_kernel<true>
                    : &segment_tiles_kernel<false>;
  const int n_tiles = static_cast<int>((n + kTile - 1) / kTile);
  // Programmatic dependent launch: its blocks may start streaming their
  // rows while launch 1 still searches (griddepcontrol in both kernels).
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_tiles));
  cfg.blockDim = dim3(kTileThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, id, v,
                           static_cast<const int64_t*>(start), n, n_segments,
                           n_tiles, static_cast<float*>(partials), tk, c, su,
                           mn, mx);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) *launched = 2;
  return static_cast<int>(err);
}

// Rows per tile block (the wrapper sizes the scratch with it).
extern "C" int repro_segment_tile_rows() { return repro_torch::kTile; }

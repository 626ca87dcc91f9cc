// Per-segment count / sum / min / max over stable-sorted ids (port of
// src/repro/kernels/segment.py::segment_reduce_sorted, the analytics
// layer's per-block aggregation).
//
// The Pallas kernel matches every (row tile, segment tile) pair with a
// [bp, bs] one-hot compare: O(N * S) work that a TPU's vector unit
// absorbs.  Here the sort does the matching: segment s is the one
// contiguous run of rows whose id is s, [start[s], start[s + 1]).  What
// bounds the card is reading the values once (4 bytes a row); the ids are
// only binary-searched (S + 1 searches) and read at each tile's ends.
//
// Rows whose id lies outside [0, S) land in no segment: being sorted,
// they sit before start[0] (negative ids) or from start[S] on, and the
// tiles cover only [start[0], start[S]).
//
// Three launches, all on the caller's stream:
//   1. segment_bounds  — start[s] = lower bound of s in the sorted ids,
//                        for s in [0, S]; start[S] is the first row
//                        with id >= S (parked), so rows past it land
//                        nowhere.
//   2. segment_tiles   — one block per tile of kTile rows, so a hot
//                        segment (say 40 % of the rows) spreads over many
//                        blocks instead of serializing on one.  A
//                        segment that starts and ends inside the tile
//                        is written out whole;
//                        the tile's first and last segments, when they
//                        cross the tile's edge, leave a partial in the
//                        tile's two slots.  The first and last segments
//                        reduce over the whole block; the ones between
//                        them take one warp each.
//   3. segment_fixup   — one warp per segment: an empty segment gets
//                        (0, 0.0, +inf, -inf); a segment that spans
//                        tiles folds its tiles' partials.
// With no values (a zero column: occupancy counts) steps 2 and 3 give
// way to segment_zero_column, one thread per segment: the count is
// start[s + 1] - start[s], and sum / min / max are 0 where it is not 0.
// No row is read beyond the binary searches.
//
// Determinism, with no float atomics: every sum is taken in a fixed order
// that depends only on the segment's bounds.  A thread adds its rows in
// row order (rows begin + t, begin + t + kThreads, ...), a warp combines
// lanes with a fixed xor butterfly, a block combines its warps in warp
// order, and the fixup folds partials in tile order through the same
// butterfly.  So two launches on the same input give bit-equal sums; an
// integer-valued column below 2^24 sums exactly in any order, so there it
// equals the bincount oracle bit for bit.  count, min and max are
// order-free.  min / max propagate NaN, as torch.amin / amax do.
#include "pip.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = kWarpsPerBlock;
constexpr int64_t kTile = 16 * kThreads;   // rows per tile block
constexpr int kSlot = 3;                   // partial = (sum, min, max)

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

// This thread's rows of [begin, end), strided by ``stride``, in order.
__device__ __forceinline__ Acc strided_rows(const float* __restrict__ values,
                                            int64_t begin, int64_t end,
                                            int first, int stride) {
  Acc a = acc_empty();
#pragma unroll 4
  for (int64_t i = begin + first; i < end; i += stride) {
    a = add_value(a, __ldg(values + i));
  }
  return a;
}

// Whole-block reduction of rows [begin, end); the result is valid in
// thread 0.  Every thread of the block must call it (block-uniform).
__device__ Acc block_rows(const float* __restrict__ values, int64_t begin,
                          int64_t end, Acc* shared) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  Acc a = warp_combine(strided_rows(values, begin, end, threadIdx.x,
                                    kThreads));
  __syncthreads();                  // ``shared`` is free from an earlier use
  if (lane == 0) shared[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = warp_combine(lane < kWarps ? shared[lane] : acc_empty());
  }
  return a;
}

__device__ __forceinline__ void write_out(int s, int64_t n_rows, Acc a,
                                          int* count, float* sum,
                                          float* vmin, float* vmax) {
  count[s] = static_cast<int>(n_rows);
  sum[s] = a.sum;
  vmin[s] = a.mn;
  vmax[s] = a.mx;
}

__device__ __forceinline__ void write_slot(float* partials, int64_t tile,
                                           int slot, Acc a) {
  float* p = partials + (tile * 2 + slot) * kSlot;
  p[0] = a.sum;
  p[1] = a.mn;
  p[2] = a.mx;
}

__global__ void __launch_bounds__(kThreads) segment_bounds_kernel(
    const int* __restrict__ ids, int64_t n, int n_bounds,
    int64_t* __restrict__ start) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_bounds) return;
  int64_t lo = 0;
  int64_t hi = n;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (__ldg(ids + mid) < s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  start[s] = lo;
}

__global__ void __launch_bounds__(kThreads) segment_tiles_kernel(
    const int* __restrict__ ids, const float* __restrict__ values,
    const int64_t* __restrict__ start, int n_segments,
    float* __restrict__ partials, int* __restrict__ count,
    float* __restrict__ sum, float* __restrict__ vmin,
    float* __restrict__ vmax) {
  __shared__ Acc shared[kWarps];
  const int64_t tile = blockIdx.x;
  const int64_t tile_lo = tile * kTile;
  // Rows before start[0] hold negative ids and land nowhere.
  const int64_t lo = tile_lo > start[0] ? tile_lo : start[0];
  const int64_t n_valid = start[n_segments];
  const int64_t hi = tile_lo + kTile < n_valid ? tile_lo + kTile : n_valid;
  if (lo >= hi) return;             // no row of the tile is in a segment
  const int s_first = __ldg(ids + lo);
  const int s_last = __ldg(ids + hi - 1);

  // The first segment: it ends in this tile, or it fills the tile.
  const int64_t f_begin = start[s_first];
  const int64_t f_end = start[s_first + 1];
  Acc a = block_rows(values, lo, f_end < hi ? f_end : hi, shared);
  if (threadIdx.x == 0) {
    if (f_begin >= lo && f_end <= hi) {
      write_out(s_first, f_end - f_begin, a, count, sum, vmin, vmax);
    } else {
      write_slot(partials, tile, 0, a);
    }
  }
  // The last segment, when it is another one: it starts in this tile.
  if (s_last != s_first) {
    const int64_t l_begin = start[s_last];
    const int64_t l_end = start[s_last + 1];
    a = block_rows(values, l_begin, hi, shared);
    if (threadIdx.x == 0) {
      if (l_end <= hi) {
        write_out(s_last, l_end - l_begin, a, count, sum, vmin, vmax);
      } else {
        write_slot(partials, tile, 1, a);
      }
    }
  }
  // The segments between them lie wholly inside the tile: one warp
  // each.  Empty ones are left to the fixup.
  const int lane = threadIdx.x % kWarp;
  for (int s = s_first + 1 + threadIdx.x / kWarp; s < s_last; s += kWarps) {
    const int64_t b = start[s];
    const int64_t e = start[s + 1];
    if (b == e) continue;           // warp-uniform
    a = warp_combine(strided_rows(values, b, e, lane, kWarp));
    if (lane == 0) write_out(s, e - b, a, count, sum, vmin, vmax);
  }
}

__global__ void __launch_bounds__(kThreads) segment_fixup_kernel(
    const int64_t* __restrict__ start, const float* __restrict__ partials,
    int n_segments, int* __restrict__ count, float* __restrict__ sum,
    float* __restrict__ vmin, float* __restrict__ vmax) {
  const int lane = threadIdx.x % kWarp;
  const int64_t s64 =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / kWarp;
  if (s64 >= n_segments) return;    // warp-uniform
  const int s = static_cast<int>(s64);
  const int64_t b = start[s];
  const int64_t e = start[s + 1];
  if (b == e) {
    if (lane == 0) write_out(s, 0, acc_empty(), count, sum, vmin, vmax);
    return;
  }
  const int64_t t0 = b / kTile;
  const int64_t t1 = (e - 1) / kTile;
  if (t0 == t1) return;             // written whole by its tile
  // In its first tile the segment holds slot 1 unless it also opens
  // that tile's rows (which begin at start[0] in the tile holding it);
  // in every later tile it is the first segment, slot 0.
  const int64_t opens = t0 * kTile > start[0] ? t0 * kTile : start[0];
  const int first_slot = (b == opens) ? 0 : 1;
  Acc a = acc_empty();
  for (int64_t t = t0 + lane; t <= t1; t += kWarp) {
    const float* p = partials + (t * 2 + (t == t0 ? first_slot : 0)) * kSlot;
    a = combine(a, Acc{p[0], p[1], p[2]});
  }
  a = warp_combine(a);
  if (lane == 0) write_out(s, e - b, a, count, sum, vmin, vmax);
}

__global__ void __launch_bounds__(kThreads) segment_zero_column_kernel(
    const int64_t* __restrict__ start, int n_segments,
    int* __restrict__ count, float* __restrict__ sum,
    float* __restrict__ vmin, float* __restrict__ vmax) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_segments) return;
  const int64_t n_rows = start[s + 1] - start[s];
  Acc a = acc_empty();
  if (n_rows > 0) a = Acc{0.0f, 0.0f, 0.0f};
  write_out(s, n_rows, a, count, sum, vmin, vmax);
}

}  // namespace
}  // namespace repro_torch

// ids [n] i32 sorted ascending (ids outside [0, n_segments) land in no
// segment; the caller parks them at n_segments); values [n] f32, or null
// for a zero column.  Scratch: start [n_segments + 1] i64 and partials
// [ceil(n / kTile), 2, 3] f32 (see repro_segment_tile_rows; unused, and
// may be null, when values is null).  Outputs count [n_segments] i32 and
// sum / min / max [n_segments] f32.
extern "C" int repro_segment_reduce_sorted(
    const void* ids, const void* values, void* start, void* partials,
    void* count, void* sum, void* vmin, void* vmax, int64_t n,
    int n_segments, void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_bounds = n_segments + 1;
  segment_bounds_kernel<<<(n_bounds + kThreads - 1) / kThreads, kThreads, 0,
                          st>>>(static_cast<const int*>(ids), n, n_bounds,
                                static_cast<int64_t*>(start));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (values == nullptr) {
    if (n_segments > 0) {
      segment_zero_column_kernel<<<(n_segments + kThreads - 1) / kThreads,
                                   kThreads, 0, st>>>(
          static_cast<const int64_t*>(start), n_segments,
          static_cast<int*>(count), static_cast<float*>(sum),
          static_cast<float*>(vmin), static_cast<float*>(vmax));
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (tiles > 0) {
    segment_tiles_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
        static_cast<const int*>(ids), static_cast<const float*>(values),
        static_cast<const int64_t*>(start), n_segments,
        static_cast<float*>(partials), static_cast<int*>(count),
        static_cast<float*>(sum), static_cast<float*>(vmin),
        static_cast<float*>(vmax));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_segments > 0) {
    segment_fixup_kernel<<<(n_segments + kWarps - 1) / kWarps, kThreads, 0,
                           st>>>(
        static_cast<const int64_t*>(start),
        static_cast<const float*>(partials), n_segments,
        static_cast<int*>(count), static_cast<float*>(sum),
        static_cast<float*>(vmin), static_cast<float*>(vmax));
  }
  return static_cast<int>(cudaGetLastError());
}

// Rows per tile block (the wrapper sizes the partials scratch with it).
extern "C" int repro_segment_tile_rows() {
  return static_cast<int>(repro_torch::kTile);
}

// Bounding-box filter of the simple cascade (port of
// src/repro/kernels/bbox.py): open-interval membership of points in
// boxes (xmin, xmax, ymin, ymax).  Pure strict comparisons on f32, no
// arithmetic, so the results are exact: a NaN coordinate compares false
// everywhere, and an empty box (xmin > xmax) never matches.
//
//   * bbox_mask          — [N, M] int8 membership in one shared [M, 4]
//                          box table (the state level); replaces the
//                          Pallas bbox_mask (src/repro/kernels/bbox.py:57).
//                          What bounds it: bytes, 8 per point in and M
//                          out; the comparisons are 4 per byte.  The first
//                          design (one thread per output byte, a 64-bit
//                          division for its (point, box)) was bound by
//                          instruction issue at ~7x its bound; reading the
//                          boxes from shared memory per test is bound by
//                          its wavefronts once a warp's threads want
//                          different boxes; short-lived blocks are bound
//                          by their own latency.  So the mask is cut into
//                          aligned 16-byte chunks, each written by one
//                          16-byte store, and a thread keeps the 16 boxes
//                          of its chunk in registers:
//       - flat (C = M / gcd(M, 16) <= 256): L = 16 / gcd(M, 16) rows make
//         a super-row of C whole chunks, and chunk c of every super-row
//         holds the same boxes, (16c + k) mod M for byte k, and crosses
//         from one row to the next at the same byte.  Thread t of a block
//         takes chunk t mod C of a run of super-rows, so a pass of the
//         block stores P C contiguous chunks (P = 256 / C super-rows) and
//         a warp 512 contiguous bytes; the blocks are persistent and load
//         the next pass's points while testing this one's.  Per byte: 4
//         compares, the point's select and the packing, no division and
//         no shared memory.  M < 16 reads each byte's point from L1.
//       - box tiles (the rest, only odd M > 256 among M <= 512): a 2-D
//         grid of points x tiles of 512 boxes; lane j of a warp holds
//         group j of the tile and writes its 16 bytes of each point's
//         run (one 16-byte store where the run is aligned for it, else
//         words or bytes).
//   * bbox_count_select  — per point, over its own gathered [C, 4] boxes:
//                          the number of containing boxes and the largest
//                          containing slot (-1 if none).  One warp per
//                          point; lane j loads box j as one float4, so a
//                          warp reads its row contiguously; a ballot
//                          gives the containing set 32 slots at a time.
//                          Not on the cascade's path since
//                          bbox_select_children took its place.
//   * bbox_select_children — the county and block levels of the simple
//                          cascade: per point, its parent's children read
//                          by id from the level's tables, the count of
//                          containing children, the child of the largest
//                          containing slot (-1 if none) and the children
//                          of the first k containing slots (-1 after
//                          them).  Replaces no Pallas kernel: it fuses the
//                          glue around bbox_count_select ([N, C] id and
//                          [N, C, 4] box gathers, the pick, the mask and
//                          top-k of the candidates).  What bounds it: the
//                          tables stay in L2, so HBM sees 36 bytes a point
//                          at k = 4 and each table once, the L2 (4 + 16) C
//                          bytes a point.  One warp per point; lane j
//                          reads slot base + j's id and its box as one
//                          float4 (a parent's children have consecutive
//                          ids: contiguous loads); a ballot over 32 slots
//                          gives the count (__popc), the pick (last set
//                          bit) and each containing lane's rank among the
//                          first k.
#include "pip.cuh"

namespace repro_torch {
namespace {

constexpr int kChunk = 16;                 // bytes a thread stores at once
constexpr int kBoxTile = 512;              // boxes a warp holds, box tiles
constexpr int kRowsPerBlock = 128;         // points a block, box tiles
constexpr unsigned kMaxGridY = 65535;

__device__ __forceinline__ bool in_box(float px, float py, float4 b) {
  return (px > b.x) && (px < b.y) && (py > b.z) && (py < b.w);
}

// This thread's group of 16 boxes, first .. first + len - 1, into
// registers; the slots past len get the empty box (1, 0, 1, 0), which
// no point is in.
__device__ __forceinline__ void load_group(const float4* __restrict__ boxes,
                                           int first, int len, float4* bx) {
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    bx[k] = k < len ? __ldg(boxes + first + k)
                    : make_float4(1.0f, 0.0f, 1.0f, 0.0f);
  }
}

// The 16 results of point p against the group, packed little-endian:
// byte k is box k of the group.
__device__ __forceinline__ uint4 test_group(float2 p, const float4* bx) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    if (in_box(p.x, p.y, bx[k])) w[k / 4] |= 1u << (8 * (k % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Put a group's ``len`` result bytes at dst (the box-tile layout): one
// 16-byte store where dst is 16-byte aligned and len is 16, 4-byte words
// where dst is 4-byte aligned and len a multiple of 4, else single bytes.
__device__ __forceinline__ void put_group(unsigned char* dst, uint4 w,
                                          int len) {
  const unsigned ws[4] = {w.x, w.y, w.z, w.w};
  const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(dst));
  if (len == kChunk && (a & (kChunk - 1)) == 0) {
    *reinterpret_cast<uint4*>(dst) = w;
  } else if ((a & 3) == 0 && (len & 3) == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (4 * k < len) reinterpret_cast<unsigned*>(dst)[k] = ws[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k < len) dst[k] = static_cast<unsigned char>(ws[k / 4] >>
                                                       (8 * (k % 4)));
    }
  }
}

// Flat layout (see the top).  A thread's chunk c: byte k is box
// (16c + k) mod m of row o0 + (k >= split) of its super-row; kMode says
// how many rows a chunk holds: kOneRow (m a multiple of 16: one row, so
// one point a chunk), kTwoRows (m >= 16), kManyRows (m < 16: byte k's
// point is row off[k], read from L1).  A block takes kPasses passes
// at a time: super-rows base + u * supers_a_pass + t / C.
constexpr int kOneRow = 0;
constexpr int kTwoRows = 1;
constexpr int kManyRows = 2;

template <int kMode>
__global__ void __launch_bounds__(kThreads) bbox_mask_flat_kernel(
    const float2* __restrict__ points, const float4* __restrict__ boxes,
    int8_t* __restrict__ out, int64_t n, int m, int rows_a_super,
    int chunks_a_super, int supers_a_pass) {
  constexpr int kPasses = kMode == kOneRow ? 8 : 4;
  const int t = threadIdx.x;
  if (t >= supers_a_pass * chunks_a_super) return;   // no barrier below
  const int c = t % chunks_a_super;
  const int first = c * kChunk;
  const int o0 = first / m;
  const int split = m - (first - o0 * m);  // bytes before the next row
  float4 bx[kChunk];
  int off[kChunk];
  {
    int j = first - o0 * m;
    int o = o0;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      bx[k] = __ldg(boxes + j);
      off[k] = o;
      if (++j == m) {
        j = 0;
        ++o;
      }
    }
  }
  const int64_t total = n * m;
  const int64_t n_super = (n + rows_a_super - 1) / rows_a_super;
  const int64_t span = static_cast<int64_t>(kPasses) * supers_a_pass;
  const int64_t step = static_cast<int64_t>(gridDim.x) * span;
  auto point = [&](int64_t row) {
    return __ldg(points + (row < n ? row : n - 1));
  };
  // Rows o0 and o0 + 1 of each of this thread's kPasses super-rows from
  // ``base`` (a row past the end repeats the last point).
  auto load = [&](int64_t b0, float2* pa, float2* pb) {
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      const int64_t row = (b0 + u * supers_a_pass + t / chunks_a_super) *
                              rows_a_super + o0;
      pa[u] = point(row);
      if (kMode == kTwoRows) pb[u] = split < kChunk ? point(row + 1) : pa[u];
    }
  };
  float2 pa[kPasses] = {};
  float2 pb[kPasses] = {};
  int64_t base = static_cast<int64_t>(blockIdx.x) * span;
  if (kMode != kManyRows) load(base, pa, pb);
  for (; base < n_super; base += step) {
    float2 na[kPasses] = {};
    float2 nb[kPasses] = {};
    if (kMode != kManyRows && base + step < n_super) load(base + step, na, nb);
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      const int64_t sr = base + u * supers_a_pass + t / chunks_a_super;
      const int64_t byte0 = (sr * chunks_a_super + c) * kChunk;
      if (byte0 >= total) continue;
      unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const float2 p = kMode == kManyRows ? point(sr * rows_a_super + off[k])
                         : kMode == kOneRow ? pa[u]
                                            : (k < split ? pa[u] : pb[u]);
        if (in_box(p.x, p.y, bx[k])) w[k / 4] |= 1u << (8 * (k % 4));
      }
      if (byte0 + kChunk <= total) {
        *reinterpret_cast<uint4*>(out + byte0) = make_uint4(w[0], w[1],
                                                            w[2], w[3]);
      } else {                             // the mask's ragged last chunk
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          if (byte0 + k < total) {
            out[byte0 + k] = static_cast<int8_t>((w[k / 4] >> (8 * (k % 4)))
                                                 & 1u);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      pa[u] = na[u];
      pb[u] = nb[u];
    }
  }
}

__global__ void __launch_bounds__(kThreads) bbox_mask_rows_kernel(
    const float2* __restrict__ points, const float4* __restrict__ boxes,
    int8_t* __restrict__ out, int64_t n, int m) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int64_t p_lo = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  const int64_t p_hi = p_lo + kRowsPerBlock < n ? p_lo + kRowsPerBlock : n;
  const int tiles = (m + kBoxTile - 1) / kBoxTile;
  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int c0 = tile * kBoxTile;
    const int cn = m - c0 < kBoxTile ? m - c0 : kBoxTile;
    const int j0 = lane * kChunk;          // this lane's group of the tile
    const int len = cn - j0 < 0 ? 0 : (cn - j0 < kChunk ? cn - j0 : kChunk);
    if (len == 0) continue;                // no barrier in this kernel
    float4 bx[kChunk];
    load_group(boxes, c0 + j0, len, bx);
    for (int64_t p = p_lo + warp; p < p_hi; p += kWarpsPerBlock) {
      put_group(reinterpret_cast<unsigned char*>(out + p * m + c0 + j0),
                test_group(__ldg(points + p), bx), len);
    }
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

// One warp per point r.  A parent outside [0, n_parents) reads the
// sentinel row n_parents (all -1); a child id outside [0, n_boxes - 1)
// reads the sentinel box n_boxes - 1.  Writes count[r], pick[r] and the
// k entries of first[r].
__global__ void __launch_bounds__(kThreads) bbox_select_children_kernel(
    const float2* __restrict__ points, const int* __restrict__ parent,
    const int* __restrict__ children, const float4* __restrict__ boxes,
    int* __restrict__ count, int* __restrict__ pick, int* __restrict__ first,
    int64_t rows, int n_parents, int c, int n_boxes, int k) {
  const int lane = threadIdx.x % kWarp;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (r >= rows) return;          // warp-uniform: r is the same on all lanes
  const float2 p = __ldg(points + r);
  const int par = __ldg(parent + r);
  const int* ids = children + static_cast<int64_t>(
      par >= 0 && par < n_parents ? par : n_parents) * c;
  const int sentinel = n_boxes - 1;
  int* out = first + r * k;
  int found = 0;
  int best = -1;
  for (int base = 0; base < c; base += kWarp) {
    const int j = base + lane;
    const int cid = j < c ? __ldg(ids + j) : -1;
    const float4 b = __ldg(boxes + (cid >= 0 && cid < sentinel ? cid
                                                               : sentinel));
    const bool inside = j < c && in_box(p.x, p.y, b);
    const unsigned m = __ballot_sync(0xffffffffu, inside);
    if (m) {                      // warp-uniform: m is the ballot
      best = __shfl_sync(0xffffffffu, cid, 31 - __clz(m));
      const int rank = found + __popc(m & ((1u << lane) - 1u));
      if (inside && rank < k) out[rank] = cid;
      found += __popc(m);
    }
  }
  for (int s = found + lane; s < k; s += kWarp) out[s] = -1;
  if (lane == 0) {
    count[r] = found;
    pick[r] = best;
  }
}

}  // namespace
}  // namespace repro_torch

// points [n, 2] f32 (8-byte aligned), boxes [m, 4] f32 (16-byte
// aligned), out [n, m] int8 (16-byte aligned); n, m > 0.  One launch.
extern "C" int repro_bbox_mask(const void* points, const void* boxes,
                               void* out, int64_t n, int m, void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* p = static_cast<const float2*>(points);
  const float4* b = static_cast<const float4*>(boxes);
  int8_t* o = static_cast<int8_t*>(out);
  int g = kChunk;                          // gcd(m, 16)
  while (m % g) g /= 2;
  const int rows_a_super = kChunk / g;
  const int chunks_a_super = m / g;
  if (chunks_a_super <= kThreads) {
    const int supers_a_pass = kThreads / chunks_a_super;
    const int64_t n_super = (n + rows_a_super - 1) / rows_a_super;
    const int64_t blocks = (n_super + supers_a_pass - 1) / supers_a_pass;
    auto kernel = m % kChunk == 0 ? &bbox_mask_flat_kernel<kOneRow>
                  : m > kChunk    ? &bbox_mask_flat_kernel<kTwoRows>
                                  : &bbox_mask_flat_kernel<kManyRows>;
    int device = 0;
    int sms = 0;
    int per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    const int64_t resident = static_cast<int64_t>(sms) *
                             (per_sm > 0 ? per_sm : 1);
    kernel<<<static_cast<unsigned>(blocks < resident ? blocks : resident),
             kThreads, 0, st>>>(p, b, o, n, m, rows_a_super, chunks_a_super,
                                supers_a_pass);
  } else {
    const unsigned tiles = static_cast<unsigned>((m + kBoxTile - 1) /
                                                 kBoxTile);
    const dim3 grid(static_cast<unsigned>((n + kRowsPerBlock - 1) /
                                          kRowsPerBlock),
                    tiles < kMaxGridY ? tiles : kMaxGridY);
    bbox_mask_rows_kernel<<<grid, kThreads, 0, st>>>(p, b, o, n, m);
  }
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

// points [rows, 2] f32 (8-byte aligned), parent [rows] i32, children
// [n_parents + 1, c] i32, boxes [n_boxes, 4] f32 (16-byte aligned, the
// sentinel last); count, pick [rows] i32, first [rows, k] i32, k <= c;
// rows > 0, n_boxes > 0.  One launch.
extern "C" int repro_bbox_select_children(
    const void* points, const void* parent, const void* children,
    const void* boxes, void* count, void* pick, void* first, int64_t rows,
    int n_parents, int c, int n_boxes, int k, void* stream) {
  using namespace repro_torch;
  bbox_select_children_kernel<<<warp_grid(rows), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(points), static_cast<const int*>(parent),
      static_cast<const int*>(children), static_cast<const float4*>(boxes),
      static_cast<int*>(count), static_cast<int*>(pick),
      static_cast<int*>(first), rows, n_parents, c, n_boxes, k);
  return static_cast<int>(cudaGetLastError());
}

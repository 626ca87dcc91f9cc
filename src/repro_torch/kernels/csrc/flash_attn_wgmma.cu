// Flash attention forward over [BH, S, D] on Hopper's tensor cores: the
// bf16 route at D in {64, 128} (port of
// src/repro/kernels/flash_attn.py::flash_attn_bhsd, the Pallas
// ``_flash_kernel``; the dense LM's prefill and forward attention).  f32,
// and bf16 at D 16 / 32, take the CUDA-core kernel in flash_attn.cu
// (kernels/flash_attn.py ``flash_route``).
//
// What it computes, as the Pallas kernel does: s = q . k^T with bf16
// inputs and f32 accumulation, then times the caller's ``scale`` (1 /
// sqrt(D) rounded to f32; multiplied after the product, not folded into
// q); keys with kpos >= S, and kpos > qpos when causal, masked to -1e30;
// online max m and sum l in f32 over 128-key tiles, l summing the f32 p;
// p rounded to bf16 and acc += p @ v in f32; out = acc / max(l, 1e-30)
// in bf16.  Any S: the ragged tail is masked here, and TMA fills rows
// past S with zeros.
//
// What bounds it on an H100: causal attention is 4 * BH * S^2 / 2 * D
// operations on 4 * BH * S * D bf16 elements of traffic, S / 4 operations
// a byte, so at the prefill's S = 2,048 it is bound by operations: 989
// TFLOP/s dense bf16, reachable only through wgmma.  The design:
//   * one block per (bh, 128 query rows): two consumer warpgroups of 64
//     rows each and one producer warp (288 threads).  Blocks of a causal
//     problem are launched heaviest first;
//   * Q's [128, D] tile is loaded once by TMA; K and V tiles of 128 keys
//     stream through a 2-stage shared-memory ring, each stage with a
//     full / empty mbarrier pair.  TMA reads the [BH, S, D] tensors
//     through 3-D tensor maps (built on the host by
//     cuTensorMapEncodeTiled, passed as __grid_constant__) in boxes of
//     64 columns x 128 rows with the 128-byte swizzle, two boxes side by
//     side at D = 128;
//   * S = Q K^T: wgmma m64n128k16, A = Q and B = K from shared memory,
//     both K-major (D contiguous), D / 16 instructions a tile;
//   * the softmax stays in registers in the accumulator layout: each
//     thread holds 2 rows x 32 keys, the row max takes two quad shuffles,
//     l is kept per thread and summed over the quad once at the end, and
//     a score costs one multiply by scale, one FMA and one ex2 (the
//     special-function unit's exp2 is as busy as the tensor cores at
//     D = 64, so the fewer other instructions the better);
//   * O += P V: P converted to bf16 in registers is the A operand (the
//     accumulator layout of the first product is the register-A layout
//     of the second), V comes from shared memory as the MN-major
//     (transposed) B operand: wgmma m64n64k16 per 64 columns of D;
//   * tiles wholly above the causal diagonal are skipped (p = 0 there
//     and the rescale is exp(0) = 1, since tile 0 always leaves m
//     finite); only the diagonal and the ragged last tile mask;
//   * epilogue: acc / l in bf16, stored straight from the registers.
// No atomics, one fixed order per row: two launches give the same bits.
// A wait on an mbarrier that outlasts kWaitLimitNs traps instead of
// spinning for ever, so a pipeline fault is an error, not a hung card.

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {
namespace {

constexpr int kRows = 128;            // query rows per block
constexpr int kWgRows = 64;           // query rows per consumer warpgroup
constexpr int kKeys = 128;            // keys per KV tile
constexpr int kStages = 2;            // K / V ring depth
constexpr int kBoxCols = 64;          // bf16 columns per TMA box (128 B)
constexpr int kBoxBytes = kBoxCols * 2 * kKeys;   // one 64-column box
constexpr int kConsumers = 256;       // two warpgroups
constexpr int kWgmmaThreads = kConsumers + 32;    // + the producer warp
constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint64_t kWaitLimitNs = 4000000000ull;
static_assert(kRows == kKeys, "a Q box and a K / V box share one shape");

// -- PTX wrappers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == 0) t0 = global_ns();
    if ((n & 1023) == 1023 && global_ns() - t0 > kWaitLimitNs) __trap();
  }
}

// One TMA box of a 3-D tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
// Addresses and offsets in bytes; every tile base is 1024-aligned, so the
// base-offset field stays 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// 2^x on the special-function unit, subnormal results flushed to 0 (p
// below 2^-126 adds nothing an f32 sum of ones can hold).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of a register across the
// asynchronous wgmma (its operands are live until wgmma_wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define ACC8(d, i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),       \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC32(d, i) ACC8(d, i), ACC8(d, i + 8), ACC8(d, i + 16), ACC8(d, i + 24)

// d[64] (+)= A[64 x 16] . B[16 x 128]^T, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}"
      : ACC32(d, 0), ACC32(d, 32)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[32] += A[64 x 16] (bf16 pairs in registers) . B[16 x 64], B MN-major
// (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : ACC32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ACC32
#undef ACC8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// -- the kernel ----------------------------------------------------------
//
// Shared memory, each region 1024-aligned: Q [D / 64 boxes][128 rows][64],
// then per stage K and V [D / 64 boxes][128 keys][64], then the
// mbarriers.  Box h holds columns 64 h .. 64 h + 63, one 128-byte row per
// query or key, swizzled by TMA in 1024-byte atoms of 8 rows.

template <int D>
__global__ void __launch_bounds__(kWgmmaThreads, 1) flash_attn_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
    int s_len, int causal, float scale) {
  constexpr int kBoxes = D / kBoxCols;
  constexpr int kTileBytes = kBoxes * kBoxBytes;    // one Q, K or V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t sq = smem_addr(smem);
  const uint32_t sk = sq + kTileBytes;                  // + stage * tile
  const uint32_t sv = sk + kStages * kTileBytes;        // + stage * tile
  const uint32_t bars = sv + kStages * kTileBytes;
  const uint32_t q_full = bars;
  const uint32_t full = bars + 8;                       // + 8 * stage
  const uint32_t empty = bars + 8 * (1 + kStages);      // + 8 * stage

  const int blk = gridDim.x - 1 - blockIdx.x;           // heaviest first
  const int q0 = blk * kRows;
  const int bh = blockIdx.y;
  const int all_tiles = (s_len + kKeys - 1) / kKeys;
  const int n_tiles = causal ? min(all_tiles, blk + 1) : all_tiles;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // Producer: one thread keeps the ring full.
    if (lane == 0) {
      mbar_expect_tx(q_full, kTileBytes);
      for (int h = 0; h < kBoxes; ++h) {
        tma_load(sq + h * kBoxBytes, &tm_q, h * kBoxCols, q0, bh, q_full);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int stage = t % kStages;
        mbar_wait(empty + 8 * stage, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * stage, 2 * kTileBytes);
        for (int h = 0; h < kBoxes; ++h) {
          tma_load(sk + stage * kTileBytes + h * kBoxBytes, &tm_k,
                   h * kBoxCols, t * kKeys, bh, full + 8 * stage);
          tma_load(sv + stage * kTileBytes + h * kBoxBytes, &tm_v,
                   h * kBoxCols, t * kKeys, bh, full + 8 * stage);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63.  In the
  // accumulator layout thread (warp w of the group, lane) holds rows
  // r0 = 16 w + lane / 4 and r0 + 8, and in each 8-column chunk j the
  // columns 8 j + 2 (lane % 4) and + 1: element 4 j + e is row r0 + 8 (e
  // / 2), column 8 j + 2 (lane % 4) + e % 2.
  const int wg = warp / 4;
  const int row0 = q0 + wg * kWgRows + (warp % 4) * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  const int wg_first = q0 + wg * kWgRows;
  const uint32_t qa = sq + wg * kWgRows * 128;

  float s[64];
  float acc[kBoxes][32];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.0f;
#pragma unroll
  for (int h = 0; h < kBoxes; ++h) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.0f;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};    // this thread's share of the row sums

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % kStages;
    const uint32_t phase = (t / kStages) & 1;
    const uint32_t kt = sk + stage * kTileBytes;
    const uint32_t vt = sv + stage * kTileBytes;
    const int k0 = t * kKeys;
    mbar_wait(full + 8 * stage, phase);

    // S = Q K^T over D in steps of 16 (32 bytes within a 128-byte row).
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_n128(s, smem_desc(qa + off, 16, 1024),
                    smem_desc(kt + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // Scale, mask, tile max.
    const bool mask = k0 + kKeys > s_len ||
                      (causal && k0 + kKeys - 1 > wg_first);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = i % 4 / 2;
      float x = s[i] * scale;
      if (mask) {
        const int key = k0 + 8 * (i / 4) + col + i % 2;
        if (key >= s_len || (causal && key > row0 + 8 * r)) x = kNegInf;
      }
      s[i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float rescale[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      rescale[r] = exp2f((m[r] - m_new) * kLog2e);
      m[r] = m_new;
      l[r] *= rescale[r];
    }
    // p = exp(s - m) = 2^(s log2(e) - m log2(e)), one FMA and one ex2 a
    // score, in f32 into l; bf16 p as the A operand of P V.
    const float ml[2] = {m[0] * kLog2e, m[1] * kLog2e};
    uint32_t p[32];
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = i % 4 / 2;
      const float p0 = ex2_ftz(__fmaf_rn(s[i], kLog2e, -ml[r]));
      const float p1 = ex2_ftz(__fmaf_rn(s[i + 1], kLog2e, -ml[r]));
      l[r] += p0;
      l[r] += p1;
      p[i / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int h = 0; h < kBoxes; ++h) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] *= rescale[i % 4 / 2];
    }

    // O += P V over the tile's keys in steps of 16 (16 rows of 128 bytes).
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                             p[4 * kk + 3]};
#pragma unroll
      for (int h = 0; h < kBoxes; ++h) {
        wgmma_rs_n64(acc[h], a,
                     smem_desc(vt + h * kBoxBytes + kk * 16 * 128,
                               kBoxBytes, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int h = 0; h < kBoxes; ++h) fence_regs(acc[h]);
    fence_regs(p);
    mbar_arrive(empty + 8 * stage);
  }

  // Epilogue: the quad's row sums, acc / max(l, 1e-30) in bf16.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  const int64_t base = static_cast<int64_t>(bh) * s_len;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= s_len) continue;
    uint32_t* out = reinterpret_cast<uint32_t*>(o + (base + row) * D);
#pragma unroll
    for (int h = 0; h < kBoxes; ++h) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        out[(h * kBoxCols + 8 * j + col) / 2] =
            pack_bf16(acc[h][4 * j + 2 * r] / l[r],
                      acc[h][4 * j + 2 * r + 1] / l[r]);
      }
    }
  }
}

// A [BH, S, D] bf16 tensor as a 3-D tensor map (D innermost), boxes of
// 64 columns x 128 rows x 1 head, 128-byte swizzle, zero fill past S.
int encode_map(CUtensorMap* map, const void* base, int bh, int s_len,
               int d) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s_len),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(s_len) * d * 2};
  const cuuint32_t box[3] = {kBoxCols, kKeys, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
      dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 int bh, int s_len, int causal, float scale,
                 cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  int err = encode_map(&tq, q, bh, s_len, D);
  if (!err) err = encode_map(&tk, k, bh, s_len, D);
  if (!err) err = encode_map(&tv, v, bh, s_len, D);
  if (err) return err;
  // Q, (1 + 1) x kStages K / V tiles, the mbarriers, 1024 of alignment.
  const int smem = (1 + 2 * kStages) * (D / kBoxCols) * kBoxBytes +
                   8 * (1 + 2 * kStages) + 1024;
  const cudaError_t a = cudaFuncSetAttribute(
      flash_attn_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (a != cudaSuccess) return static_cast<int>(a);
  const dim3 grid((s_len + kRows - 1) / kRows, bh);
  flash_attn_wgmma_kernel<D><<<grid, kWgmmaThreads, smem, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), s_len, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// q, k, v, o: [bh, s_len, d] contiguous bf16, 16-byte aligned; d in
// {64, 128}; bh in [1, 65535], s_len >= 1, s_len * d < 2^31 (the wrapper
// checks all of it).  ``scale`` is 1 / sqrt(d) as the caller rounds it to
// f32.
extern "C" int repro_flash_attn_wgmma(const void* q, const void* k,
                                      const void* v, void* o, int bh,
                                      int s_len, int d, int causal,
                                      float scale, void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_wgmma<64>(q, k, v, o, bh, s_len, causal, scale, st);
    case 128:
      return launch_wgmma<128>(q, k, v, o, bh, s_len, causal, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

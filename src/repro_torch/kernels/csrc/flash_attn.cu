// Flash attention forward over [BH, S, D] (port of
// src/repro/kernels/flash_attn.py::flash_attn_bhsd, the Pallas
// ``_flash_kernel``; the dense LM's prefill and forward attention).
//
// What it computes, as the Pallas kernel does: s = q . k^T in f32 times
// 1 / sqrt(D) (the caller's ``scale``); positions with kpos >= S, and
// kpos > qpos when causal, masked to -1e30; online max m and sum l in f32
// over KV tiles, l summing the f32 p; acc += p.astype(v.dtype) @ v in
// f32; out = acc / max(l, 1e-30) in q's dtype.  Inputs f32 or bf16,
// D in {16, 32, 64, 128} (one template instance each).
//
// What bounds it on an H100: causal attention is 4 * BH * S^2 / 2 * D
// operations on 4 * BH * S * D elements of traffic (q, k, v read once, o
// written once), S / 4 operations a byte in bf16, so from about S = 1,200
// on it is operation-bound: 989 TFLOP/s on the bf16 tensor cores.  This first
// kernel does its arithmetic in f32 on the CUDA cores (67 TFLOP/s peak),
// so it cannot come near that bound; mma.sync / wgmma, TMA and a
// producer warp are later work.  The Pallas kernel carries (m, l, acc) in
// VMEM across a sequential KV grid axis; here a loop inside the block
// takes the place of that axis:
//   * one block per (bh, tile of 64 query rows), 256 threads: four
//     threads per query row, each owning D / 4 of the row's dims (float4
//     groups at dims 16 g + 4 c, so the four threads of a row read four
//     consecutive float4s of shared memory: no bank conflicts) and
//     holding its slice of q and acc in registers;
//   * K and V stream through shared memory in tiles of 32 keys,
//     converted to f32 on the way in; keys past S are zero-filled and
//     masked;
//   * a key's score is the quad's four partial dots summed by two xor
//     shuffles, so the four threads of a row hold the same bits of every
//     score, max and sum;
//   * per tile: 32 scores in registers, the tile max, one rescale of
//     (l, acc), then p = exp(s - m) rounded to v's dtype into acc;
//   * under the causal mask a block stops after the tile holding its
//     last row's diagonal: a tile wholly above the diagonal adds p = 0
//     and rescales by exp(0) = 1, and tile 0 (key 0) always leaves m
//     finite, so skipping it gives the same bits.  The query tiles are
//     launched heaviest first.
// No atomics, one fixed order per row: two launches give the same bits.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {
namespace {

constexpr int kRowsPerBlock = 64;
constexpr int kKeysPerTile = 32;
constexpr int kThreadsPerRow = 4;
constexpr int kFlashThreads = kRowsPerBlock * kThreadsPerRow;
constexpr float kNegInf = -1.0e30f;
// K and V tiles in f32 at the largest D fit the 48 KB a block gets
// without opting in.
static_assert(2 * kKeysPerTile * 128 * sizeof(float) <= 48 * 1024,
              "flash tiles exceed the default shared memory");

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
  // p.astype(v.dtype)
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

template <int D, typename T>
__global__ void __launch_bounds__(kFlashThreads) flash_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int s_len, int causal,
    float scale) {
  constexpr int kGroups = D / (4 * kThreadsPerRow);   // float4s per thread
  extern __shared__ float4 smem[];
  float* sk = reinterpret_cast<float*>(smem);         // [kKeysPerTile][D]
  float* sv = sk + kKeysPerTile * D;                  // [kKeysPerTile][D]

  const int tid = threadIdx.x;
  const int c = tid % kThreadsPerRow;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRowsPerBlock;
  const int row = q0 + tid / kThreadsPerRow;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * s_len * D;

  float qr[kGroups][4];
  float acc[kGroups][4];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dim = 16 * g + 4 * c + e;
      qr[g][e] = row < s_len
          ? Elem<T>::load(q + base + static_cast<int64_t>(row) * D + dim)
          : 0.0f;
      acc[g][e] = 0.0f;
    }
  }
  float m = kNegInf;
  float l = 0.0f;

  const int n_tiles = (s_len + kKeysPerTile - 1) / kKeysPerTile;
  const int last_diag = (q0 + kRowsPerBlock - 1) / kKeysPerTile + 1;
  const int tiles = (causal && last_diag < n_tiles) ? last_diag : n_tiles;
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kKeysPerTile;
    // Elements of this tile that exist (keys k0 .. S-1); the rest are 0.
    const int n_elems = min(kKeysPerTile, s_len - k0) * D;
    const T* kt = k + base + static_cast<int64_t>(k0) * D;
    const T* vt = v + base + static_cast<int64_t>(k0) * D;
    __syncthreads();                  // the previous tile is consumed
    for (int i = tid; i < kKeysPerTile * D; i += kFlashThreads) {
      const bool in = i < n_elems;
      sk[i] = in ? Elem<T>::load(kt + i) : 0.0f;
      sv[i] = in ? Elem<T>::load(vt + i) : 0.0f;
    }
    __syncthreads();

    float sc[kKeysPerTile];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeysPerTile; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(sk + j * D);
      float part = 0.0f;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float4 kk = kr[4 * g + c];
        part = fmaf(qr[g][0], kk.x, part);
        part = fmaf(qr[g][1], kk.y, part);
        part = fmaf(qr[g][2], kk.z, part);
        part = fmaf(qr[g][3], kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int key = k0 + j;
      const bool ok = key < s_len && (!causal || key <= row);
      const float x = ok ? part * scale : kNegInf;
      sc[j] = x;
      tile_max = fmaxf(tile_max, x);
    }
    const float m_new = fmaxf(m, tile_max);
    const float rescale = expf(m - m_new);
    float l_tile = 0.0f;
#pragma unroll
    for (int j = 0; j < kKeysPerTile; ++j) {
      const float p = expf(sc[j] - m_new);
      l_tile += p;
      sc[j] = Elem<T>::round(p);
    }
    l = l * rescale + l_tile;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= rescale;
    }
#pragma unroll
    for (int j = 0; j < kKeysPerTile; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(sv + j * D);
      const float p = sc[j];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float4 vv = vr[4 * g + c];
        acc[g][0] = fmaf(p, vv.x, acc[g][0]);
        acc[g][1] = fmaf(p, vv.y, acc[g][1]);
        acc[g][2] = fmaf(p, vv.z, acc[g][2]);
        acc[g][3] = fmaf(p, vv.w, acc[g][3]);
      }
    }
    m = m_new;
  }
  if (row < s_len) {
    const float denom = fmaxf(l, 1e-30f);
    T* out = o + base + static_cast<int64_t>(row) * D;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Elem<T>::store(out + 16 * g + 4 * c + e, acc[g][e] / denom);
      }
    }
  }
}

template <int D, typename T>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 int bh, int s_len, int causal, float scale,
                 cudaStream_t st) {
  const int smem = 2 * kKeysPerTile * D * static_cast<int>(sizeof(float));
  const dim3 grid((s_len + kRowsPerBlock - 1) / kRowsPerBlock, bh);
  flash_attn_kernel<D, T><<<grid, kFlashThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s_len, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dim(const void* q, const void* k, const void* v, void* o,
                 int bh, int s_len, int d, int causal, float scale,
                 cudaStream_t st) {
  switch (d) {
    case 16:
      return launch_flash<16, T>(q, k, v, o, bh, s_len, causal, scale, st);
    case 32:
      return launch_flash<32, T>(q, k, v, o, bh, s_len, causal, scale, st);
    case 64:
      return launch_flash<64, T>(q, k, v, o, bh, s_len, causal, scale, st);
    case 128:
      return launch_flash<128, T>(q, k, v, o, bh, s_len, causal, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

// q, k, v, o: [bh, s_len, d] contiguous, f32 (is_bf16 = 0) or bf16
// (is_bf16 = 1); d in {16, 32, 64, 128}; bh in [1, 65535], s_len >= 1,
// s_len * d < 2^31 (the wrapper checks all of it).  ``scale`` is
// 1 / sqrt(d) as the caller rounds it to f32.
extern "C" int repro_flash_attn_bhsd(const void* q, const void* k,
                                     const void* v, void* o, int bh,
                                     int s_len, int d, int is_bf16,
                                     int causal, float scale, void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return dispatch_dim<__nv_bfloat16>(q, k, v, o, bh, s_len, d, causal,
                                       scale, st);
  }
  return dispatch_dim<float>(q, k, v, o, bh, s_len, d, causal, scale, st);
}

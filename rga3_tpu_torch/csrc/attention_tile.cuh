// SIMT tile machinery of the flash-attention backward kernels
// (flash_attention_bwd.cu), and the constants and launch helpers that the
// tensor-core forward tile (attention_mma.cuh) shares with them.
//
// A thread block owns 64 rows of one (batch, head). Four neighbouring
// threads share one row: the head dim, padded to a multiple of 16 in
// registers and shared memory (never in device memory), is split into
// float4 chunks interleaved across the four threads, so a row's partial dot
// products are summed with two xor-shuffles and the four threads read 64
// contiguous bytes of a staged row from shared memory. Staged tiles are 64
// rows of f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace rga3 {

constexpr int kTileRows = 64;    // query rows per block == keys per tile
constexpr int kThreads = 256;    // 4 threads per query row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// The Pallas kernels' mask value (ops/attention.py DEFAULT_MASK_VALUE).
constexpr float kMaskValue = -0.7f * FLT_MAX;

template <int D>
struct HeadDim {
  static constexpr int kPadded = (D + 15) / 16 * 16;  // f32 per smem row
  static constexpr int kChunks = kPadded / 16;        // float4 per thread
};

template <int D>
constexpr size_t tile_smem_bytes() {
  return 2u * kTileRows * HeadDim<D>::kPadded * sizeof(float);
}

// One row of q (this thread's chunks), zero beyond D or past the sequence.
template <int D>
__device__ __forceinline__ void load_q(float4 (&q)[HeadDim<D>::kChunks],
                                       const __nv_bfloat16* row, bool valid,
                                       int t4, float mult) {
#pragma unroll
  for (int c = 0; c < HeadDim<D>::kChunks; ++c) {
    const int d0 = (t4 + 4 * c) * 4;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = d0 + e;
      v[e] = (valid && d < D) ? __bfloat162float(row[d]) * mult : 0.f;
    }
    q[c] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Stage keys [k0, k0 + 64) of one (batch, kv head) into shared memory;
// rows past `len` and dims past D are zero.
template <int D>
__device__ __forceinline__ void load_kv_tile(
    float* ks, float* vs, const __nv_bfloat16* k, const __nv_bfloat16* v,
    int64_t k_sl, int64_t v_sl, int k0, int len) {
  constexpr int DP = HeadDim<D>::kPadded;
  for (int i = threadIdx.x; i < kTileRows * DP; i += kThreads) {
    const int r = i / DP;
    const int d = i - r * DP;
    const int pos = k0 + r;
    float kv = 0.f, vv = 0.f;
    if (pos < len && d < D) {
      kv = __bfloat162float(k[pos * k_sl + d]);
      vv = __bfloat162float(v[pos * v_sl + d]);
    }
    ks[i] = kv;
    vs[i] = vv;
  }
}

// Strides are in elements; the last (head) dim must be contiguous.
struct Strides {
  int64_t b, l, h;
};

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rga3

// Tile machinery shared by the flash- and window-attention kernels.
//
// A thread block owns 64 query rows of one (batch, head). Four neighbouring
// threads share one row: the head dim, padded to a multiple of 16 in
// registers and shared memory (never in device memory), is split into
// float4 chunks interleaved across the four threads, so a row's partial dot
// products are summed with two xor-shuffles and the four threads read 64
// contiguous bytes of a key row from shared memory. Keys and values are
// staged 64 rows at a time in shared memory as f32. Every row keeps its own
// online softmax in f32 and visits keys in chunks of 16.
//
// Scores are computed in base 2 (q is pre-multiplied by scale * log2(e)),
// which changes nothing but the rounding of exp.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace rga3 {

constexpr int kTileRows = 64;    // query rows per block == keys per tile
constexpr int kThreads = 256;    // 4 threads per query row
constexpr int kChunk = 16;       // keys per online-softmax update
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

// Online-softmax state of one query row, held by each of its 4 threads.
template <int D>
struct RowState {
  float4 o[HeadDim<D>::kChunks];
  float m;  // running max (base-2 scores)
  float l;  // running sum of exp2(s - m)

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int c = 0; c < HeadDim<D>::kChunks; ++c)
      o[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    m = -INFINITY;
    l = 0.f;
  }

  // Visit the 16 keys of the tile starting at row `j0`. `keep(j)` says
  // whether tile row j is a valid key for this query row; a masked key
  // scores kMaskValue, as in the Pallas kernels, so a chunk whose keys are
  // all masked still adds exp2(0) = 1 per key until a valid key arrives
  // and its weight alpha = exp2(kMaskValue - m) wipes them out.
  template <typename Keep>
  __device__ __forceinline__ void chunk(const float4 (&q)[HeadDim<D>::kChunks],
                                        const float* ks, const float* vs,
                                        int j0, int t4, Keep keep) {
    constexpr int DP = HeadDim<D>::kPadded;
    constexpr int NC = HeadDim<D>::kChunks;
    float s[kChunk];
    float cmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      const float4* kr = reinterpret_cast<const float4*>(ks + (j0 + jj) * DP);
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kk = kr[t4 + 4 * c];
        acc = fmaf(q[c].x, kk.x, acc);
        acc = fmaf(q[c].y, kk.y, acc);
        acc = fmaf(q[c].z, kk.z, acc);
        acc = fmaf(q[c].w, kk.w, acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      s[jj] = keep(j0 + jj) ? acc : kMaskValue;
      cmax = fmaxf(cmax, s[jj]);
    }
    const float m_new = fmaxf(m, cmax);
    const float alpha = exp2f(m - m_new);  // m == -inf -> 0
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      o[c].x *= alpha;
      o[c].y *= alpha;
      o[c].z *= alpha;
      o[c].w *= alpha;
    }
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      const float p = exp2f(s[jj] - m_new);
      psum += p;
      const float4* vr = reinterpret_cast<const float4*>(vs + (j0 + jj) * DP);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = vr[t4 + 4 * c];
        o[c].x = fmaf(p, vv.x, o[c].x);
        o[c].y = fmaf(p, vv.y, o[c].y);
        o[c].z = fmaf(p, vv.z, o[c].z);
        o[c].w = fmaf(p, vv.w, o[c].w);
      }
    }
    l = l * alpha + psum;
    m = m_new;
  }

  // o / l, with l == 0 (no key visited) giving zeros, as the Pallas
  // kernel's finalize does.
  __device__ __forceinline__ void store(__nv_bfloat16* row, int t4) const {
    const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
    for (int c = 0; c < HeadDim<D>::kChunks; ++c) {
      const int d0 = (t4 + 4 * c) * 4;
      const float v[4] = {o[c].x, o[c].y, o[c].z, o[c].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d0 + e < D) row[d0 + e] = __float2bfloat16(v[e] * inv);
    }
  }
};

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

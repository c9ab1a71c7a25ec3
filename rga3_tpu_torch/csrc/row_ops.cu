// Row kernels of the fused Hiera blocks for Hopper (sm_90a), bf16:
//
//   * rga3_layer_norm_bf16: y = bf16(LayerNorm(x)) over rows of D, with f32
//     statistics (two passes: mean, then the mean of squared deviations) and
//     bf16 gamma and beta widened to f32. It is the LayerNorm of the Pallas
//     TPU kernels in rga3_tpu/ops/fused_block.py (`_layernorm`, :99): LN1
//     and LN2 before the GEMM of `_fused_kernel` (:105), `_ln_matmul_kernel`
//     (:312), `_proj_mlp_kernel` (:324) and `_transition_kernel` (:917),
//     whose bodies round the normalised rows to bf16 before the product, and
//     the second output of `_proj_ln_kernel` (:543).
//   * rga3_window_pool2x2_bf16: the 2x2 max pool inside each ws x ws window
//     of window-major tokens, `_pool_win_2x2` of `_transition_kernel`
//     (rga3_tpu/ops/fused_block.py:907,917): the q-pool transition block's
//     shortcut and its pooled queries.
//
// What bounds them on the H100: both read each input byte once and write
// each output byte once with a few flops per element, so they are bound by
// bytes. LayerNorm gives one warp to a row and moves it in 16-byte chunks
// (a row of 1152 is read three times, from L1 after the first); the pool
// gives one thread to 8 channels of one pooled token and reads its four
// source tokens in 16-byte chunks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rga3 {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kRowsPerBlock = 8;  // warps per LayerNorm block
constexpr int kPoolThreads = 256;

__global__ void __launch_bounds__(kRowsPerBlock * 32)
    layer_norm_kernel(const bf16* x, int64_t ldx, const bf16* g, const bf16* b, bf16* y,
                      int64_t ldy, int rows, int d, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * ldx);
  uint4* yr = reinterpret_cast<uint4*>(y + row * ldy);
  const int chunks = d / 8;
  float sum = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    const uint4 u = xr[c];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      sum += f.x + f.y;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mean = sum / d;
  float sq = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    const uint4 u = xr[c];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      sq += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float rs = rsqrtf(sq / d + eps);
  for (int c = lane; c < chunks; c += 32) {
    uint4 u = xr[c];
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
    const uint4 gu = reinterpret_cast<const uint4*>(g)[c];
    const uint4 bu = reinterpret_cast<const uint4*>(b)[c];
    const __nv_bfloat162* gh = reinterpret_cast<const __nv_bfloat162*>(&gu);
    const __nv_bfloat162* bh = reinterpret_cast<const __nv_bfloat162*>(&bu);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      const float2 gg = __bfloat1622float2(gh[e]), bb = __bfloat1622float2(bh[e]);
      h[e] = __floats2bfloat162_rn((f.x - mean) * rs * gg.x + bb.x,
                                   (f.y - mean) * rs * gg.y + bb.y);
    }
    yr[c] = u;
  }
}

// Token rows are window-major: input row win * ws*ws + i * ws + j holds
// (i, j) of window `win` (across the batch, whose stride is whole windows);
// output row win * (ws/2)^2 + i' * (ws/2) + j' is the max of input
// (2i' + a, 2j' + b), a, b in {0, 1}.
__global__ void __launch_bounds__(kPoolThreads)
    window_pool_kernel(const bf16* x, int64_t ldx, bf16* y, int64_t ldy, int64_t out_rows,
                       int ws, int c) {
  const int chunks = c / 8;
  const int64_t idx = blockIdx.x * static_cast<int64_t>(kPoolThreads) + threadIdx.x;
  if (idx >= out_rows * chunks) return;
  const int64_t orow = idx / chunks;
  const int ch = static_cast<int>(idx - orow * chunks);
  const int hw = ws / 2;
  const int64_t win = orow / (hw * hw);
  const int t = static_cast<int>(orow - win * hw * hw);
  const int i = t / hw, j = t - (t / hw) * hw;
  const int64_t src = win * ws * ws + (2 * i) * ws + 2 * j;
  const int64_t rows[4] = {src, src + 1, src + ws, src + ws + 1};
  float m[8];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint4 u = *reinterpret_cast<const uint4*>(x + rows[r] * ldx + ch * 8);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      m[2 * e] = r == 0 ? f.x : fmaxf(m[2 * e], f.x);
      m[2 * e + 1] = r == 0 ? f.y : fmaxf(m[2 * e + 1], f.y);
    }
  }
  uint4 o;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(m[2 * e], m[2 * e + 1]);
  *reinterpret_cast<uint4*>(y + orow * ldy + ch * 8) = o;
}

}  // namespace
}  // namespace rga3

// Plain C entry points for ctypes. Leading dims are in elements, multiples
// of 8, and the pointers 16-byte aligned. Each returns a cudaError_t.

// d a multiple of 8; g and b bf16 (d), 16-byte aligned.
extern "C" int rga3_layer_norm_bf16(const void* x, int64_t ldx, const void* g, const void* b,
                                    void* y, int64_t ldy, int rows, int d, float eps,
                                    void* stream) {
  using namespace rga3;
  if (rows <= 0 || d <= 0 || d % 8 || ldx % 8 || ldy % 8) return cudaErrorInvalidValue;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  layer_norm_kernel<<<blocks, kRowsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), ldx, static_cast<const bf16*>(g),
      static_cast<const bf16*>(b), static_cast<bf16*>(y), ldy, rows, d, eps);
  return cudaGetLastError();
}

// out_rows pooled tokens (a multiple of (ws/2)^2); ws even; c a multiple of 8.
extern "C" int rga3_window_pool2x2_bf16(const void* x, int64_t ldx, void* y, int64_t ldy,
                                        int64_t out_rows, int ws, int c, void* stream) {
  using namespace rga3;
  if (out_rows <= 0 || ws < 2 || ws % 2 || c <= 0 || c % 8 || ldx % 8 || ldy % 8 ||
      out_rows % ((ws / 2) * (ws / 2)))
    return cudaErrorInvalidValue;
  const int64_t work = out_rows * (c / 8);
  const int64_t blocks = (work + kPoolThreads - 1) / kPoolThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  window_pool_kernel<<<static_cast<unsigned>(blocks), kPoolThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), ldx, static_cast<bf16*>(y), ldy, out_rows, ws, c);
  return cudaGetLastError();
}

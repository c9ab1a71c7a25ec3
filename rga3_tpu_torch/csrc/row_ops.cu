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
// bytes (3.35 TB/s of HBM3): a LayerNorm of R rows of D moves 4 R D bytes.
// The pool gives one thread to 8 channels of one pooled token and reads its
// four source tokens in 16-byte chunks.
//
// The LayerNorm's first design (a warp a row, three passes over it, one
// 16-byte load a lane in flight, gamma and beta read again for every row)
// held 0.44 of that bound. This one:
//   * gives each row a group of G lanes (a power of two up to 32) of K
//     16-byte chunks each, picked on the host so that G * K chunks cover the
//     row with the fewest idle lanes (D = 144 / 288 / 576 / 1152 take G =
//     4 / 8 / 16 / 32 lanes of K = 5 chunks: 90% of the lanes busy, against
//     56-75% in the last pass of the first design);
//   * reads each row from device memory into registers once, in K
//     independent 16-byte loads a lane, and takes the sum, the centred sum
//     of squares and the output from those registers (shuffle trees inside
//     the group);
//   * is persistent: as many 256-thread blocks as fit walk over passes of
//     256 / G rows in equal shares, each lane loading its chunks of its next
//     row before it normalises the current one, so that a row's loads are
//     in flight while the last one is computed;
//   * holds gamma and beta, widened to f32, in shared memory, loaded once a
//     block;
//   * writes the output from registers in 16-byte stores.
// A ring of shared-memory stages filled by 1-D bulk copies (cp.async.bulk on
// mbarriers; with 16-byte or bulk stores) measured slower at every main-path
// width (PERF.md, section 6), and was not kept.
// The statistics' order (tests/test_torch_row_ops.py models it): each lane
// adds its chunks' sums in chunk order, a chunk's 8 values as a tree
// ((x0+x1)+(x2+x3))+((x4+x5)+(x6+x7)); the group joins its lanes with an
// xor butterfly (offsets G/2 .. 1); mean = sum / D; the squared deviations
// likewise, each product rounded; y = ((x - mean) * rs) * g + b with every
// operation rounded, as the plain version computes it. Rows up to
// kLnMaxD = 8192 wide (32 lanes x 32 chunks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "device.cuh"  // use_device, PerDevice

namespace rga3 {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kLnThreads = 256;
constexpr int kLnMinBlocks = 2;  // blocks an SM at K <= 8: 128 registers a thread
constexpr int kLnMaxD = 8192;
constexpr int kPoolThreads = 256;

struct LnParams {
  const bf16* x;
  const bf16* g;
  const bf16* b;
  bf16* y;
  int64_t rows;
  int d;
  int shift;  // a row's group has G = 1 << shift lanes
  float eps;
};

__device__ __forceinline__ float group_sum(float v, int g) {
  for (int o = g >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void widen(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 t = __bfloat1622float2(h[e]);
    f[2 * e] = t.x;
    f[2 * e + 1] = t.y;
  }
}

__device__ __forceinline__ float tree8(const float (&f)[8]) {
  return ((f[0] + f[1]) + (f[2] + f[3])) + ((f[4] + f[5]) + (f[6] + f[7]));
}

// LayerNorm of the row whose chunks lane + k * G this lane holds in v (the
// group's other lanes hold the rest), in place; every lane of the warp
// calls it together (the shuffles), whether its row exists or not.
template <int K>
__device__ __forceinline__ void normalize(uint4 (&v)[K], int lane, int shift, int chunks,
                                          int d, const float4* gs, const float4* bs, float eps) {
  float f[8];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (lane + (k << shift) >= chunks) break;
    widen(v[k], f);
    sum += tree8(f);
  }
  const float mean = group_sum(sum, 1 << shift) / d;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (lane + (k << shift) >= chunks) break;
    widen(v[k], f);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = __fmul_rn(f[e] - mean, f[e] - mean);
    sq += tree8(f);
  }
  const float rs = rsqrtf(group_sum(sq, 1 << shift) / d + eps);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + (k << shift);
    if (c >= chunks) break;
    widen(v[k], f);
    const float4 g0 = gs[2 * c], g1 = gs[2 * c + 1], b0 = bs[2 * c], b1 = bs[2 * c + 1];
    const float gf[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float bf[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v[k]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float y0 = __fadd_rn(__fmul_rn(__fmul_rn(f[2 * e] - mean, rs), gf[2 * e]), bf[2 * e]);
      const float y1 =
          __fadd_rn(__fmul_rn(__fmul_rn(f[2 * e + 1] - mean, rs), gf[2 * e + 1]), bf[2 * e + 1]);
      h[e] = __floats2bfloat162_rn(y0, y1);
    }
  }
}

// This lane's chunks of a row (zeros where the row is null or the chunk
// past its end).
template <int K>
__device__ __forceinline__ void load_chunks(uint4 (&v)[K], const uint4* row, int lane, int shift,
                                            int chunks) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + (k << shift);
    v[k] = row != nullptr && c < chunks ? row[c] : make_uint4(0, 0, 0, 0);
  }
}

// The block's groups take one row each a pass, passes strided by the grid.
// At K <= 8 each lane loads its chunks of its next row before it normalises
// the current one; wider rows (K >= 12) load as they go, so that their
// 4 K registers of row data are not doubled.
template <int K>
__global__ void __launch_bounds__(kLnThreads, K <= 8 ? kLnMinBlocks : 1)
    layer_norm_bf16_kernel(const LnParams p) {
  constexpr bool kPrefetch = K <= 8;
  extern __shared__ __align__(16) float4 gb[];  // gamma, then beta, widened to f32
  const int chunks = p.d >> 3;
  float4* gs = gb;
  float4* bs = gb + 2 * chunks;
  for (int c = threadIdx.x; c < chunks; c += kLnThreads) {
    float f[8];
    widen(reinterpret_cast<const uint4*>(p.g)[c], f);
    gs[2 * c] = make_float4(f[0], f[1], f[2], f[3]);
    gs[2 * c + 1] = make_float4(f[4], f[5], f[6], f[7]);
    widen(reinterpret_cast<const uint4*>(p.b)[c], f);
    bs[2 * c] = make_float4(f[0], f[1], f[2], f[3]);
    bs[2 * c + 1] = make_float4(f[4], f[5], f[6], f[7]);
  }
  __syncthreads();
  const int lane = threadIdx.x & ((1 << p.shift) - 1);
  const int groups = kLnThreads >> p.shift;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * groups;
  const auto row_at = [&](int64_t row) {
    return row < p.rows ? reinterpret_cast<const uint4*>(p.x + row * p.d) : nullptr;
  };
  const int64_t first = static_cast<int64_t>(blockIdx.x) * groups;
  int64_t row = first + (threadIdx.x >> p.shift);
  uint4 v[K];
  [[maybe_unused]] uint4 next[K];
  if constexpr (kPrefetch) load_chunks<K>(v, row_at(row), lane, p.shift, chunks);
  // the same trips for every lane of a warp
  for (int64_t base = first; base < p.rows; base += stride, row += stride) {
    if constexpr (kPrefetch)
      load_chunks<K>(next, row_at(row + stride), lane, p.shift, chunks);
    else
      load_chunks<K>(v, row_at(row), lane, p.shift, chunks);
    normalize<K>(v, lane, p.shift, chunks, p.d, gs, bs, p.eps);
    if (row < p.rows) {
      uint4* yr = reinterpret_cast<uint4*>(p.y + row * p.d);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = lane + (k << p.shift);
        if (c >= chunks) break;
        yr[c] = v[k];
      }
    }
    if constexpr (kPrefetch) {
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = next[k];
    }
  }
}

// The lanes a row (1 << shift) and the 16-byte chunks a lane (k): the
// least G * K >= chunks with K <= 8, ties to the larger G; wider rows take
// G = 32 and the least K of 12, 16, 24 or 32 that covers them.
struct LnShape {
  int shift, k;
};

LnShape ln_shape(int chunks) {
  LnShape best{5, 0};
  for (int shift = 5; shift >= 0; --shift) {
    const int k = (chunks + (1 << shift) - 1) >> shift;
    if (k <= 8 && (best.k == 0 || (k << shift) < (best.k << best.shift))) best = {shift, k};
  }
  if (best.k == 0)
    for (int k : {12, 16, 24, 32})
      if (32 * k >= chunks) return {5, k};
  return best;
}

template <int K>
cudaError_t launch_layer_norm(const LnParams& p, cudaStream_t stream) {
  const int smem = 2 * 4 * p.d;  // gamma and beta in f32: 64 KB at kLnMaxD
  static PerDevice smem_attr;
  cudaError_t err = smem_attr.get([] {
    const cudaError_t set = cudaFuncSetAttribute(
        layer_norm_bf16_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, 2 * 4 * kLnMaxD);
    // the most shared memory and so the least L1: the rows stream through
    // once, and at D = 144 / 288 this measured 6% faster than the default
    // split (tools/bench_layer_norm.py)
    return set != cudaSuccess
               ? set
               : cudaFuncSetAttribute(layer_norm_bf16_kernel<K>,
                                      cudaFuncAttributePreferredSharedMemoryCarveout,
                                      cudaSharedmemCarveoutMaxShared);
  });
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, layer_norm_bf16_kernel<K>,
                                                        kLnThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // as many blocks as fit, each with an equal share of the passes
  const int64_t groups = kLnThreads >> p.shift;
  const int64_t passes = (p.rows + groups - 1) / groups;
  const int64_t most = static_cast<int64_t>(sms) * per_sm;
  const int64_t waves = (passes + most - 1) / most;
  const int64_t grid = (passes + waves - 1) / waves;
  layer_norm_bf16_kernel<K><<<static_cast<unsigned>(grid), kLnThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

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

// Plain C entry points for ctypes, on CUDA device `device` (device.cuh).
// Each returns a cudaError_t.

// Contiguous rows: ldx == ldy == d, d a multiple of 8 up to 8192; x, y, g
// and b (bf16, d) 16-byte aligned.
extern "C" int rga3_layer_norm_bf16(int device, const void* x, int64_t ldx, const void* g,
                                    const void* b, void* y, int64_t ldy, int rows, int d,
                                    float eps, void* stream) {
  using namespace rga3;
  if (const cudaError_t err = use_device(device); err != cudaSuccess) return err;
  if (rows <= 0 || d <= 0 || d % 8 || d > kLnMaxD || ldx != d || ldy != d || !aligned16(x) ||
      !aligned16(y) || !aligned16(g) || !aligned16(b))
    return cudaErrorInvalidValue;
  const LnShape shape = ln_shape(d / 8);
  const LnParams q{static_cast<const bf16*>(x), static_cast<const bf16*>(g),
                   static_cast<const bf16*>(b), static_cast<bf16*>(y), rows, d, shape.shift, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (shape.k) {
    case 1: return launch_layer_norm<1>(q, s);
    case 2: return launch_layer_norm<2>(q, s);
    case 3: return launch_layer_norm<3>(q, s);
    case 4: return launch_layer_norm<4>(q, s);
    case 5: return launch_layer_norm<5>(q, s);
    case 6: return launch_layer_norm<6>(q, s);
    case 7: return launch_layer_norm<7>(q, s);
    case 8: return launch_layer_norm<8>(q, s);
    case 12: return launch_layer_norm<12>(q, s);
    case 16: return launch_layer_norm<16>(q, s);
    case 24: return launch_layer_norm<24>(q, s);
    case 32: return launch_layer_norm<32>(q, s);
    default: return cudaErrorInvalidValue;
  }
}

// out_rows pooled tokens (a multiple of (ws/2)^2); ws even; c, ldx and ldy
// multiples of 8; x and y 16-byte aligned.
extern "C" int rga3_window_pool2x2_bf16(int device, const void* x, int64_t ldx, void* y,
                                        int64_t ldy, int64_t out_rows, int ws, int c,
                                        void* stream) {
  using namespace rga3;
  if (const cudaError_t err = use_device(device); err != cudaSuccess) return err;
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

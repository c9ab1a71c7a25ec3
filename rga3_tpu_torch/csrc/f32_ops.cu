// f32 variants of the Hiera encoder's kernels for Hopper (sm_90a), on the
// CUDA cores: f32 operands, f32 accumulation, FMA, no TF32 and no tensor
// cores.
//
// Under f32 parameters (the train entry point's `--param_dtype float32`,
// its release default) the JAX package computes the frozen SAM2 image
// encoder in f32: flax promotes the bf16 frames to the f32 parameters, and
// the Pallas kernels compute in their inputs' dtype (`xb.dtype` throughout
// `_fused_kernel`, rga3_tpu/ops/fused_block.py:105-176, and the attention
// bodies of rga3_tpu/ops/attention.py:75,228). These entry points are the
// same functions as the bf16 kernels of gemm.cu, row_ops.cu,
// window_attention.cu and flash_attention.cu, at f32 wherever the JAX body
// rounds to `xb.dtype`:
//
//   * rga3_gemm_f32: out[m, n] = epilogue(sum_k A[m, k] W[n, k] + bias[n]),
//     with gemm.cu's epilogues (bias; tanh or erf GELU of acc + b; residual
//     + (acc + b); (residual + b) + acc), A (M, K), W (N, K);
//   * rga3_layer_norm_f32: LayerNorm over rows of D, two-pass statistics;
//   * rga3_window_pool2x2_f32: the 2x2 max inside each ws x ws window of
//     window-major tokens;
//   * rga3_attention_f32: softmax(q k^T * scale) v over a key range per
//     query row: block-diagonal windows (`window` keys for each `q_window`
//     queries, the pooled queries of the q-pool transition included) or, with
//     one window over every key, the non-causal flash forward of Hiera's
//     global blocks.
//
// What bounds them on the H100: the encoder's products (K = 144 to 4608,
// M ~ 10^4-10^6 tokens) do 2 M N K flops on 4 (MK + NK + MN) bytes, ~70-500
// flops a byte against the card's 67 TFLOP/s f32 peak over 3.35 TB/s = ~20,
// so they are bound by operations. The GEMM is the classic register-tiled
// SIMT design: a block of 256 threads owns a 128 x 128 output tile, stages
// 128 x 8 slices of A and W, transposed, through a double-buffered shared
// ring (the next slice's global loads in flight in registers while this one
// is multiplied), and each thread keeps an 8 x 8 accumulator tile in
// registers: per k step, four 16-byte shared loads feed 64 FMAs. The row
// kernels are bound by bytes (one warp a row, 16-byte pieces). The attention
// gives four threads to a query row, each holding a quarter of q and of the
// output in registers; keys stream through the L1 cache (the rows of a block
// share them), scores reduce across the four with two shuffles, and the
// online softmax rescales in f32 after every four keys. It is simple rather
// than fast: the encoder's attention is ~7% of its flops at Hiera-L.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device.cuh"  // use_device

namespace rga3 {
namespace {

// ---------------------------------------------------------------------------
// the GEMM
// ---------------------------------------------------------------------------

constexpr int kTileM = 128, kTileN = 128, kTileK = 8;
constexpr int kGemmThreads = 256;
constexpr int kPitch = kTileM + 4;  // shared row of a transposed slice (floats)

enum Epilogue { kBias = 0, kGeluTanh = 1, kGeluErf = 2, kResRounded = 3, kResF32 = 4 };

struct GemmF32Params {
  const float* a;     // (M, K), row stride lda
  const float* w;     // (N, K), row stride ldw
  const float* bias;  // (N)
  const float* res;   // (M, N), row stride ldr: the residual epilogues
  float* out;         // (M, N), row stride ldo
  int64_t lda, ldw, ldr, ldo;
  int m, n, k;
};

__device__ __forceinline__ float gelu_tanh_f32(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(kBeta * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float gelu_erf_f32(float x) {
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

// The 16-byte piece of a (rows, k) row-major matrix at (row, k0), k0 a
// multiple of 4 and k a multiple of 4: zeros past either edge.
__device__ __forceinline__ float4 load_piece(const float* p, int64_t ld, int row, int rows,
                                             int k0, int k) {
  if (row >= rows || k0 >= k) return make_float4(0.f, 0.f, 0.f, 0.f);
  return __ldg(reinterpret_cast<const float4*>(p + row * ld + k0));
}

__device__ __forceinline__ void store_transposed(float* slice, int row, int kq, float4 v) {
  slice[(kq + 0) * kPitch + row] = v.x;
  slice[(kq + 1) * kPitch + row] = v.y;
  slice[(kq + 2) * kPitch + row] = v.z;
  slice[(kq + 3) * kPitch + row] = v.w;
}

template <int EPI>
__device__ __forceinline__ float epilogue(float acc, float b, const GemmF32Params& p, int row,
                                          int col) {
  if (EPI == kGeluTanh) return gelu_tanh_f32(acc + b);
  if (EPI == kGeluErf) return gelu_erf_f32(acc + b);
  if (EPI == kResRounded) return p.res[row * p.ldr + col] + (acc + b);
  if (EPI == kResF32) return (p.res[row * p.ldr + col] + b) + acc;
  return acc + b;
}

template <int EPI>
__global__ void __launch_bounds__(kGemmThreads, 2) gemm_f32_kernel(GemmF32Params p) {
  __shared__ __align__(16) float as[2][kTileK * kPitch];
  __shared__ __align__(16) float ws[2][kTileK * kPitch];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  // each thread copies one 16-byte piece of A's and of W's slice: row
  // tid / 2, k offset (tid & 1) * 4
  const int lrow = tid >> 1, lk = (tid & 1) * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 ra = load_piece(p.a, p.lda, m0 + lrow, p.m, lk, p.k);
  float4 rw = load_piece(p.w, p.ldw, n0 + lrow, p.n, lk, p.k);
  store_transposed(as[0], lrow, lk, ra);
  store_transposed(ws[0], lrow, lk, rw);
  __syncthreads();
  const int steps = (p.k + kTileK - 1) / kTileK;
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < steps;
    if (more) {  // the next slice in flight while this one is multiplied
      const int k0 = (s + 1) * kTileK + lk;
      ra = load_piece(p.a, p.lda, m0 + lrow, p.m, k0, p.k);
      rw = load_piece(p.w, p.ldw, n0 + lrow, p.n, k0, p.k);
    }
    const float* a_s = as[cur];
    const float* w_s = ws[cur];
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(a_s + kk * kPitch + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(a_s + kk * kPitch + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(w_s + kk * kPitch + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(w_s + kk * kPitch + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {  // the other buffer was last read before the previous barrier
      store_transposed(as[cur ^ 1], lrow, lk, ra);
      store_transposed(ws[cur ^ 1], lrow, lk, rw);
    }
    __syncthreads();
  }

  // thread (tx, ty) holds rows ty*4 + [0, 4) and 64 + ty*4 + [0, 4), columns
  // tx*4 + [0, 4) and 64 + tx*4 + [0, 4) of the tile
  const bool vec = (p.ldo & 3) == 0 && (EPI < kResRounded || (p.ldr & 3) == 0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= p.m) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = n0 + half * 64 + tx * 4;
      if (col >= p.n) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = col + e < p.n ? epilogue<EPI>(acc[i][half * 4 + e], p.bias[col + e], p, row,
                                             col + e)
                             : 0.f;
      float* dst = p.out + row * p.ldo + col;
      if (vec && col + 4 <= p.n) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        for (int e = 0; e < 4 && col + e < p.n; ++e) dst[e] = v[e];
      }
    }
  }
}

template <int EPI>
cudaError_t launch_gemm(const GemmF32Params& p, cudaStream_t stream) {
  const dim3 grid((p.n + kTileN - 1) / kTileN, (p.m + kTileM - 1) / kTileM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  gemm_f32_kernel<EPI><<<grid, kGemmThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the row kernels
// ---------------------------------------------------------------------------

constexpr int kRowsPerBlock = 8;  // warps a LayerNorm block
constexpr int kPoolThreads = 256;

__global__ void __launch_bounds__(kRowsPerBlock * 32)
    layer_norm_f32_kernel(const float* x, int64_t ldx, const float* g, const float* b, float* y,
                          int64_t ldy, int rows, int d, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const float4* xr = reinterpret_cast<const float4*>(x + row * ldx);
  float4* yr = reinterpret_cast<float4*>(y + row * ldy);
  const int chunks = d / 4;
  float sum = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    const float4 u = xr[c];
    sum += (u.x + u.y) + (u.z + u.w);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mean = sum / d;
  float sq = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    const float4 u = xr[c];
    const float a = u.x - mean, bb = u.y - mean, cc = u.z - mean, dd = u.w - mean;
    sq += (a * a + bb * bb) + (cc * cc + dd * dd);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float rs = 1.f / sqrtf(sq / d + eps);
  for (int c = lane; c < chunks; c += 32) {
    const float4 u = xr[c];
    const float4 gg = reinterpret_cast<const float4*>(g)[c];
    const float4 bv = reinterpret_cast<const float4*>(b)[c];
    yr[c] = make_float4((u.x - mean) * rs * gg.x + bv.x, (u.y - mean) * rs * gg.y + bv.y,
                        (u.z - mean) * rs * gg.z + bv.z, (u.w - mean) * rs * gg.w + bv.w);
  }
}

// row_ops.cu's window pool at f32: one thread to 4 channels of a pooled token.
__global__ void __launch_bounds__(kPoolThreads)
    window_pool_f32_kernel(const float* x, int64_t ldx, float* y, int64_t ldy, int64_t out_rows,
                           int ws, int c) {
  const int chunks = c / 4;
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
  float4 m = *reinterpret_cast<const float4*>(x + rows[0] * ldx + ch * 4);
#pragma unroll
  for (int r = 1; r < 4; ++r) {
    const float4 u = *reinterpret_cast<const float4*>(x + rows[r] * ldx + ch * 4);
    m = make_float4(fmaxf(m.x, u.x), fmaxf(m.y, u.y), fmaxf(m.z, u.z), fmaxf(m.w, u.w));
  }
  *reinterpret_cast<float4*>(y + orow * ldy + ch * 4) = m;
}

// ---------------------------------------------------------------------------
// the attention
// ---------------------------------------------------------------------------

constexpr int kLanesPerRow = 4;
constexpr int kAttnThreads = 128;  // 32 query rows a block
constexpr int kAttnRows = kAttnThreads / kLanesPerRow;
constexpr int kKeyStep = 4;  // keys between two rescales of the online softmax

struct AttnF32Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int64_t q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, o_sb, o_sl, o_sh;
  int len_q, window, q_window;
  float scale;
};

// DPT: the dims of a thread, D / 4 (even: its pieces are float2).
template <int DPT>
__global__ void __launch_bounds__(kAttnThreads) attention_f32_kernel(AttnF32Params p) {
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * kAttnRows + threadIdx.x / kLanesPerRow;
  const int part = threadIdx.x % kLanesPerRow;
  const bool live = row < p.len_q;  // dead rows shuffle along, store nothing
  const int r = live ? row : p.len_q - 1;
  const int key0 = r / p.q_window * p.window;
  const float* qr = p.q + b * p.q_sb + h * p.q_sh + r * p.q_sl + part * DPT;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh + part * DPT;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh + part * DPT;
  float q[DPT], o[DPT];
#pragma unroll
  for (int d = 0; d < DPT; d += 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(qr + d));
    q[d] = t.x, q[d + 1] = t.y;
    o[d] = o[d + 1] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  // every row of a window has `window` keys, a multiple of kKeyStep or not
  for (int j0 = 0; j0 < p.window; j0 += kKeyStep) {
    float s[kKeyStep];
#pragma unroll
    for (int u = 0; u < kKeyStep; ++u) {
      float acc = 0.f;
      if (j0 + u < p.window) {
        const float* kr = kb + (key0 + j0 + u) * p.k_sl;
#pragma unroll
        for (int d = 0; d < DPT; d += 2) {
          const float2 t = __ldg(reinterpret_cast<const float2*>(kr + d));
          acc = fmaf(q[d], t.x, acc);
          acc = fmaf(q[d + 1], t.y, acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      s[u] = j0 + u < p.window ? acc * p.scale : -INFINITY;
    }
    float mx = m;
#pragma unroll
    for (int u = 0; u < kKeyStep; ++u) mx = fmaxf(mx, s[u]);
    const float alpha = expf(m - mx);  // m == -inf at the first step: 0
    m = mx;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DPT; ++d) o[d] *= alpha;
#pragma unroll
    for (int u = 0; u < kKeyStep; ++u) {
      if (j0 + u >= p.window) continue;
      const float pr = expf(s[u] - m);
      l += pr;
      const float* vr = vb + (key0 + j0 + u) * p.v_sl;
#pragma unroll
      for (int d = 0; d < DPT; d += 2) {
        const float2 t = __ldg(reinterpret_cast<const float2*>(vr + d));
        o[d] = fmaf(pr, t.x, o[d]);
        o[d + 1] = fmaf(pr, t.y, o[d + 1]);
      }
    }
  }
  if (!live) return;
  const float inv = 1.f / l;
  float* orow = p.o + b * p.o_sb + h * p.o_sh + row * p.o_sl + part * DPT;
#pragma unroll
  for (int d = 0; d < DPT; d += 2)
    *reinterpret_cast<float2*>(orow + d) = make_float2(o[d] * inv, o[d + 1] * inv);
}

template <int DPT>
cudaError_t launch_attention(const AttnF32Params& p, int batch, int heads, cudaStream_t s) {
  const dim3 grid((p.len_q + kAttnRows - 1) / kAttnRows, heads, batch);
  attention_f32_kernel<DPT><<<grid, kAttnThreads, 0, s>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
}  // namespace rga3

// Plain C entry points for ctypes, on CUDA device `device` (device.cuh).
// Leading dims and strides are in elements. Each returns a cudaError_t (0 on
// success).

// K and lda, ldw multiples of 4, a and w 16-byte aligned (the wrapper checks);
// res given for the residual epilogues (3: res + (acc + b), 4: (res + b) +
// acc). M / 128 < 65536.
extern "C" int rga3_gemm_f32(int device, const void* a, int64_t lda, const void* w, int64_t ldw,
                             const void* bias, const void* res, int64_t ldr, void* out,
                             int64_t ldo, int m, int n, int k, int epilogue, void* stream) {
  using namespace rga3;
  if (const cudaError_t err = use_device(device); err != cudaSuccess) return err;
  const bool needs_res = epilogue == kResRounded || epilogue == kResF32;
  if (m <= 0 || n <= 0 || k <= 0 || k % 4 || lda % 4 || ldw % 4 || bias == nullptr ||
      (needs_res && res == nullptr) || !aligned16(a) || !aligned16(w))
    return cudaErrorInvalidValue;
  GemmF32Params p;
  p.a = static_cast<const float*>(a);
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.res = static_cast<const float*>(res);
  p.out = static_cast<float*>(out);
  p.lda = lda, p.ldw = ldw, p.ldr = ldr, p.ldo = ldo;
  p.m = m, p.n = n, p.k = k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kBias: return launch_gemm<kBias>(p, s);
    case kGeluTanh: return launch_gemm<kGeluTanh>(p, s);
    case kGeluErf: return launch_gemm<kGeluErf>(p, s);
    case kResRounded: return launch_gemm<kResRounded>(p, s);
    case kResF32: return launch_gemm<kResF32>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

// d, ldx and ldy multiples of 4; x, y, g and b 16-byte aligned.
extern "C" int rga3_layer_norm_f32(int device, const void* x, int64_t ldx, const void* g,
                                   const void* b, void* y, int64_t ldy, int rows, int d,
                                   float eps, void* stream) {
  using namespace rga3;
  if (const cudaError_t err = use_device(device); err != cudaSuccess) return err;
  if (rows <= 0 || d <= 0 || d % 4 || ldx % 4 || ldy % 4 || !aligned16(x) || !aligned16(y) ||
      !aligned16(g) || !aligned16(b))
    return cudaErrorInvalidValue;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  layer_norm_f32_kernel<<<blocks, kRowsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), ldx, static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<float*>(y), ldy, rows, d, eps);
  return cudaGetLastError();
}

// out_rows pooled tokens (a multiple of (ws/2)^2); ws even; c, ldx and ldy
// multiples of 4; x and y 16-byte aligned.
extern "C" int rga3_window_pool2x2_f32(int device, const void* x, int64_t ldx, void* y,
                                       int64_t ldy, int64_t out_rows, int ws, int c,
                                       void* stream) {
  using namespace rga3;
  if (const cudaError_t err = use_device(device); err != cudaSuccess) return err;
  if (out_rows <= 0 || ws < 2 || ws % 2 || c <= 0 || c % 4 || ldx % 4 || ldy % 4 ||
      out_rows % ((ws / 2) * (ws / 2)) || !aligned16(x) || !aligned16(y))
    return cudaErrorInvalidValue;
  const int64_t work = out_rows * (c / 4);
  const int64_t blocks = (work + kPoolThreads - 1) / kPoolThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  window_pool_f32_kernel<<<static_cast<unsigned>(blocks), kPoolThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), ldx, static_cast<float*>(y), ldy, out_rows, ws, c);
  return cudaGetLastError();
}

// q (B, len / window * q_window, H, D), k and v (B, len, H, D), o like q;
// query window w (q_window rows) attends to key window w (`window` keys);
// window == len and q_window == the query length give global attention.
// D in {16, 72, 80, 128}; 8-byte aligned rows (pointers and strides even).
extern "C" int rga3_attention_f32(int device, const void* q, const void* k, const void* v,
                                  void* o, int batch, int len, int heads, int head_dim,
                                  int window, int q_window, int64_t q_sb, int64_t q_sl,
                                  int64_t q_sh, int64_t k_sb, int64_t k_sl, int64_t k_sh,
                                  int64_t v_sb, int64_t v_sl, int64_t v_sh, int64_t o_sb,
                                  int64_t o_sl, int64_t o_sh, float scale, void* stream) {
  using namespace rga3;
  if (const cudaError_t err = use_device(device); err != cudaSuccess) return err;
  if (batch <= 0 || heads <= 0 || window <= 0 || len % window || q_window <= 0)
    return cudaErrorInvalidValue;
  for (const int64_t st : {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, o_sb, o_sl, o_sh})
    if (st % 2) return cudaErrorInvalidValue;
  for (const void* ptr : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(ptr) % 8) return cudaErrorInvalidValue;
  AttnF32Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.q_sb = q_sb, p.q_sl = q_sl, p.q_sh = q_sh;
  p.k_sb = k_sb, p.k_sl = k_sl, p.k_sh = k_sh;
  p.v_sb = v_sb, p.v_sl = v_sl, p.v_sh = v_sh;
  p.o_sb = o_sb, p.o_sl = o_sl, p.o_sh = o_sh;
  p.len_q = len / window * q_window;
  p.window = window;
  p.q_window = q_window;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch_attention<4>(p, batch, heads, s);
    case 72: return launch_attention<18>(p, batch, heads, s);
    case 80: return launch_attention<20>(p, batch, heads, s);
    case 128: return launch_attention<32>(p, batch, heads, s);
    default: return cudaErrorInvalidValue;
  }
}

// Tiled bf16 matrix product with fused epilogues, for Hopper (sm_90a), on
// the tensor cores through mma.sync.m16n8k16.
//
//   out[m, n] = epilogue(sum_k A[m, k] * W[n, k] + bias[n])
//
// A is (M, K) and W is (N, K), nn.Linear's layout, and bias is (N), all
// bf16 with the K dim contiguous; products and the bias add are in f32.
//   epilogue: kBias     out = bf16(acc + b)
//             kGelu*    out = bf16(gelu(f32(bf16(acc + b)))), tanh or erf form
//             kResBf16  out = bf16(res + bf16(acc + b))   (a bf16 residual add)
//             kResF32   out = bf16(f32(res) + b + acc)    (the residual in f32)
//
// Replaces the matrix products of the Pallas TPU kernels in
// rga3_tpu/ops/fused_block.py, with the same rounding points as their bodies:
// `_fused_kernel` (:105) and `_transition_kernel` (:917) (qkv and proj,
// attn proj + residual, MLP + residual), `_ln_matmul_kernel` (:312),
// `_proj_mlp_kernel` (:324), the product of `_proj_ln_kernel` (:543) and
// `_mlp_blocked_kernel` (:583). Those kernels keep a whole block's weights
// resident in VMEM and chain every product of a transformer block in one
// kernel. On the H100 even one stage-3 block's 8 MB of bf16 weights is 36
// times a block's shared memory, so the port chains this kernel, the
// LayerNorm kernel of row_ops.cu (whose bf16 output is the operand the
// Pallas bodies multiply) and the attention kernels through device memory,
// one launch per product.
//
// What bounds it on the H100: a product does 2*M*N*K flops on
// 2*(M*K + N*K + M*N) bytes; with K = 144 or 288 (Hiera stages 1-2) and
// M ~ 10^5-10^6 tokens that is ~100-200 flops per byte, under the card's
// ~295 flop/byte balance point, so those products are bound by bytes; with
// K >= 576 (stages 3-4) they are bound by operations. The design is the
// classic one for mma.sync: a 128x128 output tile per block of 8 warps
// (each 64x32; two blocks to an SM, registers capped at 128 a thread), K in
// steps of 32 through a 4-stage ring of shared memory filled by cp.async, so
// three tiles' loads are in flight while the tensor cores work on a fourth;
// fragments are read with ldmatrix from rows padded to 80 bytes, free of
// bank conflicts. No TMA or wgmma yet: that is for the change that makes it
// fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rga3 {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;           // 8 warps: 2 along M x 4 along N
constexpr int kLds = kBK + 8;           // smem row, in bf16: 80 bytes
constexpr int kChunks = kBM * kBK / 8;  // 16-byte chunks per tile (512)
constexpr int kStages = 4;              // cp.async ring depth
constexpr int kStageElems = (kBM + kBN) * kLds;
constexpr int kSmemBytes = kStages * kStageElems * 2;  // 80 KB: dynamic shared memory

enum Epilogue { kBias = 0, kGeluTanh = 1, kGeluErf = 2, kResBf16 = 3, kResF32 = 4 };

struct GemmParams {
  const bf16* a;
  const bf16* w;
  const bf16* bias;  // (N)
  const bf16* res;    // (M, N) residual for kResBf16 / kResF32
  bf16* out;
  int64_t lda, ldw, ldr, ldo;
  int m, n, k;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(kBeta * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void cp_async16(bf16* smem, const bf16* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
}

// The 16-byte chunks of one A and one W tile this thread copies: chunk
// c = threadIdx.x + i * kThreads is row c / 4, columns (c % 4) * 8 + [0, 8).
// Chunks past M, N or K are zero-filled (K % 8 == 0: a chunk is all in or
// all out).
__device__ __forceinline__ void load_stage(const GemmParams& p, int m0, int n0, int k0,
                                           bf16* as, bf16* ws) {
  const int kc = (threadIdx.x & 3) * 8;
  const int kk = k0 + kc;
  const bool kin = kk < p.k;
#pragma unroll
  for (int i = 0; i < kChunks / kThreads; ++i) {
    const int r = (threadIdx.x + i * kThreads) >> 2;
    const bool a_in = kin && m0 + r < p.m, w_in = kin && n0 + r < p.n;
    cp_async16(as + r * kLds + kc, a_in ? p.a + (m0 + r) * p.lda + kk : p.a, a_in);
    cp_async16(ws + r * kLds + kc, w_in ? p.w + (n0 + r) * p.ldw + kk : p.w, w_in);
  }
}

template <int EPI>
__device__ __forceinline__ __nv_bfloat162 epilogue(const GemmParams& p, float acc0, float acc1,
                                                   int row, int col) {
  const float b0 = __bfloat162float(p.bias[col]), b1 = __bfloat162float(p.bias[col + 1]);
  if (EPI == kBias) return __floats2bfloat162_rn(acc0 + b0, acc1 + b1);
  if (EPI == kGeluTanh)
    return __floats2bfloat162_rn(gelu_tanh(round_bf16(acc0 + b0)),
                                 gelu_tanh(round_bf16(acc1 + b1)));
  if (EPI == kGeluErf)
    return __floats2bfloat162_rn(gelu_erf(round_bf16(acc0 + b0)),
                                 gelu_erf(round_bf16(acc1 + b1)));
  const float2 r = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(p.res + row * p.ldr + col));
  if (EPI == kResBf16)
    return __floats2bfloat162_rn(r.x + round_bf16(acc0 + b0), r.y + round_bf16(acc1 + b1));
  return __floats2bfloat162_rn(r.x + b0 + acc0, r.y + b1 + acc1);  // kResF32
}

template <int EPI>
__global__ void __launch_bounds__(kThreads, 2) gemm_kernel(GemmParams p) {
  extern __shared__ uint4 smem4[];  // kStages x (A tile, W tile)
  bf16* smem = reinterpret_cast<bf16*>(smem4);

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64, cols wn*32
  const int ktiles = (p.k + kBK - 1) / kBK;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(p, m0, n0, s * kBK, smem + s * kStageElems,
                               smem + s * kStageElems + kBM * kLds);
    cp_async_commit();
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int kt = 0; kt < ktiles; ++kt) {
    bf16* as = smem + (kt % kStages) * kStageElems;
    bf16* ws = as + kBM * kLds;
    cp_async_wait_pending();  // this thread's copies of tile kt have landed
    __syncthreads();  // everyone's have; and tile kt - 1's stage is consumed
    const int next = kt + kStages - 1;
    if (next < ktiles) {
      bf16* an = smem + (next % kStages) * kStageElems;
      load_stage(p, m0, n0, next * kBK, an, an + kBM * kLds);
    }
    cp_async_commit();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], as + (wm * 64 + mi * 16 + (lane & 15)) * kLds + ks * 16 +
                                (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, ws + (wn * 32 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLds +
                           ks * 16 + ((lane >> 3) & 1) * 8);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
  }

  // accumulator fragment: c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g+8
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;
      if (col >= p.n) continue;  // N is even: col + 1 < N too
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 64 + mi * 16 + (lane >> 2) + half * 8;
        if (row >= p.m) continue;
        *reinterpret_cast<__nv_bfloat162*>(p.out + row * p.ldo + col) =
            epilogue<EPI>(p, acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1], row, col);
      }
    }
  }
}

template <int EPI>
cudaError_t launch_one(const GemmParams& p, cudaStream_t stream) {
  static const cudaError_t set = cudaFuncSetAttribute(
      gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (set != cudaSuccess) return set;
  const dim3 grid((p.n + kBN - 1) / kBN, (p.m + kBM - 1) / kBM);
  gemm_kernel<EPI><<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch(const GemmParams& p, int epi, cudaStream_t stream) {
  switch (epi) {
    case kBias: return launch_one<kBias>(p, stream);
    case kGeluTanh: return launch_one<kGeluTanh>(p, stream);
    case kGeluErf: return launch_one<kGeluErf>(p, stream);
    case kResBf16: return launch_one<kResBf16>(p, stream);
    case kResF32: return launch_one<kResF32>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace rga3

// Plain C entry point for ctypes. Leading dims are in elements. K must be a
// multiple of 8, N even, lda and ldw multiples of 8, ldr and ldo even, a and
// w 16-byte aligned; bias bf16 (N); res given for the residual epilogues. M
// up to 65535 * 128 rows. Returns a cudaError_t (0 on success).
extern "C" int rga3_gemm_bf16(const void* a, int64_t lda, const void* w, int64_t ldw,
                              const void* bias, const void* res, int64_t ldr, void* out,
                              int64_t ldo, int m, int n, int k, int epilogue, void* stream) {
  using namespace rga3;
  const bool needs_res = epilogue == kResBf16 || epilogue == kResF32;
  if (m <= 0 || n <= 0 || k <= 0 || k % 8 || n % 2 || lda % 8 || ldw % 8 || ldo % 2 ||
      (needs_res && (res == nullptr || ldr % 2)) || bias == nullptr ||
      (m + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  GemmParams p;
  p.a = static_cast<const bf16*>(a);
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const bf16*>(bias);
  p.res = static_cast<const bf16*>(res);
  p.out = static_cast<bf16*>(out);
  p.lda = lda;
  p.ldw = ldw;
  p.ldr = ldr;
  p.ldo = ldo;
  p.m = m;
  p.n = n;
  p.k = k;
  return launch(p, epilogue, static_cast<cudaStream_t>(stream));
}

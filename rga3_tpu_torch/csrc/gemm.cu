// Tiled bf16 matrix product with fused epilogues, for Hopper (sm_90a), on
// the tensor cores through TMA and wgmma.
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
// K >= 576 (stages 3-4) they are bound by operations, and only wgmma reaches
// the tensor cores' full rate. The design is Hopper's usual one: a
// persistent grid of one block an SM walks the 128 x 144 output tiles (N
// fastest, so that a 128-row band of A is read once from device memory
// while W stays in the L2 cache). In each block one producer thread
// issues TMA loads (cp.async.bulk.tensor.2d, 128-byte swizzle) of the A and
// W tiles of each 64-deep K step into a 4-stage ring guarded by
// mbarriers (full: the bytes landed; empty: both consumers are done with
// the stage); two consumer warpgroups each run wgmma.mma_async.m64n144k16 on
// 64 rows of the tile, A and W read from shared memory through swizzled
// descriptors, with one K step's group in flight while the next is issued.
// The epilogue reads the accumulators, whose per-warp layout is mma.sync's
// m16n8 one, while the producer already loads the next tile: the rounded
// sums (and GELU) go to shared memory (rows padded by 16 bytes) and leave in
// coalesced 16-byte stores, the bf16 residual read in the same pieces, all
// of a thread's loads in flight at once; the f32 residual is added to the
// fragments in place. setmaxnreg moves registers from the producer
// warpgroup to the consumers.
// TMA zero-fills the ragged edges in M, N and K (K = 144 = 2 * 64 + 16).
// The tile is 144 wide at every call: each Hiera-L N (144 to 4608) is a
// multiple of 144, and tiles 192 or 256 wide, chosen per call where they
// fit, were no faster over the main path's products (tools/
// bench_gemm_tiles.py on an H100 80GB HBM3 at 700 W: 35.33 ms of products
// a segmentation call at 144 alone, 35.53 choosing among 256/192/144).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_wgmma.cuh"  // mbarriers, TMA loads, the wgmma descriptor, the map encoder

namespace rga3 {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBK = 64;  // a K step is one 128-byte swizzled row
constexpr int kConsumers = 2;       // warpgroups of wgmma, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);  // and the producer warpgroup
constexpr int kABytes = kBM * kBK * 2;

constexpr int kBN = 144;     // the output tile's width
constexpr int kStages = 4;   // the TMA ring
constexpr int kStageBytes = kABytes + kBN * kBK * 2;  // a multiple of 1024
// a consumer's 64 output rows staged for coalesced stores, rows padded by 16
// bytes so that the accumulator writes of a warp miss each other's banks
constexpr int kStagePitch = kBN + 8;
constexpr int kOutBytes = 64 * kStagePitch * 2;
// the ring, the two output tiles, the mbarriers, and slack to align the ring
// to 1024 bytes
constexpr int kSmemBytes =
    kStages * kStageBytes + kConsumers * kOutBytes + 2 * kStages * 8 + 1024;

enum Epilogue { kBias = 0, kGeluTanh = 1, kGeluErf = 2, kResBf16 = 3, kResF32 = 4 };

struct GemmParams {
  const bf16* bias;  // (N)
  const bf16* res;   // (M, N) residual for kResBf16 / kResF32
  bf16* out;
  int64_t ldr, ldo;
  int m, n, k;
};

// d += A B^T over one k16 step: A 64 x 16 and B 144 x 16 from shared memory.
__device__ __forceinline__ void wgmma_m64n144k16(float (&d)[72], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %74, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71"
        "}, %72, %73, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
        : "l"(da), "l"(db), "r"(1));
}


// 0.5 x (1 + tanh(u)) written as x * sigmoid(2u): one exponential and one
// division, ~1e-7 relative, with no cancellation where tanh(u) nears -1
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float u = kBeta * (x + 0.044715f * x * x * x);
  return __fdividef(x, 1.f + __expf(-2.f * u));
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

// bf16(x + y) of two pairs of bf16, added in f32
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t x, uint32_t y) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y));
  const __nv_bfloat162 c = __floats2bfloat162_rn(a.x + b.x, a.y + b.y);
  return *reinterpret_cast<const uint32_t*>(&c);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One pair of columns of the epilogue from the f32 sums, before any
// residual: bf16(acc + b), or bf16(gelu(f32(bf16(acc + b)))).
template <int EPI>
__device__ __forceinline__ __nv_bfloat162 rounded_sum(float acc0, float acc1, float b0,
                                                      float b1) {
  if (EPI == kGeluTanh)
    return __floats2bfloat162_rn(gelu_tanh(round_bf16(acc0 + b0)),
                                 gelu_tanh(round_bf16(acc1 + b1)));
  if (EPI == kGeluErf)
    return __floats2bfloat162_rn(gelu_erf(round_bf16(acc0 + b0)),
                                 gelu_erf(round_bf16(acc1 + b1)));
  return __floats2bfloat162_rn(acc0 + b0, acc1 + b1);
}

template <int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_w, GemmParams p) {
  constexpr int kChunks = kBN / 8, kIters = 64 * kChunks / 128;  // 16-byte pieces
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // the swizzle repeats every 1024 bytes
  bf16* staged = reinterpret_cast<bf16*>(smem_raw + (ring - raw) + kStages * kStageBytes);
  const uint32_t full = ring + kStages * kStageBytes + kConsumers * kOutBytes;
  const uint32_t empty = full + kStages * 8;

  const int n_tiles = (p.n + kBN - 1) / kBN;
  const int tiles = (p.m + kBM - 1) / kBM * n_tiles;
  const int ktiles = (p.k + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);                // the producer's expect_tx
      mbar_init(empty + 8 * s, 4 * kConsumers);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * kBM, n0 = tile % n_tiles * kBN;
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(empty + 8 * stage, phase ^ 1);  // a fresh barrier passes at once
          mbar_expect_tx(full + 8 * stage, kStageBytes);  // whole boxes, zero-filled edges included
          const uint32_t dst = ring + stage * kStageBytes;
          tma_load(dst, &map_a, kt * kBK, m0, full + 8 * stage);
          tma_load(dst + kABytes, &map_w, kt * kBK, n0, full + 8 * stage);
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: rows 64 * cw of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = threadIdx.x / 128 - 1, ct = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, wq = ct >> 5;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  bf16* out_rows = staged + cw * 64 * kStagePitch;
  // 16-byte pieces need 16-byte aligned rows (the pointers are, by the wrapper)
  const bool vec = p.ldo % 8 == 0 && (EPI != kResBf16 || p.ldr % 8 == 0);
  int stage = 0, phase = 0;
  float acc[kBN / 2];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * kBM, n0 = tile % n_tiles * kBN;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    // products: one k step's wgmma group stays in flight while the next is
    // issued; a stage goes back to the producer once its group is done
    int prev = -1;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(full + 8 * stage, phase);
      const uint32_t a = ring + stage * kStageBytes + cw * 64 * 128;  // 64 rows of 128 bytes
      const uint32_t w = ring + stage * kStageBytes + kABytes;
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k16 = 0; k16 < kBK / 16; ++k16)  // 32 bytes along the swizzled rows
        wgmma_m64n144k16(acc, sw128_desc(a + 32 * k16), sw128_desc(w + 32 * k16));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(acc);
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      }
      prev = stage;
      if (++stage == kStages) stage = 0, phase ^= 1;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * prev);

    // accumulator layout per warp: n8 tile j holds (row g, cols 2t, 2t+1)
    // in acc[4j], acc[4j + 1] and row g + 8 in acc[4j + 2], acc[4j + 3]
    if constexpr (EPI == kResF32) {  // out = bf16(res + b + acc), in place
      const int row0 = m0 + cw * 64 + wq * 16 + g;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + t2;
        if (col >= p.n) continue;  // N is even: col + 1 < N too
        const float b0 = __bfloat162float(p.bias[col]), b1 = __bfloat162float(p.bias[col + 1]);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row0 + 8 * half;
          if (row >= p.m) continue;
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(p.res + (int64_t)row * p.ldr + col));
          *reinterpret_cast<__nv_bfloat162*>(p.out + (int64_t)row * p.ldo + col) =
              __floats2bfloat162_rn(r.x + b0 + acc[4 * j + 2 * half],
                                    r.y + b1 + acc[4 * j + 2 * half + 1]);
        }
      }
    } else {
      // the bf16 residual's pieces first, all in flight at once, so that
      // their latency is paid once and under the writes to shared memory
      uint4 x[EPI == kResBf16 ? kIters : 1];
      if constexpr (EPI == kResBf16) {
        if (vec) {
#pragma unroll
          for (int i = 0; i < kIters; ++i) {
            const int c = ct + 128 * i, r = c / kChunks, col = n0 + 8 * (c % kChunks);
            const int row = m0 + cw * 64 + r;
            if (row < p.m && col + 8 <= p.n)
              x[i] = __ldg(reinterpret_cast<const uint4*>(p.res + (int64_t)row * p.ldr + col));
          }
        }
      }
      bar_sync(1 + cw, 128);  // the previous tile's rows are out
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + t2;
        if (col >= p.n) continue;
        const float b0 = __bfloat162float(p.bias[col]), b1 = __bfloat162float(p.bias[col + 1]);
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<__nv_bfloat162*>(out_rows + (wq * 16 + g + 8 * half) * kStagePitch +
                                             8 * j + t2) =
              rounded_sum<EPI>(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1], b0, b1);
      }
      bar_sync(1 + cw, 128);
      // the rows out in 16-byte pieces: out = the staged value, plus the
      // bf16 residual rounded once more (bf16(res + bf16(acc + b)))
#pragma unroll
      for (int i = 0; i < kIters; ++i) {
        const int c = ct + 128 * i, r = c / kChunks, col = n0 + 8 * (c % kChunks);
        const int row = m0 + cw * 64 + r;
        if (row >= p.m || col >= p.n) continue;
        const bf16* src = out_rows + r * kStagePitch + (col - n0);
        bf16* dst = p.out + (int64_t)row * p.ldo + col;
        if (vec && col + 8 <= p.n) {
          uint4 h = *reinterpret_cast<const uint4*>(src);
          if constexpr (EPI == kResBf16)
            h = make_uint4(add_bf16x2(x[i].x, h.x), add_bf16x2(x[i].y, h.y),
                           add_bf16x2(x[i].z, h.z), add_bf16x2(x[i].w, h.w));
          *reinterpret_cast<uint4*>(dst) = h;
          continue;
        }
        // N or a row stride off a multiple of 8: pairs
        for (int e = 0; e < 8 && col + e < p.n; e += 2) {
          uint32_t h = *reinterpret_cast<const uint32_t*>(src + e);
          if (EPI == kResBf16)
            h = add_bf16x2(*reinterpret_cast<const uint32_t*>(p.res + (int64_t)row * p.ldr +
                                                              col + e),
                           h);
          *reinterpret_cast<uint32_t*>(dst + e) = h;
        }
      }
    }
  }
}

// The tensor map of a (rows, k) bf16 matrix with row stride `ld` elements,
// read in boxes of `box_rows` x 64 in the 128-byte swizzle; out of range
// reads are zeros.
bool make_map(CUtensorMap* map, const void* ptr, int rows, int k, int64_t ld, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int EPI>
cudaError_t launch(const GemmParams& p, const void* a, int64_t lda, const void* w,
                   int64_t ldw, cudaStream_t stream) {
  static const cudaError_t set = cudaFuncSetAttribute(
      gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (set != cudaSuccess) return set;
  CUtensorMap map_a, map_w;
  if (!make_map(&map_a, a, p.m, p.k, lda, kBM) || !make_map(&map_w, w, p.n, p.k, ldw, kBN))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (int64_t)(p.m + kBM - 1) / kBM * ((p.n + kBN - 1) / kBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  gemm_kernel<EPI><<<grid, kThreads, kSmemBytes, stream>>>(map_a, map_w, p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rga3

// Plain C entry point for ctypes. Leading dims are in elements. K must be a
// multiple of 8, N even, lda and ldw multiples of 8, ldr and ldo even; a, w
// and out 16-byte aligned (TMA reads a and w), which the wrapper checks; bias
// bf16 (N); res given for the residual epilogues. M, N < 2^31. Returns a
// cudaError_t (0 on success).
extern "C" int rga3_gemm_bf16(const void* a, int64_t lda, const void* w, int64_t ldw,
                              const void* bias, const void* res, int64_t ldr, void* out,
                              int64_t ldo, int m, int n, int k, int epilogue, void* stream) {
  using namespace rga3;
  const bool needs_res = epilogue == kResBf16 || epilogue == kResF32;
  if (m <= 0 || n <= 0 || k <= 0 || k % 8 || n % 2 || lda % 8 || ldw % 8 || ldo % 2 ||
      (needs_res && (res == nullptr || ldr % 2)) || bias == nullptr ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  GemmParams p;
  p.bias = static_cast<const bf16*>(bias);
  p.res = static_cast<const bf16*>(res);
  p.out = static_cast<bf16*>(out);
  p.ldr = ldr;
  p.ldo = ldo;
  p.m = m;
  p.n = n;
  p.k = k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kBias: return launch<kBias>(p, a, lda, w, ldw, s);
    case kGeluTanh: return launch<kGeluTanh>(p, a, lda, w, ldw, s);
    case kGeluErf: return launch<kGeluErf>(p, a, lda, w, ldw, s);
    case kResBf16: return launch<kResBf16>(p, a, lda, w, ldw, s);
    case kResF32: return launch<kResF32>(p, a, lda, w, ldw, s);
    default: return cudaErrorInvalidValue;
  }
}

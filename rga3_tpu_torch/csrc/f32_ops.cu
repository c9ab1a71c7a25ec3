// f32 variants of the Hiera encoder's kernels for Hopper (sm_90a).
//
// Under f32 parameters (the train entry point's `--param_dtype float32`,
// its release default) the JAX package computes the frozen SAM2 image
// encoder and the SAM2 decoder's attention in f32: flax promotes the bf16
// frames to the f32 parameters, and the Pallas kernels compute in their
// inputs' dtype (`xb.dtype` throughout `_fused_kernel`,
// rga3_tpu/ops/fused_block.py:105-176, and the attention bodies of
// rga3_tpu/ops/attention.py:75,228). These entry points are the same
// functions as the bf16 kernels of gemm.cu, row_ops.cu, window_attention.cu
// and flash_attention.cu, at f32 wherever the JAX body rounds to `xb.dtype`:
//
//   * rga3_gemm_f32: out[m, n] = epilogue(sum_k A[m, k] W[n, k] + bias[n]),
//     with gemm.cu's epilogues (bias; tanh or erf GELU of acc + b; residual
//     + (acc + b); (residual + b) + acc), A (M, K), W (N, K): the products of
//     `_fused_kernel` (:105), `_ln_matmul_kernel` (:312), `_proj_mlp_kernel`
//     (:324), `_proj_ln_kernel` (:543), `_mlp_blocked_kernel` (:583) and
//     `_transition_kernel` (:917);
//   * rga3_layer_norm_f32: LayerNorm over rows of D, two-pass statistics;
//   * rga3_window_pool2x2_f32: the 2x2 max inside each ws x ws window of
//     window-major tokens;
//   * rga3_attention_f32: softmax(q k^T * scale) v over a key range per
//     query row: block-diagonal windows (`window` keys for each `q_window`
//     queries, the pooled queries of the q-pool transition included;
//     `_local_flash_kernel`, attention.py:228) or, with one window over every
//     key, the non-causal flash forward of Hiera's global blocks and the
//     SAM2 decoder (`_flash_kernel`, attention.py:75).
//
// 3xTF32. The GEMM and the attention run their products on the tensor cores
// in TF32 (10 explicit mantissa bits), split so that the result keeps f32's
// accuracy. Each f32 operand x becomes two TF32 values, both rounded to
// nearest with `cvt.rna.tf32.f32`:
//     hi = rna_tf32(x),   lo = rna_tf32(x - hi)      (x - hi is exact)
// so |x - hi - lo| <= 2^-11 |x - hi| <= 2^-22 |x|. A product is then
//     a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi
// three TF32 products, each exact in the tensor cores' f32 accumulators;
// the dropped a_lo b_lo and the two roundings leave ~3 * 2^-22 |a b| a term,
// against f32's own 2^-24 rounding of each sum: per output row the kernels
// stay within ~1e-6 of the row's largest value at K = 4608 and at 4096 keys
// (tests/test_torch_f32_split.py models this arithmetic on the CPU; one TF32
// product a term misses 1e-4 there). The split is written out in these
// kernels, so their accuracy does not depend on
// `torch.backends.cuda.matmul.allow_tf32` or `ops/precision.exact_f32`,
// which only steer PyTorch's own products.
//
// What bounds them on the H100: the encoder's products (K = 144 to 4608,
// M ~ 10^4-10^6 tokens) do 2 M N K flops, three TF32 products each, on
// 4 (MK + NK + MN) bytes: against 495 / 3 = 165 TFLOP/s of f32-accurate
// products and 3.35 TB/s they are bound by operations (the CUDA cores' f32
// peak is 67 TFLOP/s). The attention's global calls (4096 keys) are bound
// by operations, its windows of 64 keys by bytes.
//
// The GEMM is gemm.cu's Hopper design in f32: a persistent grid walks the
// 128 x 144 output tiles (N fastest); thread 0 of the producer warpgroup
// issues TMA loads (128-byte swizzle: 32 f32 of K a row) of the A and W
// tiles of each 32-deep K step into a 4-stage mbarrier ring; warps 1-3 of
// that warpgroup split each landed W tile in shared memory (hi in place, lo
// beside it) and signal a second barrier; the two consumer warpgroups read
// their 64 rows of A from the swizzled tile into registers, split them
// there, and issue wgmma.m64n144k8 tf32 three times a k8 step with A from
// registers (lo_a hi_w, hi_a lo_w, hi_a hi_w), one K step's group in flight
// while the next is issued. The f32 epilogue runs on the accumulators in
// place. TMA zero-fills the ragged edges in M, N and K (K = 144 = 4 * 32 +
// 16).
//
// Accumulation. The tensor cores round each MMA's f32 sum toward zero, so
// the error of one accumulator grows with the number of MMAs it sums, with
// a sign (measured on an H100: 4.5e-5 of a row at K = 4608 with one
// accumulator for all of K, against ~1e-6 for round-to-nearest). The GEMM
// sums 4 K steps (48 wgmma) in one accumulator and adds it to the running
// sum in FADDs; the attention sums a 64-key tile's P V (24 MMAs) apart and
// adds it to O in an FFMA.
//
// The attention is the FlashAttention-2 tile of attention_mma.cuh on
// mma.sync.m16n8k8 tf32: a block of 4 warps owns 64 query rows, 16 a warp;
// K and V tiles of 64 keys stage through a 2-stage cp.async ring (read from
// device memory once for the block's 64 rows); Q is split once into hi and
// lo (in shared memory from D = 72 on); each k8 step of S = Q K^T and each
// key chunk of P V splits the K or V fragments it reads, then runs each of
// its three products over the step's independent accumulators in turn; the
// online softmax runs in f32 registers. The k index of both products is permuted within each
// 8-wide step (k = t <-> 2t, k = t + 4 <-> 2t + 1), which the sums do not
// see: Q and K fragments are then 8-byte loads, and P's A fragment is the
// S accumulator's own registers, so no shuffle is needed.
//
// The row kernels are bound by bytes (one warp a row, 16-byte pieces).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"  // cp.async, exp2, the score-row reductions
#include "device.cuh"         // use_device, PerDevice
#include "tma_wgmma.cuh"      // mbarriers, TMA loads, the wgmma descriptor, the map encoder

namespace rga3 {
namespace {

// ---------------------------------------------------------------------------
// the 3xTF32 split
// ---------------------------------------------------------------------------

// x rounded to TF32, to nearest with ties away from zero: f32 bits whose
// low 13 bits are zero
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to 2^-22 |x|, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// ---------------------------------------------------------------------------
// the GEMM
// ---------------------------------------------------------------------------

namespace gemm32 {
constexpr int kBM = 128, kBN = 144, kBK = 32;  // a K step: one 128-byte swizzled row
constexpr int kConsumers = 2;                  // warpgroups of wgmma, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);  // and the producer warpgroup
constexpr int kSplitThreads = 96;              // the producer warpgroup's warps 1-3
constexpr int kABytes = kBM * kBK * 4;         // 16 KB
constexpr int kWBytes = kBN * kBK * 4;         // 18 KB, split in place into its hi part
constexpr int kStageBytes = kABytes + 2 * kWBytes;  // A, W hi, W lo: 52 KB (1024-aligned)
constexpr int kStages = 4;
// K steps whose products one wgmma accumulator sums before they join the
// running sum (see the consumers)
constexpr int kPromote = 4;
// the ring, three barriers a stage, and slack to align the ring to 1024 bytes
constexpr int kSmemBytes = kStages * kStageBytes + 3 * kStages * 8 + 1024;
}  // namespace gemm32

enum Epilogue { kBias = 0, kGeluTanh = 1, kGeluErf = 2, kResRounded = 3, kResF32 = 4 };

struct GemmF32Params {
  const float* bias;  // (N)
  const float* res;   // (M, N), row stride ldr: the residual epilogues
  float* out;         // (M, N), row stride ldo
  int64_t ldr, ldo;
  int m, n, k;
};

__device__ __forceinline__ float gelu_tanh_f32(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(kBeta * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float gelu_erf_f32(float x) {
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

template <int EPI>
__device__ __forceinline__ float epilogue(float acc, float b, float res) {
  if (EPI == kGeluTanh) return gelu_tanh_f32(acc + b);
  if (EPI == kGeluErf) return gelu_erf_f32(acc + b);
  if (EPI == kResRounded) return res + (acc + b);
  if (EPI == kResF32) return (res + b) + acc;
  return acc + b;
}

// d = A B^T + (accumulate ? d : 0) over one k8 step: A 64 x 8 tf32 from
// registers (a warp's 16 rows: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3
// (g + 8, t + 4)), B 144 x 8 tf32 from shared memory.
__device__ __forceinline__ void wgmma_m64n144k8_tf32(float (&d)[72], const uint32_t (&a)[4],
                                                     uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, {%72, %73, %74, %75}, %76, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <int EPI>
__global__ void __launch_bounds__(gemm32::kThreads, 1)
    gemm_3xtf32_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_w, GemmF32Params p) {
  using namespace gemm32;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // the swizzle repeats every 1024 bytes
  uint8_t* const ring_ptr = smem_raw + (ring - raw);
  const uint32_t full = ring + kStages * kStageBytes;  // A and W landed
  const uint32_t split = full + kStages * 8;           // W split into hi and lo
  const uint32_t empty = split + kStages * 8;          // both consumers done with the stage

  const int n_tiles = (p.n + kBN - 1) / kBN;
  const int tiles = (p.m + kBM - 1) / kBM * n_tiles;
  const int ktiles = (p.k + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);                // the producer's expect_tx
      mbar_init(split + 8 * s, kSplitThreads);   // every splitting thread
      mbar_init(empty + 8 * s, 4 * kConsumers);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    int stage = 0, phase = 0;
    if (threadIdx.x == 0) {  // TMA: one thread issues every load
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * kBM, n0 = tile % n_tiles * kBN;
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(empty + 8 * stage, phase ^ 1);  // a fresh barrier passes at once
          mbar_expect_tx(full + 8 * stage, kABytes + kWBytes);  // whole boxes, edges zero-filled
          const uint32_t dst = ring + stage * kStageBytes;
          tma_load(dst, &map_a, kt * kBK, m0, full + 8 * stage);
          tma_load(dst + kABytes, &map_w, kt * kBK, n0, full + 8 * stage);
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
    } else if (threadIdx.x >= 32) {  // warps 1-3 split W: hi in place, lo beside it
      const int st = threadIdx.x - 32;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(full + 8 * stage, phase);
          float4* hi = reinterpret_cast<float4*>(ring_ptr + stage * kStageBytes + kABytes);
          float4* lo = hi + kWBytes / 16;
#pragma unroll
          for (int i = st; i < kWBytes / 16; i += kSplitThreads) {  // 12 pieces a thread
            const float4 x = hi[i];
            uint32_t h[4], l[4];
            split_tf32(x.x, h[0], l[0]);
            split_tf32(x.y, h[1], l[1]);
            split_tf32(x.z, h[2], l[2]);
            split_tf32(x.w, h[3], l[3]);
            hi[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                                __uint_as_float(h[2]), __uint_as_float(h[3]));
            lo[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                                __uint_as_float(l[2]), __uint_as_float(l[3]));
          }
          // the generic-proxy writes, visible to wgmma's (async proxy) reads
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(split + 8 * stage);
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
  const int g = lane >> 2, t = lane & 3;
  // float2 stores need even row strides (the pointers are 8-byte aligned)
  const bool vec = p.ldo % 2 == 0 && (EPI < kResRounded || p.ldr % 2 == 0);
  // this thread's A fragment in a stage's swizzled tile: row 64 cw + 16 wq +
  // g (and 8 rows on), whose 16-byte pieces are permuted by g (row % 8)
  const int a_row = (64 * cw + 16 * wq + g) * 128 + 4 * t;
  int stage = 0, phase = 0;
  // The tensor cores round the f32 sums of a wgmma toward zero, an error
  // that grows with the number of products summed into one accumulator:
  // `part` sums kPromote K steps (48 wgmma), which then join `acc` in FADDs
  // rounded to nearest.
  float acc[kBN / 2], part[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) part[i] = 0.f;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * kBM, n0 = tile % n_tiles * kBN;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    int prev = -1;  // the stage whose wgmma group is still in flight
    // K step kt: A's fragments split into `ah` / `al`, three wgmma a k8
    // step, one group left in flight, except at the end of a run of
    // kPromote steps, where `part` joins `acc`. wgmma reads `ah` / `al`
    // after it is issued, so consecutive steps take alternate arrays: a step
    // writes the arrays whose group the previous step's wait retired.
    auto k_step = [&](uint32_t (&ah)[kBK / 8][4], uint32_t (&al)[kBK / 8][4], int kt) {
      mbar_wait(full + 8 * stage, phase);
      mbar_wait(split + 8 * stage, phase);
      const uint8_t* a_s = ring_ptr + stage * kStageBytes + a_row;
      const uint32_t wh = ring + stage * kStageBytes + kABytes, wl = wh + kWBytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // k = 8 kk + t + 4 half: piece 2 kk + half
          const int piece = ((2 * kk + half) ^ g) << 4;
          split_tf32(*reinterpret_cast<const float*>(a_s + piece), ah[kk][2 * half],
                     al[kk][2 * half]);
          split_tf32(*reinterpret_cast<const float*>(a_s + piece + 8 * 128),
                     ah[kk][2 * half + 1], al[kk][2 * half + 1]);
        }
      fence_acc(part);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const int fresh = kt % kPromote == 0;  // the run's first step overwrites `part`
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {  // 32 bytes along the swizzled rows
        wgmma_m64n144k8_tf32(part, al[kk], sw128_desc(wh + 32 * kk), kk > 0 || !fresh);
        wgmma_m64n144k8_tf32(part, ah[kk], sw128_desc(wl + 32 * kk), 1);
        wgmma_m64n144k8_tf32(part, ah[kk], sw128_desc(wh + 32 * kk), 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (kt % kPromote == kPromote - 1 || kt == ktiles - 1) {
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(part);
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) acc[i] += part[i];
        __syncwarp();
        if (lane == 0) {
          if (prev >= 0) mbar_arrive(empty + 8 * prev);
          mbar_arrive(empty + 8 * stage);
        }
        prev = -1;
      } else {
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_acc(part);
        if (prev >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * prev);
        }
        prev = stage;
      }
      if (++stage == kStages) stage = 0, phase ^= 1;
    };
    uint32_t ah0[kBK / 8][4], al0[kBK / 8][4], ah1[kBK / 8][4], al1[kBK / 8][4];
    for (int kt = 0; kt < ktiles; kt += 2) {
      k_step(ah0, al0, kt);
      if (kt + 1 < ktiles) k_step(ah1, al1, kt + 1);
    }

    // accumulator layout per warp: n8 tile j holds (row g, cols 2t, 2t+1)
    // in acc[4j], acc[4j + 1] and row g + 8 in acc[4j + 2], acc[4j + 3]
    const int row0 = m0 + 64 * cw + 16 * wq + g;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= p.n) continue;
      const bool pair = col + 1 < p.n;
      const float b0 = p.bias[col], b1 = pair ? p.bias[col + 1] : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        if (row >= p.m) continue;
        float* dst = p.out + (int64_t)row * p.ldo + col;
        const float* res = EPI >= kResRounded ? p.res + (int64_t)row * p.ldr + col : nullptr;
        const float a0 = acc[4 * j + 2 * half], a1 = acc[4 * j + 2 * half + 1];
        if (pair && vec) {
          const float2 r = EPI >= kResRounded ? *reinterpret_cast<const float2*>(res)
                                              : make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(dst) =
              make_float2(epilogue<EPI>(a0, b0, r.x), epilogue<EPI>(a1, b1, r.y));
        } else {
          dst[0] = epilogue<EPI>(a0, b0, EPI >= kResRounded ? res[0] : 0.f);
          if (pair) dst[1] = epilogue<EPI>(a1, b1, EPI >= kResRounded ? res[1] : 0.f);
        }
      }
    }
  }
}

// The tensor map of a (rows, k) f32 matrix with row stride `ld` elements,
// read in boxes of `box_rows` x 32 in the 128-byte swizzle; out of range
// reads are zeros.
bool make_map_f32(CUtensorMap* map, const void* ptr, int rows, int k, int64_t ld,
                  int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  const cuuint32_t box[2] = {gemm32::kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int EPI>
cudaError_t launch_gemm(const GemmF32Params& p, const void* a, int64_t lda, const void* w,
                        int64_t ldw, cudaStream_t stream) {
  using namespace gemm32;
  static PerDevice smem_attr;
  const cudaError_t set = smem_attr.get([] {
    return cudaFuncSetAttribute(gemm_3xtf32_kernel<EPI>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  });
  if (set != cudaSuccess) return set;
  CUtensorMap map_a, map_w;
  if (!make_map_f32(&map_a, a, p.m, p.k, lda, kBM) || !make_map_f32(&map_w, w, p.n, p.k, ldw, kBN))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (int64_t)(p.m + kBM - 1) / kBM * ((p.n + kBN - 1) / kBN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  gemm_3xtf32_kernel<EPI><<<grid, kThreads, kSmemBytes, stream>>>(map_a, map_w, p);
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

namespace attn32 {
constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // query rows a block, 16 a warp
constexpr int kKeys = 64;      // keys a K/V tile

template <int D>
struct Dims {
  static constexpr int kSteps = D / 8;  // k8 steps of Q K^T, n8 tiles of P V
  // Q and K rows (floats): the 8-byte fragment loads of rows g = 0..3 of a
  // half-warp fall 8 banks apart when the stride is 8 mod 16
  static constexpr int kKStride = D % 16 == 8 ? D : D + 8;
  // V rows: the 4-byte loads of rows 2t (t = 0..3) fall 8 banks apart
  static constexpr int kVStride = D + 4;
  // from D = 72 on, Q's hi and lo fragments stay in shared memory and the
  // registers go to the O accumulators, the tile's partial sums and the
  // split fragments of eight independent MMA chains
  static constexpr bool kQSmem = D > 16;
  // n8 tiles of P V whose V fragments are split before their MMAs are issued
  static constexpr int kGroup = kSteps <= 10 ? kSteps : 8;
  static constexpr int kStageFloats = kKeys * (kKStride + kVStride);
  // the ring; at kQSmem the Q tile's hi rows and lo rows after it (else Q is
  // staged in stage 1's K rows until its fragments are in registers)
  static constexpr int kSmemFloats = 2 * kStageFloats + (kQSmem ? 2 * kRows * kKStride : 0);
};

// 8 bytes global -> shared; `valid` false writes zeros.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(mma_attn::smem_u32(smem)),
               "l"(gmem), "r"(valid ? 8 : 0));
}

// Copy rows [row0, row0 + 64) of a row-major f32 matrix (row stride `ld`)
// into shared rows of `stride` floats, in 16-byte pieces (`vec16`: the rows
// 16-byte aligned) or 8-byte ones; rows at or past `limit` are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(float* s, int stride, const float* g, int64_t ld,
                                          int row0, int limit, bool vec16) {
  if (vec16) {
    constexpr int C = D / 4;
#pragma unroll
    for (int i = threadIdx.x; i < kRows * C; i += kThreads) {
      const int r = i / C, c = i - r * C;
      const bool valid = row0 + r < limit;
      mma_attn::cp_async16(s + r * stride + 4 * c, valid ? g + (row0 + r) * ld + 4 * c : g, valid);
    }
  } else {
    constexpr int C = D / 2;
#pragma unroll
    for (int i = threadIdx.x; i < kRows * C; i += kThreads) {
      const int r = i / C, c = i - r * C;
      const bool valid = row0 + r < limit;
      cp_async8(s + r * stride + 2 * c, valid ? g + (row0 + r) * ld + 2 * c : g, valid);
    }
  }
}

// c += a b: a 16x8 tf32 (row), b 8x8 tf32 (col), c 16x8 f32.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A B fragment (b0, b1) split into TF32 hi and lo.
struct SplitB {
  uint32_t h0, h1, l0, l1;
  __device__ __forceinline__ void set(float b0, float b1) {
    split_tf32(b0, h0, l0);
    split_tf32(b1, h1, l1);
  }
};

// One warp's 16 query rows: Q fragments, the O accumulators and the online
// softmax state. Thread `lane` holds rows g = lane / 4 and g + 8 of the
// warp's 16, columns 2t and 2t + 1 (t = lane % 4) of every n8 tile. In
// both products the k index of an 8-wide step is permuted: k = t is column
// 2t, k = t + 4 column 2t + 1.
template <int D>
struct WarpTile {
  static constexpr int NS = Dims<D>::kSteps, KS = Dims<D>::kKStride, VS = Dims<D>::kVStride;
  static constexpr bool kQSmem = Dims<D>::kQSmem;
  uint32_t qh[kQSmem ? 1 : NS][4], ql[kQSmem ? 1 : NS][4];  // kQSmem: unused
  const float* qp;  // this lane's row g, column 2t of the warp's Q rows (kQSmem: the hi rows)
  float o[NS][4];
  float m[2];  // running max of the base-2 scores, rows g and g + 8
  float l[2];  // this thread's part of the running sum of exp2(s - m)

  // `qs`: the warp's first row of the staged Q tile. kQSmem: the tile's own
  // rows, split here in place into hi, and into lo rows kRows rows on.
  __device__ __forceinline__ void init(float* qs, int lane) {
    const int g = lane >> 2, t = lane & 3;
    qp = qs + g * KS + 2 * t;
    if constexpr (kQSmem) {
      for (int i = lane; i < 16 * D; i += 32) {
        const int r = i / D, c = i - r * D;
        uint32_t hi, lo;
        split_tf32(qs[r * KS + c], hi, lo);
        qs[r * KS + c] = __uint_as_float(hi);
        qs[(kRows + r) * KS + c] = __uint_as_float(lo);
      }
      __syncwarp();
    } else {
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        const float2 x0 = *reinterpret_cast<const float2*>(qp + 8 * kk);
        const float2 x1 = *reinterpret_cast<const float2*>(qp + 8 * KS + 8 * kk);
        split_tf32(x0.x, qh[kk][0], ql[kk][0]);
        split_tf32(x1.x, qh[kk][1], ql[kk][1]);
        split_tf32(x0.y, qh[kk][2], ql[kk][2]);
        split_tf32(x1.y, qh[kk][3], ql[kk][3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }

  __device__ __forceinline__ void q_frag(int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) const {
    if constexpr (kQSmem) {
#pragma unroll
      for (int part = 0; part < 2; ++part) {  // hi rows, then lo rows
        const float* p = qp + part * kRows * KS + 8 * kk;
        const float2 x0 = *reinterpret_cast<const float2*>(p);
        const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * KS);
        uint32_t(&a)[4] = part ? al : ah;
        a[0] = __float_as_uint(x0.x), a[1] = __float_as_uint(x1.x);
        a[2] = __float_as_uint(x0.y), a[3] = __float_as_uint(x1.y);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) ah[e] = qh[kk][e], al[e] = ql[kk][e];
    }
  }

  // Attend to one staged 64-key tile (`ks`, `vs`: its K and V rows), over
  // its 8-key chunks [c_lo, c_hi) (the others add nothing); kFull: all
  // eight, known at compile time. With `masked`, `keep(r, j)` says whether
  // tile key j is valid for row g + 8r; a masked key scores -inf, and a row
  // with no valid key yet keeps m = -inf, p = 0 and l = 0 (no NaN).
  template <bool kFull, typename Keep>
  __device__ __forceinline__ void attend(const float* ks, const float* vs, int c_lo, int c_hi,
                                         float mult, bool masked, int lane, Keep keep) {
    if (kFull) c_lo = 0, c_hi = 8;
    const int g = lane >> 2, t = lane & 3;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    // S = Q K^T: B fragment of key 8j + g, columns 8kk + 2t, 2t + 1. A k8
    // step splits its eight fragments first, then runs each of the three
    // products over the eight chains (the small terms first), so that
    // consecutive MMAs do not wait on each other.
    const float* kr = ks + g * KS + 2 * t;
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      uint32_t ah[4], al[4];
      q_frag(kk, ah, al);
      SplitB kb[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (!kFull && (j < c_lo || j >= c_hi)) continue;
        const float2 x = *reinterpret_cast<const float2*>(kr + 8 * j * KS + 8 * kk);
        kb[j].set(x.x, x.y);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (kFull || (j >= c_lo && j < c_hi)) mma_tf32(s[j], al, kb[j].h0, kb[j].h1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (kFull || (j >= c_lo && j < c_hi)) mma_tf32(s[j], ah, kb[j].l0, kb[j].l1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (kFull || (j >= c_lo && j < c_hi)) mma_tf32(s[j], ah, kb[j].h0, kb[j].h1);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool active = kFull || (j >= c_lo && j < c_hi);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = active ? s[j][e] * mult : -INFINITY;
    }
    if (masked) {  // warp-uniform
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!keep(e >> 1, 8 * j + 2 * t + (e & 1))) s[j][e] = -INFINITY;
    }
    float mx[2], base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = mma_attn::row_reduce<true>(s, r);
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      base[r] = m_new == -INFINITY ? 0.f : m_new;  // no key yet: p = 0, not NaN
      alpha[r] = mma_attn::fast_exp2(m[r] - base[r]);  // m == -inf -> 0
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = mma_attn::fast_exp2(s[j][e] - base[e >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + mma_attn::row_reduce<false>(s, r);
    // P V of this tile into zeroed partial sums, one k8 step per active
    // 8-key chunk c: P's A fragment is the chunk's S accumulators (keys 8c +
    // 2t, 8c + 2t + 1), V's B fragment rows 8c + 2t and 8c + 2t + 1 at
    // column 8n + g. The tensor cores round their f32 sums toward zero, an
    // error that grows with the number of MMAs into one accumulator: the
    // tile's partial sums (24 MMAs) join O in an FFMA, rounded to nearest.
    float ot[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) ot[n][0] = ot[n][1] = ot[n][2] = ot[n][3] = 0.f;
    const float* vr = vs + 2 * t * VS + g;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (!kFull && (c < c_lo || c >= c_hi)) continue;
      uint32_t ph[4], pl[4];
      split_tf32(s[c][0], ph[0], pl[0]);
      split_tf32(s[c][2], ph[1], pl[1]);
      split_tf32(s[c][1], ph[2], pl[2]);
      split_tf32(s[c][3], ph[3], pl[3]);
      const float* v = vr + 8 * c * VS;
      constexpr int G = Dims<D>::kGroup;
#pragma unroll
      for (int n0 = 0; n0 < NS; n0 += G) {
        SplitB vb[G];
#pragma unroll
        for (int i = 0; i < G; ++i)
          if (n0 + i < NS) vb[i].set(v[8 * (n0 + i)], v[VS + 8 * (n0 + i)]);
#pragma unroll
        for (int i = 0; i < G; ++i)
          if (n0 + i < NS) mma_tf32(ot[n0 + i], pl, vb[i].h0, vb[i].h1);
#pragma unroll
        for (int i = 0; i < G; ++i)
          if (n0 + i < NS) mma_tf32(ot[n0 + i], ph, vb[i].l0, vb[i].l1);
#pragma unroll
        for (int i = 0; i < G; ++i)
          if (n0 + i < NS) mma_tf32(ot[n0 + i], ph, vb[i].h0, vb[i].h1);
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = fmaf(o[n][e], alpha[e >> 1], ot[n][e]);
  }

  // O / l into rows [0, n_rows) of `out` (row stride `ld`), in 8-byte
  // stores, after the quad reduction of the partial sums.
  __device__ __forceinline__ void store(float* out, int64_t ld, int n_rows, int lane) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (g + 8 * r >= n_rows) continue;
      const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
      float* dst = out + (g + 8 * r) * ld + 2 * t;
#pragma unroll
      for (int n = 0; n < NS; ++n)
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
  }
};
}  // namespace attn32

struct AttnF32Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int64_t q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, o_sb, o_sl, o_sh;
  int len_q, window, q_window;
  float mult;  // scale * log2(e)
  bool vec16;  // q, k and v rows 16-byte aligned
};

template <int D>
__global__ void __launch_bounds__(attn32::kThreads, D > 80 ? 1 : 2)
    attention_3xtf32_kernel(AttnF32Params p) {
  using namespace attn32;
  constexpr int KS = Dims<D>::kKStride;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // stage s: K rows, then V rows
  float* qsm = ring + (Dims<D>::kQSmem ? 2 : 1) * Dims<D>::kStageFloats;

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = p.window, qw = p.q_window;
  // the block's keys: the key windows of its query windows
  const int first = q0 / qw * w;
  const int end = ((min(q0 + kRows, p.len_q) - 1) / qw + 1) * w;
  // this warp's rows and the keys of their windows
  const int wq0 = q0 + 16 * warp;
  const int n_rows = min(16, p.len_q - wq0);
  const int wfirst = wq0 / qw * w;
  const int wend = n_rows > 0 ? ((wq0 + n_rows - 1) / qw + 1) * w : wfirst;
  // a mask where the rows span several query windows, or the warp's keys
  // start or end inside an 8-key chunk of the block's tiles
  const bool masked = n_rows > 0 && (wq0 / qw != (wq0 + n_rows - 1) / qw ||
                                     (wfirst - first) % 8 || (wend - first) % 8);

  const float* kbase = p.k + b * p.k_sb + h * p.k_sh;
  const float* vbase = p.v + b * p.v_sb + h * p.v_sh;
  auto load_tile = [&](int k0, int stage) {
    float* ks = ring + stage * Dims<D>::kStageFloats;
    load_rows<D>(ks, KS, kbase, p.k_sl, k0, end, p.vec16);
    load_rows<D>(ks + kKeys * KS, Dims<D>::kVStride, vbase, p.v_sl, k0, end, p.vec16);
  };

  load_rows<D>(qsm, KS, p.q + b * p.q_sb + h * p.q_sh, p.q_sl, q0, p.len_q, p.vec16);
  mma_attn::cp_async_commit();
  load_tile(first, 0);
  mma_attn::cp_async_commit();
  mma_attn::cp_async_wait<0>();  // the Q tile and the first tile
  __syncthreads();
  WarpTile<D> st;
  st.init(qsm + 16 * warp * KS, lane);
  __syncthreads();  // every warp holds its Q: stage 1 is free

  const int g = lane >> 2;
  int stage = 0;
  for (int k0 = first; k0 < end; k0 += kKeys) {
    // tile k0 is in `stage`; the other stage is free
    if (k0 + kKeys < end) load_tile(k0 + kKeys, stage ^ 1);
    mma_attn::cp_async_commit();
    if (n_rows > 0) {
      const int c_lo = max(wfirst - k0, 0) / 8;
      const int c_hi = (min(max(wend - k0, 0), kKeys) + 7) / 8;  // keys past `end` are masked
      const float* ks = ring + stage * Dims<D>::kStageFloats;
      auto keep = [&](int r, int j) {
        const int start = (wq0 + g + 8 * r) / qw * w;  // the row's key window
        return (k0 + j >= start) & (k0 + j < start + w);
      };
      if (c_hi - c_lo == 8)
        st.template attend<true>(ks, ks + kKeys * KS, 0, 8, p.mult, masked, lane, keep);
      else if (c_lo < c_hi)
        st.template attend<false>(ks, ks + kKeys * KS, c_lo, c_hi, p.mult, masked, lane, keep);
    }
    mma_attn::cp_async_wait<0>();
    __syncthreads();  // the next tile landed, this one consumed
    stage ^= 1;
  }
  if (n_rows > 0)
    st.store(p.o + b * p.o_sb + h * p.o_sh + (int64_t)wq0 * p.o_sl, p.o_sl, n_rows, lane);
}

template <int D>
cudaError_t launch_attention(const AttnF32Params& p, int batch, int heads, cudaStream_t s) {
  const size_t smem = sizeof(float) * attn32::Dims<D>::kSmemFloats;
  static PerDevice smem_attr;
  const cudaError_t set =
      smem_attr.get([smem] { return set_smem(attention_3xtf32_kernel<D>, smem); });
  if (set != cudaSuccess) return set;
  const dim3 grid((p.len_q + attn32::kRows - 1) / attn32::kRows, heads, batch);
  attention_3xtf32_kernel<D><<<grid, attn32::kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
}  // namespace rga3

// Plain C entry points for ctypes, on CUDA device `device` (device.cuh).
// Leading dims and strides are in elements. Each returns a cudaError_t (0 on
// success).

// K and lda, ldw multiples of 4, a and w 16-byte aligned (TMA reads them;
// the wrapper checks); res given for the residual epilogues (3: res + (acc +
// b), 4: (res + b) + acc).
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
  p.bias = static_cast<const float*>(bias);
  p.res = static_cast<const float*>(res);
  p.out = static_cast<float*>(out);
  p.ldr = ldr, p.ldo = ldo;
  p.m = m, p.n = n, p.k = k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kBias: return launch_gemm<kBias>(p, a, lda, w, ldw, s);
    case kGeluTanh: return launch_gemm<kGeluTanh>(p, a, lda, w, ldw, s);
    case kGeluErf: return launch_gemm<kGeluErf>(p, a, lda, w, ldw, s);
    case kResRounded: return launch_gemm<kResRounded>(p, a, lda, w, ldw, s);
    case kResF32: return launch_gemm<kResF32>(p, a, lda, w, ldw, s);
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
// D in {16, 72, 80, 128}; 8-byte aligned rows (pointers and strides even),
// copied in 16-byte pieces where q, k and v rows are 16-byte aligned.
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
  p.mult = scale * kLog2e;
  p.vec16 = aligned16(q) && aligned16(k) && aligned16(v);
  for (const int64_t st : {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh})
    p.vec16 = p.vec16 && st % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch_attention<16>(p, batch, heads, s);
    case 72: return launch_attention<72>(p, batch, heads, s);
    case 80: return launch_attention<80>(p, batch, heads, s);
    case 128: return launch_attention<128>(p, batch, heads, s);
    default: return cudaErrorInvalidValue;
  }
}

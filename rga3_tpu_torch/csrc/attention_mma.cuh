// Tensor-core attention tile shared by the flash- and window-attention
// forward kernels (flash_attention.cu, window_attention.cu); the flash
// backward (flash_attention_bwd.cu) is built from its copy, ldmatrix and
// mma.sync pieces.
//
// The FlashAttention-2 design on mma.sync. A block of 4 warps (128 threads)
// owns 64 query rows of one (batch, head), 16 rows a warp:
//   * Q is copied once into shared memory with 16-byte cp.async, read into
//     bf16 A fragments with ldmatrix and kept in registers;
//   * K and V are staged as bf16 in a 2-stage cp.async ring of 64-key tiles:
//     tile t+1 is in flight while tile t is computed, with one barrier a
//     tile (the Q tile is staged in stage 1's K rows until its fragments are
//     in registers, and the output is staged there at the end);
//   * S = Q K^T through mma.sync.m16n8k16 (bf16 in, f32 accumulators); the
//     f32 scores are multiplied by scale * log2(e) (Q is not pre-scaled in
//     bf16, which would add a rounding the Pallas kernels do not have);
//   * masks act on the accumulator fragments with kMaskValue (the Pallas
//     kernels' -0.7 * FLT_MAX);
//   * the online softmax keeps each row's max and sum in f32 (the sum as a
//     partial over the thread's columns, reduced across the quad at the end);
//   * P is rounded to bf16 straight from the accumulator layout into A
//     fragments and O += P V runs through mma.sync, V read by ldmatrix.trans.
//     The Pallas kernels keep P in f32 (rga3_tpu/ops/attention.py:124-130);
//     `mha_reference` at bf16 rounds the normalised probabilities to bf16.
//     bf16 P adds ~2^-9 relative per term, inside the 2e-2 per-row bound.
// Rows of shared memory are padded by 16 bytes (kStride), so the 8 rows an
// ldmatrix phase reads fall on distinct banks at every head dim taken
// (row strides of 48, 176 and 272 bytes: an odd number of 16-byte units).
// D = 72 is padded to 80 in shared memory and in the k-loop of Q K^T; the
// pad columns of Q and K are zeroed once and never written by a copy. P V
// runs D / 8 n8 tiles (nine at D = 72).
//
// D = 256 (SAM2 memory attention, one head at d_model 256): Q fragments
// (64 registers a thread) beside the O accumulators (128) and S (32) would
// pass the 255-register cap, so at D > 128 the Q tile stays in shared memory
// in rows of its own and each k16 step of Q K^T reads its A fragment with one
// ldmatrix (Dims<D>::kQSmem); one block an SM (~169 KB of shared memory).
//
// Why mma.sync and not wgmma + TMA: the two largest callers have D = 72 and
// D = 80, whose 144- and 160-byte rows do not fit wgmma's 128-byte swizzled
// core layouts without splitting or padding the operands in device memory;
// mma.sync with ldmatrix takes a padded shared-memory row as it is, and
// FA2-class rates (what SDPA reaches at these calls, 340-376 TFLOP/s on an
// H100) are within its reach. On an H100 80GB HBM3 at 700 W this tile runs
// the ViT (D = 80) and Hiera global (D = 72) calls at 213-237 TFLOP/s: with
// 16 rows a warp, every K and V fragment is read from shared memory once per
// 16 query rows, so shared-memory bandwidth and the softmax between the two
// products, not the tensor cores, set its pace. wgmma (64-row warpgroup
// tiles reading K and V from shared memory once) is the lever of the next
// redesign, at D = 128 first.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace rga3 {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// The Pallas kernels' mask value (ops/attention.py DEFAULT_MASK_VALUE).
constexpr float kMaskValue = -0.7f * FLT_MAX;

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

namespace mma_attn {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kBlockThreads = 32 * kWarps;  // 128
constexpr int kRows = 64;                   // query rows a block (16 a warp)
constexpr int kKeys = 64;                   // keys a kv tile
constexpr int kStages = 2;                  // the K/V ring

// Blocks an SM should hold (the register cap of __launch_bounds__): three
// at D <= 80 (up to 170 registers a thread; four would cap them at 128,
// which spills), two at D = 128 (whose fragments need ~220), one at D = 256
// (the shared memory of one block).
template <int D>
constexpr int min_blocks() {
  return D > 128 ? 1 : D >= 128 ? 2 : 3;
}

template <int D>
struct Dims {
  static constexpr int kPadded = (D + 15) / 16 * 16;  // smem row and Q K^T depth
  static constexpr int kStride = kPadded + 8;         // smem row stride, elements
  static constexpr int kKSteps = kPadded / 16;        // k16 steps of Q K^T
  static constexpr int kNTiles = D / 8;               // n8 tiles of P V
  static constexpr int kChunks = D / 8;               // 16-byte chunks of a row
  static constexpr int kSlots = kChunks <= 2 ? 2 : kChunks <= 16 ? 16 : 32;  // >= kChunks
  static constexpr bool kQSmem = D > 128;  // Q fragments read from shared memory
};

// Shared rows of the K/V ring and the Q tile. At D <= 128 the Q tile is
// staged in stage 1's K rows: its fragments move to registers before the
// first copy into stage 1. At D > 128 it has rows of its own after the ring.
// The output is staged in the Q rows after the last tile.
template <int D>
__host__ __device__ constexpr int ring_rows() {
  return 2 * kStages * kKeys + (Dims<D>::kQSmem ? kRows : 0);
}

template <int D>
__device__ __forceinline__ bf16* q_tile(bf16* ring) {
  return ring + (Dims<D>::kQSmem ? 2 * kStages * kKeys : 2 * kKeys) * Dims<D>::kStride;
}

// Dynamic shared memory of the ring and the Q tile, in bytes.
template <int D>
constexpr size_t ring_smem_bytes() {
  return size_t(ring_rows<D>()) * Dims<D>::kStride * sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `valid` false zero-fills them (nothing is read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared; `valid` false writes zero.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 -> one register of two bf16, `lo` in the low half (the lower k).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the SFU (ex2.approx.ftz: 2^-22 relative; -inf -> 0; results below
// 2^-126 flush to 0, against weights of order 1).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Copy rows [row0, row0 + NROWS) of a row-major bf16 matrix (row stride `ld`
// elements, 16-byte aligned rows) into shared rows of kStride elements; rows
// at or past `limit` are zero-filled. The pad columns (D = 72) are untouched.
// Thread t copies chunk t % kSlots of rows t / kSlots + k * (128 / kSlots),
// so a pass costs it one pointer step, one compare and one cp.async.
template <int D, int NROWS>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* g, int64_t ld, int row0,
                                          int limit) {
  constexpr int C = Dims<D>::kChunks, SL = Dims<D>::kSlots, S = Dims<D>::kStride;
  constexpr int RP = kBlockThreads / SL;  // rows a pass
  static_assert(NROWS % RP == 0, "whole passes");
  const int c = threadIdx.x % SL, r = threadIdx.x / SL;
  if (c >= C) return;
  const bf16* src = g + (row0 + r) * ld + c * 8;
  bf16* dst = s + r * S + c * 8;
#pragma unroll
  for (int k = 0; k < NROWS / RP; ++k) {
    const bool valid = row0 + r + k * RP < limit;
    cp_async16(dst + k * RP * S, valid ? src : g, valid);
    src += RP * ld;
  }
}

// Zero the pad columns [D, kPadded) of `rows` shared rows (D = 72 only), so
// that Q K^T over the padded depth adds 0 * 0.
template <int D>
__device__ __forceinline__ void zero_pad(bf16* s, int rows) {
  constexpr int P = Dims<D>::kPadded, S = Dims<D>::kStride;
  if constexpr (P > D) {
    static_assert(P - D == 8, "one 16-byte pad chunk");
    for (int r = threadIdx.x; r < rows; r += kBlockThreads)
      *reinterpret_cast<uint4*>(s + r * S + D) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Max (kMax) or sum of the 16 values of row half r (elements 2r, 2r + 1 of
// each n8 tile) of a thread's 16x64 score fragment, as a tree: four levels
// of independent operations instead of a chain of fifteen.
template <bool kMax>
__device__ __forceinline__ float row_reduce(const float (&s)[8][4], int r) {
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = kMax ? fmaxf(s[j][2 * r], s[j][2 * r + 1]) : s[j][2 * r] + s[j][2 * r + 1];
#pragma unroll
  for (int w = 4; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) v[j] = kMax ? fmaxf(v[j], v[j + w]) : v[j] + v[j + w];
  return v[0];
}

// One warp's 16 query rows: Q fragments, the O accumulators and the online
// softmax state. Thread `lane` holds rows g = lane / 4 and g + 8 of the
// warp's 16, columns 2 * (lane % 4) + {0, 1} of every n8 tile.
template <int D>
struct WarpTile {
  static constexpr int KS = Dims<D>::kKSteps, NT = Dims<D>::kNTiles, S = Dims<D>::kStride;
  static constexpr bool kQSmem = Dims<D>::kQSmem;
  uint32_t q[kQSmem ? 1 : KS][4];  // the Q fragments (kQSmem: unused)
  const bf16* qp;                  // kQSmem: this lane's ldmatrix address in the Q tile
  float o[NT][4];
  float m[2];  // running max of the base-2 scores, rows g and g + 8
  float l[2];  // this thread's part of the running sum of exp2(s - m)

  // `qs` points at the warp's first row of the Q tile in shared memory
  // (kQSmem: it must stay there until the last attend()).
  __device__ __forceinline__ void init(const bf16* qs, int lane) {
    qp = qs + (lane & 15) * S + (lane >> 4) * 8;
    if constexpr (!kQSmem) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldmatrix_x4(q[ks], qp + ks * 16);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }

  // Attend to one staged 64-key tile (`ks`, `vs`: its K and V rows), over
  // its 16-key chunks [c_lo, c_hi) (the others add nothing); kFull: all
  // four, known at compile time, so that the products of the 8 n8 tiles of
  // S (and the 4 k16 steps of P V) form one straight run of independent
  // mma.sync the scheduler can interleave. With `masked`, `keep(r, j)` says
  // whether tile key j is valid for row g + 8r; a masked key scores
  // kMaskValue, as in the Pallas kernels: a row whose keys are all masked so
  // far weighs each visited key exp2(0) = 1 until a valid key arrives and
  // its alpha = exp2(kMaskValue - m) wipes them out.
  template <bool kFull, typename Keep>
  __device__ __forceinline__ void attend(const bf16* ks, const bf16* vs, int c_lo, int c_hi,
                                         float mult, bool masked, int lane, Keep keep) {
    if (kFull) c_lo = 0, c_hi = 4;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    // keys 16c + [0, 8) and 16c + [8, 16): x4 matrices (keys, depth half)
    const bf16* kr = ks + ((lane & 7) + ((lane >> 4) << 3)) * S + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      if constexpr (kQSmem) {
        ldmatrix_x4(qa, qp + kk * 16);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = q[kk][e];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!kFull && (c < c_lo || c >= c_hi)) continue;
        uint32_t kb[4];
        ldmatrix_x4(kb, kr + 16 * c * S + kk * 16);
        mma16816(s[2 * c], qa, kb[0], kb[1]);
        mma16816(s[2 * c + 1], qa, kb[2], kb[3]);
      }
    }
    const int t2 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool active = kFull || (j / 2 >= c_lo && j / 2 < c_hi);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = active ? s[j][e] * mult : -INFINITY;
    }
    if (masked) {  // warp-uniform: most tiles take no mask
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool active = kFull || (j / 2 >= c_lo && j / 2 < c_hi);
          const bool drop = active & !keep(e >> 1, 8 * j + t2 + (e & 1));
          s[j][e] = drop ? kMaskValue : s[j][e];
        }
    }
    float mx[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = row_reduce<true>(s, r);
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      base[r] = m_new == -INFINITY ? 0.f : m_new;  // no key yet: p = 0, not NaN
      alpha[r] = fast_exp2(m[r] - base[r]);        // m == -inf -> 0
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = fast_exp2(s[j][e] - base[e >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + row_reduce<false>(s, r);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    // O += P V, one k16 step per active 16-key chunk
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!kFull && (c < c_lo || c >= c_hi)) continue;
      const uint32_t a[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                             pack_bf16(s[2 * c][2], s[2 * c][3]),
                             pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                             pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
      // x4.trans matrices (keys half, depth columns 16jp + {0, 8})
      const bf16* vr = vs + (16 * c + (lane & 7) + ((lane >> 3) & 1) * 8) * S + (lane >> 4) * 8;
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vr + jp * 16);
        mma16816(o[2 * jp], a, vb[0], vb[1]);
        mma16816(o[2 * jp + 1], a, vb[2], vb[3]);
      }
      if constexpr (NT % 2 == 1) {  // D = 72: the ninth n8 tile
        uint32_t vb[2];
        ldmatrix_x2_trans(vb, vs + (16 * c + (lane & 7) + ((lane >> 3) & 1) * 8) * S +
                                  8 * (NT - 1));
        mma16816(o[NT - 1], a, vb[0], vb[1]);
      }
    }
  }

  // The rows' full sums (quad reduction of the partial ones).
  __device__ __forceinline__ void finish_sums() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
  }

  // O / l (l == 0: no key visited, zeros, as the Pallas finalize) as bf16
  // into the warp's 16 rows of shared memory at `st` (the warp's own Q rows,
  // whose fragments are in registers), then rows [0, n_rows) to device
  // memory in 16-byte stores. Call after finish_sums().
  __device__ __forceinline__ void store(bf16* st, bf16* out, int64_t ld, int n_rows,
                                        int lane) {
    const int g = lane >> 2, t2 = 2 * (lane & 3);
    const float inv0 = l[0] == 0.f ? 0.f : 1.f / l[0];
    const float inv1 = l[1] == 0.f ? 0.f : 1.f / l[1];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(st + g * S + 8 * j + t2) =
          __floats2bfloat162_rn(o[j][0] * inv0, o[j][1] * inv0);
      *reinterpret_cast<__nv_bfloat162*>(st + (g + 8) * S + 8 * j + t2) =
          __floats2bfloat162_rn(o[j][2] * inv1, o[j][3] * inv1);
    }
    __syncwarp();
    constexpr int C = Dims<D>::kChunks;
    for (int i = lane; i < 16 * C; i += 32) {
      const int r = i / C, c = i - r * C;
      if (r < n_rows)
        *reinterpret_cast<uint4*>(out + r * ld + c * 8) =
            *reinterpret_cast<const uint4*>(st + r * S + c * 8);
    }
  }
};

}  // namespace mma_attn
}  // namespace rga3

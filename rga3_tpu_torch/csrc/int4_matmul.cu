// Int4 weight-only dequant-matmul for Hopper (sm_90a):
//
//   y[m, n] = bf16( sum_groups  s_lo[n] * sum_k x[m, k] * lo[k, n]
//                             + s_hi[n] * sum_k x[m, half + k] * hi[k, n] )
//
// x (M, in) bf16; q (in/2, out) int8 packs row k of the weight in its low
// nibble and row half + k in its high nibble, both sign-extended (-7..7);
// scales (in/32, out) f32, one row per group of 32 input rows (rows
// [0, half/32) for the low half, the rest for the high half), or, with
// in % 64 != 0, one row of per-channel scales for both halves. The scales
// multiply the f32 partial dot of each group, never the weights, and the
// f32 sum is rounded to bf16 once: the rounding points of the Pallas TPU
// kernel `_int4_kernel` in rga3_tpu/ops/quant.py (:159, called through
// `_int4_matmul_pallas` :225), which this kernel replaces. The Pallas grid
// walks the input dim sequentially into a VMEM accumulator; here a loop
// over groups inside each block does.
//
// What bounds it on the H100: the packed weight and its scales are read
// once per call, 0.5 + 0.125 bytes per weight; at decode (M = the batch,
// 1..4) that is all the work, 2 * M flops per weight, so the kernel is
// bound by bytes: 4.42 GB per 7B LM token, 1.32 ms at 3.35 TB/s. At
// prefill (M = hundreds of tokens) it is bound by operations.
//
// Two launch variants of this source:
//  * M <= 4 (decode): a GEMV. A block of 8 warps owns a strip of 128
//    output columns, each thread 4 neighbouring columns (one 32-bit load
//    per packed row, coalesced across the warp); the warps take turns over
//    the groups of 32 packed rows, each loading its group's 32 words at
//    once, staging its 64 x values per row in shared memory (read back as
//    broadcasts), and folding the group's two f32 partials into its sum
//    times the group's scales. Nibbles become floats with the magic-number
//    trick (no int-to-float conversions). The warps' sums meet in shared
//    memory in a fixed order. When the strips are too few to fill the card
//    the groups are split over `splits` blocks that write f32 partials,
//    summed in a fixed order and rounded by a second small kernel.
//  * M > 4 (prefill): tensor cores through mma.sync.m16n8k16 (bf16 in,
//    f32 out). A block of 8 warps owns a 64 x 128 output tile; per group it
//    copies x's 64 low-half and high-half columns to shared memory and
//    unpacks the packed 32 x 128 tile into two bf16 tiles (-7..7 are exact
//    in bf16), accumulates each half's two k16 steps into a fragment of its
//    own, and folds that into the f32 accumulator times its column scales.
// No cp.async pipelining, TMA or wgmma yet: that is for the change that
// makes it fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rga3 {
namespace {

using bf16 = __nv_bfloat16;

struct Int4Params {
  const bf16* x;       // (m, in)
  const int8_t* q;     // (half, out)
  const float* s;      // (n_groups, out)
  bf16* y;             // (m, out)
  float* ws;           // (splits, m, out) partials, splits > 1 only
  int m, in, half, out;
  int per_channel;     // 1: one scale row for both halves
  int n_lo;            // scale rows of the low half (group mode)
  int chunks;          // groups of 32 packed rows (the last may be ragged)
  int chunks_per_split;
};

constexpr int kGroup = 32;

// A nibble (already XORed with 8) as a float: 2^23 + u - (2^23 + 8) = u - 8,
// the two's-complement value of the original nibble.
__device__ __forceinline__ float nib(uint32_t w, int shift) {
  return __int_as_float(0x4B000000u | ((w >> shift) & 0xFu)) - 8388616.f;
}

// ---------------------------------------------------------------- decode
constexpr int kGvThreads = 256, kGvWarps = 8, kGvCols = 128;

__device__ __forceinline__ uint32_t load_word(const Int4Params& p, int row, int col,
                                              bool vec) {
  if (row >= p.half || col >= p.out) return 0u;
  const int8_t* src = p.q + static_cast<int64_t>(row) * p.out + col;
  if (vec) return __ldg(reinterpret_cast<const uint32_t*>(src));
  uint32_t w = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (col + c < p.out) w |= static_cast<uint32_t>(static_cast<uint8_t>(src[c])) << (8 * c);
  return w;
}

__device__ __forceinline__ float4 load_scales(const Int4Params& p, int row, int col,
                                              bool vec) {
  if (col >= p.out) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* src = p.s + static_cast<int64_t>(row) * p.out + col;
  if (vec) return __ldg(reinterpret_cast<const float4*>(src));
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = col + c < p.out ? src[c] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <int MT, bool VEC>
__global__ void __launch_bounds__(kGvThreads) int4_gemv_kernel(Int4Params p) {
  __shared__ float4 xs4[kGvWarps][MT][2 * kGroup / 4];  // per warp: a group's x
  __shared__ float red[kGvWarps][MT][kGvCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = blockIdx.x * kGvCols + lane * 4;
  const int c_begin = blockIdx.y * p.chunks_per_split;
  const int c_end = min(p.chunks, c_begin + p.chunks_per_split);
  float* xs = reinterpret_cast<float*>(xs4[warp]);

  float tot[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) tot[m][c] = 0.f;

  for (int j = c_begin + warp; j < c_end; j += kGvWarps) {
    const int r0 = j * kGroup;
    uint32_t w[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) w[r] = load_word(p, r0 + r, col, VEC) ^ 0x88888888u;
    const float4 sl = load_scales(p, p.per_channel ? 0 : j, col, VEC);
    const float4 sh = load_scales(p, p.per_channel ? 0 : p.n_lo + j, col, VEC);
    const int k = r0 + lane;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const bf16* xr = p.x + static_cast<int64_t>(m) * p.in;
      xs[m * 2 * kGroup + lane] = k < p.half ? __bfloat162float(xr[k]) : 0.f;
      xs[m * 2 * kGroup + kGroup + lane] = k < p.half ? __bfloat162float(xr[p.half + k]) : 0.f;
    }
    __syncwarp();
    float alo[MT][4], ahi[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) alo[m][c] = ahi[m][c] = 0.f;
#pragma unroll
    for (int r4 = 0; r4 < kGroup / 4; ++r4) {
      float4 xl[MT], xh[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        xl[m] = xs4[warp][m][r4];
        xh[m] = xs4[warp][m][kGroup / 4 + r4];
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const uint32_t wr = w[r4 * 4 + rr];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float lo = nib(wr, 8 * c), hi = nib(wr, 8 * c + 4);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float a = rr == 0 ? xl[m].x : rr == 1 ? xl[m].y : rr == 2 ? xl[m].z : xl[m].w;
            const float b = rr == 0 ? xh[m].x : rr == 1 ? xh[m].y : rr == 2 ? xh[m].z : xh[m].w;
            alo[m][c] = fmaf(a, lo, alo[m][c]);
            ahi[m][c] = fmaf(b, hi, ahi[m][c]);
          }
        }
      }
    }
    __syncwarp();  // xs is rewritten by the next group
    const float slv[4] = {sl.x, sl.y, sl.z, sl.w}, shv[4] = {sh.x, sh.y, sh.z, sh.w};
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        tot[m][c] = fmaf(ahi[m][c], shv[c], fmaf(alo[m][c], slv[c], tot[m][c]));
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][m][lane * 4 + c] = tot[m][c];
  __syncthreads();
  for (int i = threadIdx.x; i < MT * kGvCols; i += kGvThreads) {
    const int m = i / kGvCols, cc = i % kGvCols;
    const int n = blockIdx.x * kGvCols + cc;
    if (n >= p.out) continue;
    float acc = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < kGvWarps; ++w8) acc += red[w8][m][cc];
    const int64_t o = static_cast<int64_t>(m) * p.out + n;
    if (gridDim.y == 1)
      p.y[o] = __float2bfloat16(acc);
    else
      p.ws[static_cast<int64_t>(blockIdx.y) * p.m * p.out + o] = acc;
  }
}

__global__ void split_sum_kernel(Int4Params p, int splits) {
  const int64_t total = static_cast<int64_t>(p.m) * p.out;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += p.ws[s * total + i];
    p.y[i] = __float2bfloat16(acc);
  }
}

// --------------------------------------------------------------- prefill
constexpr int kBM = 64, kBN = 128, kMmaThreads = 256;  // 8 warps: 2 (M) x 4 (N)
constexpr int kLdA = 2 * kGroup + 8;  // x tile row: 64 bf16 (low | high) + pad
constexpr int kLdB = kBN + 8;         // weight tile row: 128 bf16 + pad

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* ptr, bool trans) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  if (trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kMmaThreads) int4_mma_kernel(Int4Params p) {
  __shared__ __align__(16) bf16 as[kBM * kLdA];          // x: cols [0,32) low, [32,64) high
  __shared__ __align__(16) bf16 bs[2 * kGroup * kLdB];   // rows [0,32) low, [32,64) high
  __shared__ float s_lo[kBN], s_hi[kBN];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*32, cols wn*32

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int j = 0; j < p.chunks; ++j) {
    const int r0 = j * kGroup;
    // x: 64 rows x 64 values, 16 per thread (row t / 4, values (t % 4) * 16)
    {
      const int row = threadIdx.x >> 2, seg = (threadIdx.x & 3) * 16;
      const int mrow = m0 + row;
      const int kk = r0 + (seg & 31) + (seg >= kGroup ? p.half : 0);
      const int kend = (seg >= kGroup ? p.half : 0) + p.half;  // end of this half
      const bf16* src = p.x + static_cast<int64_t>(mrow) * p.in + kk;
      bf16* dst = as + row * kLdA + seg;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        dst[e] = (mrow < p.m && kk + e < kend) ? src[e] : __float2bfloat16(0.f);
    }
    // weights: 32 packed rows x 128 columns, 16 bytes per thread (row t / 8,
    // columns (t % 8) * 16), unpacked to the low and the high tile
    {
      const int row = threadIdx.x >> 3, cseg = (threadIdx.x & 7) * 16;
      const int krow = r0 + row;
      const int8_t* src = p.q + static_cast<int64_t>(krow) * p.out + n0 + cseg;
      uint32_t w[4];
      const bool full = krow < p.half && n0 + cseg + 16 <= p.out;
      if (full && (p.out & 15) == 0) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
        w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          w[i] = 0u;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int n = n0 + cseg + 4 * i + c;
            if (krow < p.half && n < p.out)
              w[i] |= static_cast<uint32_t>(static_cast<uint8_t>(src[4 * i + c])) << (8 * c);
          }
        }
      }
      __nv_bfloat162* lo = reinterpret_cast<__nv_bfloat162*>(bs + row * kLdB + cseg);
      __nv_bfloat162* hi = reinterpret_cast<__nv_bfloat162*>(bs + (kGroup + row) * kLdB + cseg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t wx = w[i] ^ 0x88888888u;
#pragma unroll
        for (int c = 0; c < 4; c += 2) {
          lo[2 * i + c / 2] = __floats2bfloat162_rn(nib(wx, 8 * c), nib(wx, 8 * c + 8));
          hi[2 * i + c / 2] = __floats2bfloat162_rn(nib(wx, 8 * c + 4), nib(wx, 8 * c + 12));
        }
      }
    }
    if (threadIdx.x < 2 * kBN) {
      const int cc = threadIdx.x % kBN, n = n0 + cc;
      const bool high = threadIdx.x >= kBN;
      const int srow = p.per_channel ? 0 : (high ? p.n_lo + j : j);
      (high ? s_hi : s_lo)[cc] = n < p.out ? p.s[static_cast<int64_t>(srow) * p.out + n] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the low half, then the high half
      float part[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][jn][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int k0 = h * kGroup + ks * 16;
        uint32_t af[2][4], bfr[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(af[mi], as + (wm * 32 + mi * 16 + (lane & 15)) * kLdA + k0 + (lane >> 4) * 8,
                      false);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4(r, bs + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLdB + wn * 32 +
                             np * 16 + (lane >> 4) * 8,
                      true);
          bfr[2 * np][0] = r[0];
          bfr[2 * np][1] = r[1];
          bfr[2 * np + 1][0] = r[2];
          bfr[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(part[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
      }
      const float* sc = h == 0 ? s_lo : s_hi;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int cc = wn * 32 + ni * 8 + (lane & 3) * 2;
        const float s0 = sc[cc], s1 = sc[cc + 1];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          acc[mi][ni][0] = fmaf(part[mi][ni][0], s0, acc[mi][ni][0]);
          acc[mi][ni][1] = fmaf(part[mi][ni][1], s1, acc[mi][ni][1]);
          acc[mi][ni][2] = fmaf(part[mi][ni][2], s0, acc[mi][ni][2]);
          acc[mi][ni][3] = fmaf(part[mi][ni][3], s1, acc[mi][ni][3]);
        }
      }
    }
    __syncthreads();  // the tiles are rewritten by the next group
  }

  // accumulator fragment: c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g+8
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 32 + mi * 16 + (lane >> 2) + (e >> 1) * 8;
        const int n = n0 + wn * 32 + ni * 8 + (lane & 3) * 2 + (e & 1);
        if (row < p.m && n < p.out)
          p.y[static_cast<int64_t>(row) * p.out + n] = __float2bfloat16(acc[mi][ni][e]);
      }
}

template <int MT>
cudaError_t launch_gemv(const Int4Params& p, int splits, cudaStream_t stream) {
  const dim3 grid((p.out + kGvCols - 1) / kGvCols, splits);
  if (p.out % 4 == 0)
    int4_gemv_kernel<MT, true><<<grid, kGvThreads, 0, stream>>>(p);
  else
    int4_gemv_kernel<MT, false><<<grid, kGvThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rga3

// Plain C entry point for ctypes. x (m, in) bf16, q (in/2, out) int8,
// scales (n_groups, out) f32 with group = 32 (in % 64 == 0) or in (one
// row), y (m, out) bf16, all contiguous and 16-byte aligned; ws holds
// splits * m * out f32 when splits > 1 (decode, m <= 4, only). Returns a
// cudaError_t (0 on success).
extern "C" int rga3_int4_matmul_bf16(const void* x, const void* q, const void* scales, void* y,
                                     void* ws, int m, int in, int out, int group, int splits,
                                     void* stream) {
  using namespace rga3;
  if (m <= 0 || in <= 0 || out <= 0 || in % 2 || splits < 1 ||
      !((group == kGroup && in % (2 * kGroup) == 0) || (group == in && in % (2 * kGroup) != 0)) ||
      (splits > 1 && (ws == nullptr || m > 4)) || (m + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  Int4Params p;
  p.x = static_cast<const bf16*>(x);
  p.q = static_cast<const int8_t*>(q);
  p.s = static_cast<const float*>(scales);
  p.y = static_cast<bf16*>(y);
  p.ws = static_cast<float*>(ws);
  p.m = m;
  p.in = in;
  p.half = in / 2;
  p.out = out;
  p.per_channel = group == in;
  p.n_lo = p.half / kGroup;
  p.chunks = (p.half + kGroup - 1) / kGroup;
  p.chunks_per_split = (p.chunks + splits - 1) / splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m > 4) {
    const dim3 grid((out + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    int4_mma_kernel<<<grid, kMmaThreads, 0, st>>>(p);
    return cudaGetLastError();
  }
  if (splits > p.chunks) return cudaErrorInvalidValue;
  cudaError_t err;
  switch (m) {
    case 1: err = launch_gemv<1>(p, splits, st); break;
    case 2: err = launch_gemv<2>(p, splits, st); break;
    case 3: err = launch_gemv<3>(p, splits, st); break;
    default: err = launch_gemv<4>(p, splits, st); break;
  }
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t total = static_cast<int64_t>(m) * out;
  const int blocks = total > 4096 * 256 ? 4096 : static_cast<int>((total + 255) / 256);
  split_sum_kernel<<<blocks, 256, 0, st>>>(p, splits);
  return cudaGetLastError();
}

// Int4 weight-only dequant-matmul for Hopper (sm_90a):
//
//   y[m, n] = bf16( sum_groups  s_lo[n] * sum_k x[m, k] * lo[k, n]
//                             + s_hi[n] * sum_k x[m, half + k] * hi[k, n] )
//
// x (M, in) bf16; q (in/2, out) int8 packs row k of the weight in its low
// nibble and row half + k in its high nibble, both sign-extended (-7..7);
// scales (in/32, out) f32, one row per group of 32 input rows (rows
// [0, half/32) for the low half, the rest for the high half), or, with
// in % 64 != 0, one row of per-channel scales for both halves. The scales multiply the
// f32 partial dot of each group, never the weights, and the f32 sum is
// rounded to bf16 once: the rounding points of the Pallas TPU kernel
// `_int4_kernel` in rga3_tpu/ops/quant.py (:159, called through
// `_int4_matmul_pallas` :225), which this kernel replaces. The Pallas grid
// walks the input dim sequentially into a VMEM accumulator; here a loop over
// the groups inside each work unit does, and where the units would be too few
// for the card, units of contiguous group ranges whose f32 partials are added
// in a fixed order.
//
// What bounds it on the H100: the packed weight and its scales are read once
// per call, 0.5 + 0.125 bytes per weight; at decode (M = the batch, 1..4)
// that is all the work, 2 * M flops per weight, so the kernel is bound by
// bytes: 4.42 GB per 7B LM token, 1.32 ms at 3.35 TB/s. At prefill
// (M = hundreds to thousands of tokens) it is bound by operations, and only wgmma
// reaches the tensor cores' full rate; each group's two partials must still
// be scaled on the CUDA cores before they join the sum (2 x 64 FMAs a thread
// per group at 128 tokens).
//
// The design (the TMA tile, both variants): the products are transposed,
// y^T = W^T x^T, so that the unpacked weights are the A operand, taken from
// registers, and x is the B operand in shared memory, tokens as the N of the
// product. A persistent grid walks work units of 128 output columns (144 at
// decode where that fits the SMs better, below) x BT tokens x a range of
// stages; a stage is two groups (64 packed rows). One producer thread issues
// TMA loads of a stage into an mbarrier ring: x's 64 low-half and 64
// high-half columns of the unit's tokens (two boxes in the 128-byte swizzle),
// the 64 x 128 packed bytes (also swizzled, so that the transposing reads
// below miss each other's banks) and the groups' 2 x 2 x 128 scales. Eight
// consumer warps (two warpgroups; nine at 144 columns) own 16 columns each:
// one ldmatrix.x4.trans of a group's 32 packed rows gives a thread, per
// 32-bit word, two neighbouring columns at two neighbouring k rows, which is
// exactly a bf16x2 A fragment of m16n8k16 once the output columns are
// permuted (fragment row g is column 2g, row g + 8 column 2g + 1); a lop3
// with a magic number turns two nibbles into 136 + v as bf16 and one bf16x2
// fma subtracts 136 (exact, no int-to-float conversion), the high nibbles
// after a shift. Per group and half the product goes into an f32 partial of
// its own, which is folded into the f32 accumulator times its two columns'
// scales.
//  * M > 4 (prefill), BT = 128: each half's partial is one wgmma.m64n128k16
//    pair (A from registers, the x tile through a swizzled descriptor) a
//    warpgroup, the high half's issued before the low half is folded; the two
//    consumer warpgroups take turns on the tensor cores. setmaxnreg moves
//    registers from the producer warpgroup to the consumers.
//  * M <= 4 (decode), BT = 8: each half's partial is two mma.sync.m16n8k16 a
//    warp, x (zero-filled to 8 tokens by TMA) read from the swizzled tile as
//    B fragments; ~1 instruction per weight, so that the loads stay the
//    bound. Two blocks an SM; 144-column units where 128-column ones would
//    overflow one an SM and these do not. The wrapper splits the groups over
//    units when the columns are too few to fill the card (`splits`); warps
//    1-3 of the producer warpgroup count each tile's arrived units, and the
//    last adds the partials in split order, so that the consumers never wait
//    on the count and two launches give equal bits.
// Measured (tools/bench_int4.py and chip_smoke.py phase 7, NVIDIA H100 80GB
// HBM3, 700 W, at the Qwen2.5-VL-7B LM's projections): prefill at M = 1280
// 340-470 TFLOP/s (k/v, 40 tiles on 132 SMs: 140), at M = 5120 280-500; a
// decode token's 197 calls ~2.5 ms at M = 1 and 4 (0.53 of the bytes bound),
// the calls of a few µs held by a fixed ~5 µs each, the large ones at
// 0.66-0.84 of their bound. Tried and slower: a 64-token prefill tile (0.79
// of this one's rate a tile; it wins only where the 128-token tiles are fewer
// than the SMs), and 16-byte cp.async loads for decode in place of TMA
// (1.3-1.6x slower).
// TMA needs 16-byte aligned rows: in % 16 == 0 and out % 16 == 0 (every
// projection of the Qwen2.5-VL LMs). Other shapes take the generic tile
// below, mma.sync on a 64 x 128 tile with the weights unpacked through
// shared memory, at any M.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_wgmma.cuh"  // mbarriers, TMA loads, the wgmma descriptor, the map encoder
#include "device.cuh"  // use_device, PerDevice

namespace rga3 {
namespace {

using bf16 = __nv_bfloat16;

struct Int4Params {
  const bf16* x;       // (m, in)
  const int8_t* q;     // (half, out)
  const float* s;      // (n_groups, out)
  bf16* y;             // (m, out)
  float* ws;           // the split workspace (splits > 1 only)
  int m, in, half, out;
  int per_channel;     // 1: one scale row for both halves
  int n_lo;            // scale rows of the low half (group mode)
  int chunks;          // groups of 32 packed rows (the last may be ragged)
};

constexpr int kGroup = 32;

// A nibble (already XORed with 8) as a float: 2^23 + u - (2^23 + 8) = u - 8,
// the two's-complement value of the original nibble.
__device__ __forceinline__ float nib(uint32_t w, int shift) {
  return __int_as_float(0x4B000000u | ((w >> shift) & 0xFu)) - 8388616.f;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------- TMA tile
constexpr int kStageRows = 64;  // packed rows a stage: two groups

// A unit's columns, 16 a consumer warp: two warpgroups of wgmma at
// prefill; at decode eight warps, or nine where 128-column units would
// overflow one an SM and 144-column ones do not (gate/up's 18944 columns:
// 148 units, 16 SMs with two, against 132). A ninth warp puts three on one
// of the SM's four schedulers, so nine are slower wherever eight fit
// (tools/bench_int4.py). The packed bytes land in 128-byte rows swizzled,
// or 144-byte rows plain: 144 bytes a row put the 8 rows of an ldmatrix on
// distinct banks.
template <int BT, int COLS>
struct TileCfg {
  static constexpr int kCols = COLS;
  static constexpr int kWarps = kCols / 16;               // consumer warps
  static constexpr int kThreads = 128 + 32 * kWarps;      // and the producer warpgroup
  static constexpr int kXBytes = BT * 128;                // BT tokens x 64 bf16, swizzled
  static constexpr int kQBytes = kStageRows * kCols;      // a 1024-multiple
  static constexpr int kSBoxBytes = 2 * kCols * 4;        // a scale box: two rows
  // a stage rounded to 1024 bytes, the 128-byte swizzle's period
  static constexpr int kStageBytes = (2 * kXBytes + kQBytes + 2 * kSBoxBytes + 1023) / 1024 * 1024;
  static constexpr int kStages = BT == 8 ? (COLS == 128 ? 8 : 7) : 4;
  // the ring, its mbarriers, the reducers' two pairs and flag, and slack to
  // align the ring
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 4 * 8 + 16 + 1024;
};

// Split units meet through a workspace: kCounters int32 arrival counts (one
// a tile; zero on entry, and the last unit of a tile sets its count back to
// zero) and then the f32 partials, (splits, m, out).
constexpr int kCounters = 1024;

struct TileParams {
  bf16* y;
  int* counters;
  float* ws;  // the partials
  int m, out, per_channel, n_lo;
  int n_tok, n_col, stages, per_split, splits, units;
};

// A work unit: its tile (tokens fastest, then columns), its first token and
// column, its split (the slowest: the blocks at work at once read the same
// packed rows of neighbouring columns) and its stages.
template <int BT, int COLS>
__device__ __forceinline__ void unit_coords(const TileParams& p, int u, int& tile, int& m0,
                                            int& n0, int& split, int& s0, int& s1) {
  const int tiles = p.n_tok * p.n_col;
  tile = u % tiles;
  split = u / tiles;
  m0 = tile % p.n_tok * BT;
  n0 = tile / p.n_tok * COLS;
  s0 = split * p.per_split;
  s1 = min(p.stages, s0 + p.per_split);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// The nibbles at bits [0, 4) and [16, 20) of w as a bf16x2, low half
// first: lop3 makes bf16(128 + (u ^ 8)) = 136 + v of each (v the signed
// nibble), and an fma subtracts 136; every step is exact.
__device__ __forceinline__ uint32_t nib2_bf16x2(uint32_t w) {
  uint32_t r, d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(r) : "r"(w), "r"(0x000F000Fu), "r"(0x43084308u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(r), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

// Keep the A fragments alive (unmoved) until their products are done.
__device__ __forceinline__ void fence_a(uint32_t (&a)[2][4]) {
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[s][i]) : : "memory");
}

// d (+)= A B^T over one k16 step: A, 64 rows x 16, from registers (each
// warp's m16n8k16 A fragment, warp w rows 16w..), B, 128 rows x 16, from
// shared memory; scale_d 0 starts the sum.
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The fold of a group's f32 partial into the accumulator times the
// thread's two columns' scales. Accumulator layout per warp, for the n8
// tile j of tokens: acc[4j], acc[4j + 1] at (column 2g, tokens 8j + 2t,
// + 1), acc[4j + 2], acc[4j + 3] at column 2g + 1.
template <int R>
__device__ __forceinline__ void fold(float (&acc)[R], const float (&part)[R], float2 s) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    acc[4 * j] = fmaf(part[4 * j], s.x, acc[4 * j]);
    acc[4 * j + 1] = fmaf(part[4 * j + 1], s.x, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(part[4 * j + 2], s.y, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(part[4 * j + 3], s.y, acc[4 * j + 3]);
  }
}

// Decode: one group's half (low or high) against the x tile `xt` (8
// tokens x 64 k, swizzled; this group's k at 32 * gi), two mma.sync steps
// a warp, folded.
__device__ __forceinline__ void group_half_mma(float (&acc)[4], const uint32_t (&a)[2][4],
                                               uint32_t xt, int gi, int g, int t, float2 s) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    // B fragment: x[token g][k 2t, 2t + 1] and [2t + 8, 2t + 9] of this
    // k16 step, 16-byte chunks 2 * step and 2 * step + 1 of row g
    const int c = 2 * (2 * gi + k);
    const uint32_t row = xt + g * 128 + 4 * t;
    mma_bf16(part, a[k], lds_u32(row + ((c ^ g) << 4)), lds_u32(row + (((c + 1) ^ g) << 4)));
  }
  fold(acc, part, s);
}

// Prefill: both halves of a group, a wgmma pair each into a partial of its
// own (x tiles of 128 tokens); the low half is folded while the high
// half's products run.
__device__ __forceinline__ void group_wgmma(float (&acc)[64], uint32_t (&alo)[2][4],
                                            uint32_t (&ahi)[2][4], uint32_t xlo, uint32_t xhi,
                                            int gi, float2 slo, float2 shi) {
  float plo[64], phi[64];
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  wgmma_rs_m64n128k16(plo, alo[0], sw128_desc(xlo + 64 * gi), 0);
  wgmma_rs_m64n128k16(plo, alo[1], sw128_desc(xlo + 64 * gi + 32), 1);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  wgmma_rs_m64n128k16(phi, ahi[0], sw128_desc(xhi + 64 * gi), 0);
  wgmma_rs_m64n128k16(phi, ahi[1], sw128_desc(xhi + 64 * gi + 32), 1);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  fence_acc(plo);
  fence_a(alo);
  fold(acc, plo, slo);
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(phi);
  fence_a(ahi);
  fold(acc, phi, shi);
}

// Decode's split units meet here: warps 1-3 of the producer warpgroup
// count each tile's arrived units (the consumers hand a unit over through a
// 2-slot barrier pair and go on with the next), and the tile's last adds all
// splits' partials in split order and rounds once, so that the sum does not
// depend on the order of arrival.
template <int COLS>
__device__ __forceinline__ void reduce_splits(const TileParams& p, uint32_t done, uint32_t ack,
                                              int* flag) {
  // column pairs a thread (96 x 3 cover m <= 4 rows of COLS / 2), and the
  // splits' loads in flight (fewer for nine consumer warps' registers)
  constexpr int kItems = 3, kLoads = COLS == 128 ? 8 : 4, kPairs = COLS / 2;
  const int r = threadIdx.x - 32;
  int slot = 0, phase = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    int tile, m0, n0, split, s0, s1;
    unit_coords<8, COLS>(p, u, tile, m0, n0, split, s0, s1);
    mbar_wait(done + 8 * slot, phase);
    if (r == 0) {
      __threadfence();  // the consumers' partials, ordered before by the barrier
      *flag = atomicAdd(p.counters + tile, 1) == p.splits - 1;
    }
    bar_sync(1, 96);
    const bool last = *flag;
    bar_sync(1, 96);  // every reducer is past this slot's phase and the flag
    if (r == 0) mbar_arrive(ack + 8 * slot);
    if (++slot == 2) slot = 0, phase ^= 1;
    if (!last) continue;
    __threadfence();
    float2 sum[kItems];
    int64_t off[kItems];
    bool ok[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = r + 96 * k, row = m0 + i / kPairs, col = n0 + 2 * (i % kPairs);
      ok[k] = row < p.m && col < p.out;
      off[k] = static_cast<int64_t>(row) * p.out + col;
      sum[k] = make_float2(0.f, 0.f);
    }
    for (int sp0 = 0; sp0 < p.splits; sp0 += kLoads) {
      float2 v[kItems][kLoads];
#pragma unroll
      for (int k = 0; k < kItems; ++k)
#pragma unroll
        for (int i = 0; i < kLoads; ++i)
          v[k][i] = ok[k] && sp0 + i < p.splits
                        ? __ldcg(reinterpret_cast<const float2*>(
                              p.ws + static_cast<int64_t>(sp0 + i) * p.m * p.out + off[k]))
                        : make_float2(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < kItems; ++k)
#pragma unroll
        for (int i = 0; i < kLoads; ++i)
          if (sp0 + i < p.splits) {
            sum[k].x += v[k][i].x;
            sum[k].y += v[k][i].y;
          }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (ok[k])
        *reinterpret_cast<__nv_bfloat162*>(p.y + off[k]) =
            __floats2bfloat162_rn(sum[k].x, sum[k].y);
    if (r == 0) p.counters[tile] = 0;
  }
}

template <int BT, int COLS>
__global__ void __launch_bounds__(TileCfg<BT, COLS>::kThreads, BT == 8 ? 2 : 1)
    int4_tile_kernel(const __grid_constant__ CUtensorMap map_xlo,
                     const __grid_constant__ CUtensorMap map_xhi,
                     const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_s, TileParams p) {
  using C = TileCfg<BT, COLS>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;  // the swizzle repeats every 1024 bytes
  const uint8_t* ring_ptr = smem_raw + (ring - raw);
  const uint32_t full = ring + C::kStages * C::kStageBytes;
  const uint32_t empty = full + C::kStages * 8;
  const uint32_t done = empty + C::kStages * 8;  // a unit's partials are out (2 slots)
  const uint32_t ack = done + 2 * 8;             // the reducers are through with a slot
  int* flag = reinterpret_cast<int*>(smem_raw + (ack + 2 * 8 - raw));
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's expect_tx
      mbar_init(empty + 8 * s, C::kWarps);  // one arrival a consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(done + 8 * s, C::kWarps);
      mbar_init(ack + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    if constexpr (BT > 8) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {  // one thread issues every load
      prefetch_map(&map_xlo);
      prefetch_map(&map_xhi);
      prefetch_map(&map_q);
      prefetch_map(&map_s);
      int stage = 0, phase = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        int tile, m0, n0, split, s0, s1;
        unit_coords<BT, COLS>(p, u, tile, m0, n0, split, s0, s1);
        for (int st = s0; st < s1; ++st) {
          mbar_wait(empty + 8 * stage, phase ^ 1);  // a fresh barrier passes at once
          const uint32_t dst = ring + stage * C::kStageBytes, bar = full + 8 * stage;
          // whole boxes, zero-filled edges included
          mbar_expect_tx(bar, 2 * C::kXBytes + C::kQBytes + 2 * C::kSBoxBytes);
          const int srow = p.per_channel ? 0 : 2 * st;
          tma_load(dst, &map_xlo, st * kStageRows, m0, bar);
          tma_load(dst + C::kXBytes, &map_xhi, st * kStageRows, m0, bar);
          tma_load(dst + 2 * C::kXBytes, &map_q, n0, st * kStageRows, bar);
          tma_load(dst + 2 * C::kXBytes + C::kQBytes, &map_s, n0, srow, bar);
          tma_load(dst + 2 * C::kXBytes + C::kQBytes + C::kSBoxBytes, &map_s, n0,
                   p.per_channel ? 0 : p.n_lo + srow, bar);
          if (++stage == C::kStages) stage = 0, phase ^= 1;
        }
      }
    } else if constexpr (BT == 8) {
      if (threadIdx.x >= 32 && p.splits > 1) reduce_splits<COLS>(p, done, ack, flag);
    }
    return;
  }

  // the consumers: warp w of warpgroup wg owns the tile's columns
  // 16 * (4 * wg + w) .. + 16, the thread columns 2g and 2g + 1 of them
  if constexpr (BT > 8) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int chunk = threadIdx.x / 32 - 4;  // the warp's 16 columns, a 16-byte chunk of a row
  const int ccol = 16 * chunk + 2 * g;
  int stage = 0, phase = 0, slot = 0, slot_phase = 0;
  float acc[BT / 2];
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    int tile, m0, n0, split, s0, s1;
    unit_coords<BT, COLS>(p, u, tile, m0, n0, split, s0, s1);
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
    for (int st = s0; st < s1; ++st) {
      mbar_wait(full + 8 * stage, phase);
      const uint32_t xlo = ring + stage * C::kStageBytes, xhi = xlo + C::kXBytes;
      const uint32_t qt = xhi + C::kXBytes;
      const float* sc = reinterpret_cast<const float*>(ring_ptr + stage * C::kStageBytes +
                                                       2 * C::kXBytes + C::kQBytes);
#pragma unroll
      for (int gi = 0; gi < 2; ++gi) {
        // packed rows 32 gi + 8i .. + 8 (matrix i, row address from lane
        // 8i + r), the warp's 16 bytes of each, swizzled as TMA wrote them;
        // word i: rows 2t, 2t + 1 of matrix i at columns 2g, 2g + 1
        uint32_t w[4];
        ldmatrix_x4_trans(w, qt + (32 * gi + lane) * C::kCols +
                                 ((C::kCols == 128 ? chunk ^ (lane & 7) : chunk) << 4));
        uint32_t alo[2][4], ahi[2][4];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          alo[k][0] = nib2_bf16x2(w[2 * k]);
          alo[k][1] = nib2_bf16x2(w[2 * k] >> 8);
          alo[k][2] = nib2_bf16x2(w[2 * k + 1]);
          alo[k][3] = nib2_bf16x2(w[2 * k + 1] >> 8);
          ahi[k][0] = nib2_bf16x2(w[2 * k] >> 4);
          ahi[k][1] = nib2_bf16x2(w[2 * k] >> 12);
          ahi[k][2] = nib2_bf16x2(w[2 * k + 1] >> 4);
          ahi[k][3] = nib2_bf16x2(w[2 * k + 1] >> 12);
        }
        const int srow = p.per_channel ? 0 : gi;
        const float2 slo = *reinterpret_cast<const float2*>(sc + srow * C::kCols + ccol);
        const float2 shi = *reinterpret_cast<const float2*>(sc + (2 + srow) * C::kCols + ccol);
        if constexpr (BT == 8) {
          group_half_mma(acc, alo, xlo, gi, g, t, slo);
          group_half_mma(acc, ahi, xhi, gi, g, t, shi);
        } else {
          group_wgmma(acc, alo, ahi, xlo, xhi, gi, slo, shi);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * stage);
      if (++stage == C::kStages) stage = 0, phase ^= 1;
    }

    // accumulator row e of n8 tile j: token m0 + 8j + 2t + e, columns
    // col and col + 1 (out is even: col + 1 < out when col < out)
    const int col = n0 + ccol;
    if (p.splits > 1) {
      // the unit's partial to the workspace, handed to the reducer warp
      // through a 2-slot barrier pair
      mbar_wait(ack + 8 * slot, slot_phase ^ 1);
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = m0 + 8 * j + 2 * t + e;
          if (row < p.m && col < p.out)
            __stcg(reinterpret_cast<float2*>(
                       p.ws + (static_cast<int64_t>(split) * p.m + row) * p.out + col),
                   make_float2(acc[4 * j + e], acc[4 * j + 2 + e]));
        }
      __syncwarp();
      if (lane == 0) mbar_arrive(done + 8 * slot);
      if (++slot == 2) slot = 0, slot_phase ^= 1;
      continue;
    }
    if (col >= p.out) continue;
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m0 + 8 * j + 2 * t + e;
        if (row < p.m)
          *reinterpret_cast<__nv_bfloat162*>(p.y + static_cast<int64_t>(row) * p.out + col) =
              __floats2bfloat162_rn(acc[4 * j + e], acc[4 * j + 2 + e]);
      }
  }
}

// ----------------------------------------------------------- generic tile
// The mma.sync tile for shapes TMA cannot address (in or out not a
// multiple of 16), at any M.
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

// The tensor map of a 2-D row-major array (inner dim contiguous, row stride
// `ld` elements), read in boxes of box_inner x box_outer; out of range
// reads are zeros.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* ptr,
              int64_t inner, int64_t outer, int64_t ld, int box_inner, int box_outer,
              CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld * elem_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The card's SMs, asked once a device.
cudaError_t sm_count(int& sms) {
  static int count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (count[dev] == 0)
    err = cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  sms = count[dev];
  return err;
}

template <int BT, int COLS>
cudaError_t launch_tile(const Int4Params& p, int splits, int sms, cudaStream_t stream) {
  using C = TileCfg<BT, COLS>;
  static PerDevice smem_attr;
  const cudaError_t set = smem_attr.get([] {
    return cudaFuncSetAttribute(int4_tile_kernel<BT, COLS>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  });
  if (set != cudaSuccess) return set;
  const auto sw128 = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap map_xlo, map_xhi, map_q, map_s;
  if (!make_map(&map_xlo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.x, p.half, p.m, p.in,
                kStageRows, BT, sw128) ||
      !make_map(&map_xhi, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.x + p.half, p.half, p.m, p.in,
                kStageRows, BT, sw128) ||
      !make_map(&map_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.q, p.out, p.half, p.out, C::kCols,
                kStageRows, C::kCols == 128 ? sw128 : CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&map_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p.s, p.out,
                p.per_channel ? 1 : 2 * p.n_lo, p.out, C::kCols, 2,
                CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  TileParams tp;
  tp.y = p.y;
  tp.counters = reinterpret_cast<int*>(p.ws);
  tp.ws = p.ws + kCounters;
  tp.m = p.m;
  tp.out = p.out;
  tp.per_channel = p.per_channel;
  tp.n_lo = p.n_lo;
  tp.n_tok = (p.m + BT - 1) / BT;
  tp.n_col = (p.out + C::kCols - 1) / C::kCols;
  tp.stages = (p.half + kStageRows - 1) / kStageRows;
  if (static_cast<int64_t>(tp.n_tok) * tp.n_col > kCounters) splits = 1;
  tp.per_split = (tp.stages + splits - 1) / splits;
  tp.splits = (tp.stages + tp.per_split - 1) / tp.per_split;  // none empty
  const int64_t units = static_cast<int64_t>(tp.n_tok) * tp.n_col * tp.splits;
  if (units > INT32_MAX) return cudaErrorInvalidValue;
  tp.units = static_cast<int>(units);
  const int slots = sms * (BT == 8 ? 2 : 1);
  int4_tile_kernel<BT, COLS><<<tp.units < slots ? tp.units : slots, C::kThreads, C::kSmem,
                               stream>>>(
      map_xlo, map_xhi, map_q, map_s, tp);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rga3

// Plain C entry point for ctypes, on CUDA device `device` (device.cuh).
// x (m, in) bf16, q (in/2, out) int8,
// scales (n_groups, out) f32 with group = 32 (in % 64 == 0) or in (one
// row), y (m, out) bf16, all contiguous and 16-byte aligned. With in % 16
// == 0 and out % 16 == 0 the TMA tile runs, its groups split over
// `splits` units (fewer when some would be empty; none when the tiles
// exceed the counters), and then ws, 16-byte aligned, holds
// rga3_int4_matmul_workspace_words(m, out, splits) 32-bit words whose
// first kCounters are zero (and are left zero); other shapes take the
// generic tile, which ignores splits. Calls that share a workspace must
// not overlap in time (one stream). Returns a cudaError_t (0 on
// success).
extern "C" int rga3_int4_matmul_bf16(int device, const void* x, const void* q,
                                     const void* scales, void* y, void* ws, int m, int in,
                                     int out, int group, int splits, void* stream) {
  using namespace rga3;
  if (const cudaError_t err = use_device(device); err != cudaSuccess) return err;
  if (m <= 0 || in <= 0 || out <= 0 || in % 2 || splits < 1 ||
      !((group == kGroup && in % (2 * kGroup) == 0) || (group == in && in % (2 * kGroup) != 0)) ||
      (splits > 1 && (ws == nullptr || m > 4)))
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits > 1 && reinterpret_cast<uintptr_t>(ws) % 16) return cudaErrorInvalidValue;
  if (in % 16 == 0 && out % 16 == 0) {
    int sms = 0;
    const cudaError_t err = sm_count(sms);
    if (err != cudaSuccess) return err;
    if (m > 4) return launch_tile<128, 128>(p, splits, sms, st);
    // 144-column units only where 128-column ones overflow one an SM and
    // these do not
    return (out + 127) / 128 > sms && (out + 143) / 144 <= sms
               ? launch_tile<8, 144>(p, splits, sms, st)
               : launch_tile<8, 128>(p, splits, sms, st);
  }
  if ((m + kBM - 1) / kBM > 65535) return cudaErrorInvalidValue;
  const dim3 grid((out + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  int4_mma_kernel<<<grid, kMmaThreads, 0, st>>>(p);
  return cudaGetLastError();
}

// 32-bit words of the workspace a split call needs: the counters and the
// partials.
extern "C" int64_t rga3_int4_matmul_workspace_words(int m, int out, int splits) {
  return rga3::kCounters + static_cast<int64_t>(splits) * m * out;
}

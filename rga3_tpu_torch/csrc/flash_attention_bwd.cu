// Flash attention backward for Hopper (sm_90a), (B, L, H, D) in bf16.
//
// Replaces the TPU backward of `flash_attention`: `_flash_tpu_bwd`
// (rga3_tpu/ops/attention.py:480), which reaches JAX's bundled Pallas
// flash kernels through `_bundled_flash` (:392): a recompute forward, then
// the `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq` pallas_calls.
// It computes dQ, dK and dV of exactly the function of the forward kernel
// (flash_attention.cu): GQA (kv head = h / (H / Hkv)), causal with lq == lk
// and top-left aligned, int32 q/kv segment ids, and the scale. The
// forward's log-sum-exp (natural log, f32, (B, H, Lq)) is the residual, so
// P is recomputed exactly: P = exp2(S * scale * log2(e) - LSE * log2(e)),
// zero where the mask drops the pair. As in the bundled Pallas backward
// (jax/experimental/pallas/ops/tpu/flash_attention.py:900,918,1258), P and
// dS are rounded to bf16 as the operands of the dV, dK and dQ products; dS
// itself is P * (dP - D) in f32.
//
// What bounds it on the H100: the backward does five D-long products per
// admitted (q, k) pair (S and dP recomputed, dV, dK, dQ) on the forward's
// bytes, so on a large call it is bound by the tensor cores. At the
// training slice's calls (the LM: B = 2, L = 512, 28/4 heads, D = 128; the
// SAM decoder: Lq = 4096, Lk = 9, D = 16) the least time is ~0.01 ms, and
// what decides the time is how many blocks keep the 132 SMs busy and how
// much of each tile is wasted on masked or missing keys.
//
// The design: FlashAttention-2's backward on mma.sync.m16n8k16 (bf16
// operands, f32 accumulators), from attention_mma.cuh's pieces: 16-byte
// cp.async copies into padded shared-memory rows, a 2-stage ring, ldmatrix
// (.trans for the operands read along the other axis) and bf16 A fragments
// taken straight from the accumulator layout. D = 72 is padded to 80 in
// shared memory, with zeroed pad columns, for the products over D. Four
// kernels:
//   1. delta: D_i = sum_d dO * O in f32, one warp per (b, row, head);
//   2. dkv: one block of 4 warps per (b, q head, 64-row kv tile, q chunk).
//      K and V stay in shared memory (read by ldmatrix per k-step, so that
//      the dK and dV sums, D f32 registers a thread together, do not spill);
//      a warp owns 16 kv rows. The block walks the q tiles of its chunk that
//      the skipping rule admits, with Q, dO, LSE and D of the next tile in
//      flight in the ring, and per 16- to 64-column slice of a tile it
//      computes S^T = K Q^T, P^T, dV += bf16(P^T) dO, dP^T = V dO^T,
//      dS^T = P^T (dP^T - D) and dK += bf16(dS^T) Q. The grid is split over
//      q heads (not looped over the GQA group) and over q chunks, chosen
//      here from the grid size, so that the LM call has 448 blocks and the
//      decoder call's 64 q tiles go over several blocks. Each block writes
//      f32 partials to scratch;
//   3. dkv_sum: adds the partials of the rep query heads and the chunks in a
//      fixed order (heads outer, chunks inner) and writes bf16 dK (times the
//      scale) and dV: no atomics, so two launches give the same bits;
//   4. dq: one block per (b, q head, 64-row q tile), the forward's layout
//      and causal order; Q and dO stay in shared memory, K and V (and the
//      kv segment ids) come through the ring; S = Q K^T, P, dP = dO V^T,
//      dS, then dQ += bf16(dS) K. No atomics.
// Block skipping is the forward's rule: a tile pair is visited only when
// the segment-id ranges meet and, when causal, the kv tile starts at or
// below the q tile's last row. Rows with no valid key get zero dQ and add
// nothing to dK / dV (P is zero on every masked pair, by a select).
#include "attention_mma.cuh"
#include "device.cuh"  // use_device, PerDevice

namespace rga3 {
namespace {

using namespace mma_attn;

constexpr int kDeltaThreads = 256;
// dkv blocks below which the q range is split into chunks: two per SM
constexpr int kTargetBlocks = 2 * 132;

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse;  // (B, H, Lq) contiguous
  float* delta;      // (B, H, Lq) contiguous scratch
  float* part;       // (2, chunks, B, H, Lk, D) f32 dK | dV partials
  bf16* dq;
  bf16* dk;
  bf16* dv;
  const int32_t* q_seg;   // (B, Lq) contiguous, or null
  const int32_t* kv_seg;  // (B, Lk) contiguous, or null
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int batch, lq, lk, h, rep, chunks;
  int causal;
  float mult;  // scale * log2(e)
  float scale;
};

// s = A B^T over the padded depth: A the 16 rows at `a`, B the NJ * 8 rows
// at `b` (shared memory, kStride apart); 16-row groups c >= nc of B are
// skipped (their fragments stay zero).
template <int D, int NJ>
__device__ __forceinline__ void mma_nt(float (&s)[NJ][4], const bf16* a, const bf16* b,
                                       int lane, int nc = NJ / 2) {
  constexpr int S = Dims<D>::kStride;
#pragma unroll
  for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  const bf16* ar = a + (lane & 15) * S + (lane >> 4) * 8;
  const bf16* br = b + ((lane & 7) + ((lane >> 4) << 3)) * S + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < Dims<D>::kKSteps; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, ar + kk * 16);
#pragma unroll
    for (int c = 0; c < NJ / 2; ++c) {
      if (c >= nc) continue;
      uint32_t bf[4];
      ldmatrix_x4(bf, br + 16 * c * S + kk * 16);
      mma16816(s[2 * c], af, bf[0], bf[1]);
      mma16816(s[2 * c + 1], af, bf[2], bf[3]);
    }
  }
}

// acc += bf16(f) R: f a 16 x (NJ * 8) fragment (the accumulator layout),
// R its NJ * 8 rows of D columns at `r` in shared memory (read transposed);
// 16-row groups c >= nc are skipped.
template <int D, int NJ>
__device__ __forceinline__ void mma_acc(float (&acc)[Dims<D>::kNTiles][4],
                                        const float (&f)[NJ][4], const bf16* r, int lane,
                                        int nc = NJ / 2) {
  constexpr int S = Dims<D>::kStride, NT = Dims<D>::kNTiles;
#pragma unroll
  for (int c = 0; c < NJ / 2; ++c) {
    if (c >= nc) continue;
    const uint32_t a[4] = {pack_bf16(f[2 * c][0], f[2 * c][1]),
                           pack_bf16(f[2 * c][2], f[2 * c][3]),
                           pack_bf16(f[2 * c + 1][0], f[2 * c + 1][1]),
                           pack_bf16(f[2 * c + 1][2], f[2 * c + 1][3])};
    const bf16* rr = r + (16 * c + (lane & 7) + ((lane >> 3) & 1) * 8) * S;
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, rr + jp * 16 + (lane >> 4) * 8);
      mma16816(acc[2 * jp], a, b[0], b[1]);
      mma16816(acc[2 * jp + 1], a, b[2], b[3]);
    }
    if constexpr (NT % 2 == 1) {  // D = 72: the ninth n8 tile
      uint32_t b[2];
      ldmatrix_x2_trans(b, rr + 8 * (NT - 1));
      mma16816(acc[NT - 1], a, b[0], b[1]);
    }
  }
}

// The min and max of 64 ints in shared memory, in every lane of the warp.
__device__ __forceinline__ int2 range64(const int* v, int lane) {
  const int a = v[lane], c = v[lane + 32];
  return make_int2(__reduce_min_sync(0xffffffffu, min(a, c)),
                   __reduce_max_sync(0xffffffffu, max(a, c)));
}

// The segment range of 64 positions from `pos0` (past `len`: `pad`).
__device__ __forceinline__ int2 seg_range(const int32_t* seg, int pos0, int len, int pad,
                                          int lane) {
  const int p = pos0 + lane;
  const int a = p < len ? seg[p] : pad;
  const int c = p + 32 < len ? seg[p + 32] : pad;
  return make_int2(__reduce_min_sync(0xffffffffu, min(a, c)),
                   __reduce_max_sync(0xffffffffu, max(a, c)));
}

// 1. D_i = sum_d dO[i, d] * O[i, d], one warp per (b, row, head).
template <int D>
__global__ void __launch_bounds__(kDeltaThreads) delta_kernel(BwdParams p) {
  const int64_t warp = ((int64_t)blockIdx.x * kDeltaThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (int64_t)p.batch * p.lq * p.h) return;
  const int h = static_cast<int>(warp % p.h);
  const int64_t rest = warp / p.h;
  const int i = static_cast<int>(rest % p.lq);
  const int b = static_cast<int>(rest / p.lq);
  const bf16* o = p.o + b * p.os.b + (int64_t)i * p.os.l + h * p.os.h;
  const bf16* g = p.dout + b * p.dos.b + (int64_t)i * p.dos.l + h * p.dos.h;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(__bfloat162float(o[d]), __bfloat162float(g[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[((int64_t)b * p.h + h) * p.lq + i] = acc;
}

// 2. dK and dV partials of 64 kv rows from one q head and one q chunk.
template <int D>
__global__ void __launch_bounds__(kBlockThreads, min_blocks<D>()) dkv_mma(BwdParams p) {
  constexpr int S = Dims<D>::kStride, NT = Dims<D>::kNTiles;
  // q columns a pass (one pass at a time): the S^T and dP^T fragments of
  // 16 (D = 128) or 32 (D = 72, 80) columns leave room for the dK and dV
  // sums in registers (ptxas spills with 32 at D = 128 and 64 at D = 80)
  constexpr int QC = D >= 128 ? 16 : D >= 72 ? 32 : 64, NJ = QC / 8;
  extern __shared__ uint4 smem_raw[];
  bf16* ksm = reinterpret_cast<bf16*>(smem_raw);
  bf16* vsm = ksm + kKeys * S;
  bf16* ring = vsm + kKeys * S;  // stage s: Q at 2 s kRows S, dO after it
  int2* qrange = reinterpret_cast<int2*>(ring + 2 * kStages * kRows * S);  // per q tile
  __shared__ float lse_s[kStages][kRows];
  __shared__ float dlt_s[kStages][kRows];
  __shared__ int qseg_s[kStages][kRows];
  __shared__ int kseg[kKeys];

  const int kt = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / p.chunks, chunk = blockIdx.z % p.chunks;
  const int k0 = kt * kKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = h / p.rep;
  const bool has_seg = p.q_seg != nullptr;
  const bf16* qbase = p.q + b * p.qs.b + h * p.qs.h;
  const bf16* gbase = p.dout + b * p.dos.b + h * p.dos.h;
  const int64_t rbase = ((int64_t)b * p.h + h) * p.lq;
  const int32_t* qsg = has_seg ? p.q_seg + (int64_t)b * p.lq : nullptr;

  zero_pad<D>(ksm, 2 * kKeys + 2 * kStages * kRows);  // every tile's pad columns
  load_rows<D, kKeys>(ksm, p.k + b * p.ks.b + hk * p.ks.h, p.ks.l, k0, p.lk);
  load_rows<D, kKeys>(vsm, p.v + b * p.vs.b + hk * p.vs.h, p.vs.l, k0, p.lk);
  cp_async_commit();
  if (threadIdx.x < kKeys) {
    const int pos = k0 + threadIdx.x;
    kseg[threadIdx.x] =
        pos < p.lk ? (has_seg ? p.kv_seg[(int64_t)b * p.lk + pos] : 0) : -1;
  }
  // this chunk's q tiles: causal (lq == lk) admits q tile t iff t >= kt
  const int nqt = (p.lq + kRows - 1) / kRows;
  const int lo = p.causal ? kt : 0;
  const int per = (nqt - lo + p.chunks - 1) / p.chunks;
  const int t_lo = min(nqt, lo + chunk * per), t_hi = min(nqt, t_lo + per);
  if (has_seg)
    for (int t = t_lo + warp; t < t_hi; t += kWarps) {
      const int2 r = seg_range(qsg, t * kRows, p.lq, -2, lane);
      if (lane == 0) qrange[t - t_lo] = r;
    }
  __syncthreads();
  const int2 kr = range64(kseg, lane);
  auto next_tile = [&](int t) {
    if (has_seg)
      while (t < t_hi && !(qrange[t - t_lo].y >= kr.x && qrange[t - t_lo].x <= kr.y)) ++t;
    return t;
  };
  auto load_tile = [&](int t, int stage) {
    bf16* qs = ring + 2 * stage * kRows * S;
    load_rows<D, kRows>(qs, qbase, p.qs.l, t * kRows, p.lq);
    load_rows<D, kRows>(qs + kRows * S, gbase, p.dos.l, t * kRows, p.lq);
    if (threadIdx.x < kRows) {  // past lq: zeros, and masked by position
      const int pos = t * kRows + threadIdx.x;
      const bool in = pos < p.lq;
      cp_async4(&lse_s[stage][threadIdx.x], in ? p.lse + rbase + pos : p.lse, in);
      cp_async4(&dlt_s[stage][threadIdx.x], in ? p.delta + rbase + pos : p.delta, in);
      if (has_seg) cp_async4(&qseg_s[stage][threadIdx.x], in ? qsg + pos : qsg, in);
    }
  };

  const int wrow = 16 * warp;
  int kpos[2], ksg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kpos[r] = k0 + wrow + (lane >> 2) + 8 * r;
    ksg[r] = kseg[wrow + (lane >> 2) + 8 * r];
  }
  const bool live = k0 + wrow < p.lk;  // warp-uniform: the warp has a valid kv row
  const bf16* kw = ksm + wrow * S;
  const bf16* vw = vsm + wrow * S;
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  int t = next_tile(t_lo), stage = 0;
  if (t < t_hi) load_tile(t, 0);
  cp_async_commit();
  cp_async_wait<0>();  // K, V and the first q tile
  __syncthreads();
  const int t2 = 2 * (lane & 3);
  while (t < t_hi) {
    // tile t is in `stage`; the other stage is free
    const int tn = next_tile(t + 1);
    if (tn < t_hi) load_tile(tn, stage ^ 1);
    cp_async_commit();
    if (live) {
      const bf16* qs = ring + 2 * stage * kRows * S;
      const bf16* gs = qs + kRows * S;
      const float* lse = lse_s[stage];
      const float* dlt = dlt_s[stage];
      const int* qsg_t = qseg_s[stage];
      const int q0 = t * kRows;
#pragma unroll 1
      for (int c0 = 0; c0 < kRows; c0 += QC) {
        float s[NJ][4];
        mma_nt<D, NJ>(s, kw, qs + c0 * S, lane);  // S^T = K Q^T
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + 8 * j + t2 + (e & 1), r = e >> 1;
            const int qpos = q0 + col;
            const bool keep = (qpos < p.lq) & (kpos[r] < p.lk) &
                              (!has_seg | (qsg_t[col] == ksg[r])) &
                              (!p.causal | (kpos[r] <= qpos));
            const float x = fast_exp2(s[j][e] * p.mult - lse[col] * kLog2e);
            s[j][e] = keep ? x : 0.f;
          }
        mma_acc<D, NJ>(dv, s, gs + c0 * S, lane);  // dV += P^T dO
        float dp[NJ][4];
        mma_nt<D, NJ>(dp, vw, gs + c0 * S, lane);  // dP^T = V dO^T
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[j][e] = s[j][e] * (dp[j][e] - dlt[c0 + 8 * j + t2 + (e & 1)]);
        mma_acc<D, NJ>(dk, dp, qs + c0 * S, lane);  // dK += dS^T Q
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // tile tn landed, tile t consumed
    stage ^= 1;
    t = tn;
  }
  if (!live) return;
  const int64_t plane = (int64_t)p.chunks * p.batch * p.h * p.lk * D;
  float* pk = p.part + (((int64_t)chunk * p.batch + b) * p.h + h) * p.lk * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= p.lk) continue;
    float* rk = pk + (int64_t)kpos[r] * D;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<float2*>(rk + 8 * j + t2) = make_float2(dk[j][2 * r], dk[j][2 * r + 1]);
      *reinterpret_cast<float2*>(rk + plane + 8 * j + t2) =
          make_float2(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

// 3. dK (times the scale) and dV: the partials of the rep query heads and
// the chunks summed in a fixed order, four columns a thread.
template <int D>
__global__ void __launch_bounds__(kDeltaThreads) dkv_sum(BwdParams p, int kv_heads) {
  constexpr int D4 = D / 4;
  const int64_t i = (int64_t)blockIdx.x * kDeltaThreads + threadIdx.x;
  if (i >= (int64_t)p.batch * p.lk * kv_heads * D4) return;
  const int d = static_cast<int>(i % D4) * 4;
  int64_t rest = i / D4;
  const int hk = static_cast<int>(rest % kv_heads);
  rest /= kv_heads;
  const int j = static_cast<int>(rest % p.lk);
  const int b = static_cast<int>(rest / p.lk);
  const int64_t plane = (int64_t)p.chunks * p.batch * p.h * p.lk * D;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int hh = 0; hh < p.rep; ++hh)
    for (int c = 0; c < p.chunks; ++c) {
      const int64_t off =
          ((((int64_t)c * p.batch + b) * p.h + hk * p.rep + hh) * p.lk + j) * D + d;
      const float4 x = *reinterpret_cast<const float4*>(p.part + off);
      const float4 y = *reinterpret_cast<const float4*>(p.part + plane + off);
      sk.x += x.x, sk.y += x.y, sk.z += x.z, sk.w += x.w;
      sv.x += y.x, sv.y += y.y, sv.z += y.z, sv.w += y.w;
    }
  bf16* dkr = p.dk + b * p.dks.b + (int64_t)j * p.dks.l + hk * p.dks.h + d;
  bf16* dvr = p.dv + b * p.dvs.b + (int64_t)j * p.dvs.l + hk * p.dvs.h + d;
  const float s = p.scale;
  reinterpret_cast<__nv_bfloat162*>(dkr)[0] = __floats2bfloat162_rn(sk.x * s, sk.y * s);
  reinterpret_cast<__nv_bfloat162*>(dkr)[1] = __floats2bfloat162_rn(sk.z * s, sk.w * s);
  reinterpret_cast<__nv_bfloat162*>(dvr)[0] = __floats2bfloat162_rn(sv.x, sv.y);
  reinterpret_cast<__nv_bfloat162*>(dvr)[1] = __floats2bfloat162_rn(sv.z, sv.w);
}

// 4. dQ of 64 query rows of one (b, head), over the admitted kv tiles.
template <int D>
__global__ void __launch_bounds__(kBlockThreads, min_blocks<D>()) dq_mma(BwdParams p) {
  constexpr int S = Dims<D>::kStride, NT = Dims<D>::kNTiles;
  extern __shared__ uint4 smem_raw[];
  bf16* qsm = reinterpret_cast<bf16*>(smem_raw);
  bf16* gsm = qsm + kRows * S;   // dO
  bf16* ring = gsm + kRows * S;  // stage s: K at 2 s kKeys S, V after it
  int2* krange = reinterpret_cast<int2*>(ring + 2 * kStages * kKeys * S);  // per kv tile
  __shared__ int qseg[kRows];
  __shared__ int kseg[kStages][kKeys];

  int qt, h, b;
  if (p.causal) {  // heaviest q tiles first
    h = blockIdx.x;
    b = blockIdx.y;
    qt = gridDim.z - 1 - blockIdx.z;
  } else {
    qt = blockIdx.x;
    h = blockIdx.y;
    b = blockIdx.z;
  }
  const int q0 = qt * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = h / p.rep;
  const bool has_seg = p.q_seg != nullptr;
  const bf16* kbase = p.k + b * p.ks.b + hk * p.ks.h;
  const bf16* vbase = p.v + b * p.vs.b + hk * p.vs.h;
  const int32_t* kvseg = has_seg ? p.kv_seg + (int64_t)b * p.lk : nullptr;

  zero_pad<D>(qsm, 2 * kRows + 2 * kStages * kKeys);
  load_rows<D, kRows>(qsm, p.q + b * p.qs.b + h * p.qs.h, p.qs.l, q0, p.lq);
  load_rows<D, kRows>(gsm, p.dout + b * p.dos.b + h * p.dos.h, p.dos.l, q0, p.lq);
  cp_async_commit();
  if (threadIdx.x < kRows) {
    const int pos = q0 + threadIdx.x;
    qseg[threadIdx.x] = pos < p.lq ? (has_seg ? p.q_seg[(int64_t)b * p.lq + pos] : 0) : -2;
  }
  const int nkt = p.causal ? qt + 1 : (p.lk + kKeys - 1) / kKeys;
  if (has_seg)
    for (int t = warp; t < nkt; t += kWarps) {
      const int2 r = seg_range(kvseg, t * kKeys, p.lk, -1, lane);
      if (lane == 0) krange[t] = r;
    }
  __syncthreads();
  const int2 qr = range64(qseg, lane);
  const int wrow = 16 * warp;
  const int qrow = q0 + wrow + (lane >> 2);  // this thread's first row
  int my_seg[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qrow + 8 * r;
    my_seg[r] = qseg[wrow + (lane >> 2) + 8 * r];
    const int64_t ri = ((int64_t)b * p.h + h) * p.lq + qi;
    lse2[r] = qi < p.lq ? p.lse[ri] * kLog2e : 0.f;
    dlt[r] = qi < p.lq ? p.delta[ri] : 0.f;
  }
  auto next_tile = [&](int t) {
    if (has_seg)
      while (t < nkt && !(qr.y >= krange[t].x && qr.x <= krange[t].y)) ++t;
    return t;
  };
  auto load_tile = [&](int t, int stage) {
    bf16* ks = ring + 2 * stage * kKeys * S;
    load_rows<D, kKeys>(ks, kbase, p.ks.l, t * kKeys, p.lk);
    load_rows<D, kKeys>(ks + kKeys * S, vbase, p.vs.l, t * kKeys, p.lk);
    if (has_seg && threadIdx.x < kKeys) {  // keys past lk are masked by position
      const int pos = t * kKeys + threadIdx.x;
      cp_async4(&kseg[stage][threadIdx.x], pos < p.lk ? kvseg + pos : kvseg, pos < p.lk);
    }
  };

  float dq[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  int t = next_tile(0), stage = 0;
  if (t < nkt) load_tile(t, 0);
  cp_async_commit();
  cp_async_wait<0>();  // Q, dO and the first kv tile
  __syncthreads();
  const int t2 = 2 * (lane & 3);
  const bf16* qw = qsm + wrow * S;
  const bf16* gw = gsm + wrow * S;
  while (t < nkt) {
    const int tn = next_tile(t + 1);
    if (tn < nkt) load_tile(tn, stage ^ 1);
    cp_async_commit();
    const int k0 = t * kKeys;
    const int nc = min(4, (p.lk - k0 + 15) / 16);  // 16-key groups holding a key
    const bf16* ks = ring + 2 * stage * kKeys * S;
    const bf16* vs = ks + kKeys * S;
    const int* kst = kseg[stage];
    float s[8][4], dp[8][4];
    mma_nt<D, 8>(s, qw, ks, lane, nc);  // S = Q K^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + t2 + (e & 1), r = e >> 1;
        const int pos = k0 + col;
        const bool keep = (pos < p.lk) & (!has_seg | (kst[col] == my_seg[r])) &
                          (!p.causal | (pos <= qrow + 8 * r));
        const float x = fast_exp2(s[j][e] * p.mult - lse2[r]);
        s[j][e] = keep ? x : 0.f;
      }
    mma_nt<D, 8>(dp, gw, vs, lane, nc);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - dlt[e >> 1]);
    mma_acc<D, 8>(dq, dp, ks, lane, nc);  // dQ += dS K
    cp_async_wait<0>();
    __syncthreads();  // tile tn landed, tile t consumed
    stage ^= 1;
    t = tn;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qrow + 8 * r;
    if (qi >= p.lq) continue;
    bf16* row = p.dq + b * p.dqs.b + (int64_t)qi * p.dqs.l + h * p.dqs.h;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + t2) =
          __floats2bfloat162_rn(dq[j][2 * r] * p.scale, dq[j][2 * r + 1] * p.scale);
  }
}

// The dkv kernel's q chunks: enough blocks for kTargetBlocks, each chunk at
// least four q tiles, and no empty chunk without causal.
int dkv_chunks(int batch, int lq, int lk, int heads) {
  const int64_t base = (int64_t)((lk + kKeys - 1) / kKeys) * heads * batch;
  const int nqt = (lq + kRows - 1) / kRows;
  if (base >= kTargetBlocks) return 1;
  const int want = static_cast<int>((kTargetBlocks + base - 1) / base);
  const int chunks = min(want, max(1, nqt / 4));
  const int per = (nqt + chunks - 1) / chunks;
  return (nqt + per - 1) / per;
}

// f32 words of delta, rounded up so that the partials after it are
// 16-byte aligned
int64_t delta_words(int batch, int lq, int heads) {
  return ((int64_t)batch * heads * lq + 3) / 4 * 4;
}

template <int D>
cudaError_t launch(const BwdParams& p, int kv_heads, cudaStream_t stream) {
  const int64_t rows = (int64_t)p.batch * p.lq * p.h;
  const int64_t delta_blocks = (rows * 32 + kDeltaThreads - 1) / kDeltaThreads;
  delta_kernel<D><<<static_cast<unsigned>(delta_blocks), kDeltaThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t tiles =
      size_t(2 * kKeys + 2 * kStages * kRows) * Dims<D>::kStride * sizeof(bf16);
  const int nqt = (p.lq + kRows - 1) / kRows, nkt = (p.lk + kKeys - 1) / kKeys;
  const size_t dkv_smem = tiles + (p.q_seg ? nqt * sizeof(int2) : 0);
  const size_t dq_smem = tiles + (p.q_seg ? nkt * sizeof(int2) : 0);
  if ((err = set_smem(dkv_mma<D>, dkv_smem)) != cudaSuccess) return err;
  if ((err = set_smem(dq_mma<D>, dq_smem)) != cudaSuccess) return err;
  dkv_mma<D><<<dim3(nkt, p.h, p.batch * p.chunks), kBlockThreads, dkv_smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t n = (int64_t)p.batch * p.lk * kv_heads * (D / 4);
  dkv_sum<D><<<static_cast<unsigned>((n + kDeltaThreads - 1) / kDeltaThreads), kDeltaThreads,
               0, stream>>>(p, kv_heads);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 dq_grid = p.causal ? dim3(p.h, p.batch, nqt) : dim3(nqt, p.h, p.batch);
  dq_mma<D><<<dq_grid, kBlockThreads, dq_smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rga3

// f32 words of scratch that rga3_flash_attention_bwd_bf16 needs at these
// sizes (delta, then the dkv partials); -1 for sizes it does not take.
extern "C" int64_t rga3_flash_attention_bwd_scratch_words(int batch, int lq, int lk,
                                                          int heads, int kv_heads,
                                                          int head_dim) {
  using namespace rga3;
  if (batch <= 0 || lq <= 0 || lk <= 0 || kv_heads <= 0 || heads % kv_heads != 0)
    return -1;
  const int chunks = dkv_chunks(batch, lq, lk, heads);
  return delta_words(batch, lq, heads) + 2 * (int64_t)chunks * batch * heads * lk * head_dim;
}

// Plain C entry point for ctypes, on CUDA device `device` (device.cuh).
// Strides are in elements, each tensor's
// head dim contiguous; q, k, v, o and do must have 16-byte aligned rows
// (which the wrapper checks); `delta` is f32 scratch of
// rga3_flash_attention_bwd_scratch_words(...) words; the segment ids may be
// null. Returns a cudaError_t (0 on success); cudaErrorInvalidValue for an
// unsupported head dim.
extern "C" int rga3_flash_attention_bwd_bf16(
    int device, const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, const void* q_seg,
    const void* kv_seg, int batch, int lq, int lk, int heads, int kv_heads, int head_dim,
    int64_t q_sb, int64_t q_sl, int64_t q_sh, int64_t k_sb, int64_t k_sl, int64_t k_sh,
    int64_t v_sb, int64_t v_sl, int64_t v_sh, int64_t o_sb, int64_t o_sl, int64_t o_sh,
    int64_t do_sb, int64_t do_sl, int64_t do_sh, int64_t dq_sb, int64_t dq_sl,
    int64_t dq_sh, int64_t dk_sb, int64_t dk_sl, int64_t dk_sh, int64_t dv_sb,
    int64_t dv_sl, int64_t dv_sh, int causal, float scale, void* stream) {
  using namespace rga3;
  if (const cudaError_t err = use_device(device); err != cudaSuccess) return err;
  if (heads % kv_heads != 0 || lq <= 0 || lk <= 0 || batch <= 0)
    return cudaErrorInvalidValue;
  const int chunks = dkv_chunks(batch, lq, lk, heads);
  if ((int64_t)batch * chunks > 65535 || heads > 65535) return cudaErrorInvalidValue;
  BwdParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<const bf16*>(o);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.part = p.delta + delta_words(batch, lq, heads);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.q_seg = static_cast<const int32_t*>(q_seg);
  p.kv_seg = static_cast<const int32_t*>(kv_seg);
  p.qs = {q_sb, q_sl, q_sh};
  p.ks = {k_sb, k_sl, k_sh};
  p.vs = {v_sb, v_sl, v_sh};
  p.os = {o_sb, o_sl, o_sh};
  p.dos = {do_sb, do_sl, do_sh};
  p.dqs = {dq_sb, dq_sl, dq_sh};
  p.dks = {dk_sb, dk_sl, dk_sh};
  p.dvs = {dv_sb, dv_sl, dv_sh};
  p.batch = batch;
  p.lq = lq;
  p.lk = lk;
  p.h = heads;
  p.rep = heads / kv_heads;
  p.chunks = chunks;
  p.causal = causal;
  p.mult = scale * kLog2e;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(p, kv_heads, s);
    case 72: return launch<72>(p, kv_heads, s);
    case 80: return launch<80>(p, kv_heads, s);
    case 128: return launch<128>(p, kv_heads, s);
    default: return cudaErrorInvalidValue;
  }
}

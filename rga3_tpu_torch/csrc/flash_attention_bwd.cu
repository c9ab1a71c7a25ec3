// Flash attention backward for Hopper (sm_90a), (B, L, H, D) in bf16.
//
// Replaces the TPU backward of `flash_attention`: `_flash_tpu_bwd`
// (rga3_tpu/ops/attention.py:480), which reaches JAX's bundled Pallas
// flash kernels through `_bundled_flash` (:392): a recompute forward, then
// the `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq` pallas_calls.
// It computes dQ, dK and dV of exactly the function of the forward kernel
// (flash_attention.cu): GQA (kv head = h / (H / Hkv)), causal with lq == lk
// and top-left aligned, int32 q/kv segment ids (q rows past lq count as
// segment -2, kv rows past lk as -1), the forward's block skipping, and the
// scale. The forward's log-sum-exp (natural log, f32, (B, H, Lq)) is the
// residual, so P is recomputed exactly: P = exp2(S * scale * log2(e) -
// LSE * log2(e)), zero where the mask drops the key.
//
// Three kernels, the standard flash recipe:
//   1. delta: D_i = sum_d dO * O in f32, one warp per (b, row, head);
//   2. dkv: one block per (b, kv head, 64-row kv tile). Each of its 64 kv
//      rows is held by four threads, in registers (K pre-multiplied by
//      scale * log2(e), V, and the f32 dK and dV sums). The block loops over
//      the `rep` query heads of its group and over the q tiles the
//      skipping rule admits, staging each q tile's Q and dO in shared
//      memory, and for every (q row, kv row) pair accumulates
//      dV += P * dO and dK += P * (dO . V - D) * Q. Summing the GQA group
//      inside the block gives deterministic dK / dV with no atomics (JAX
//      reaches the same sum through `jnp.repeat`'s transpose);
//   3. dq: one block per (b, q head, 64-row q tile), the forward's layout:
//      Q, dO and the f32 dQ sum in registers, K / V tiles staged in shared
//      memory, dQ += P * (dO . V - D) * K.
// dQ and dK are multiplied by the scale once, at the store.
//
// Rows with no valid key get zero dQ and add nothing to dK / dV (P is zero
// on every masked pair). The forward differs from `mha_reference` on such
// rows anyway; the training path has none (a causal mask, padding in a
// segment of its own).
//
// What bounds it on the H100: the backward does ~2.5x the forward's
// operations (five D-long products per admitted pair against two) on the
// same bytes, so it is bound by compute. Like the forward, this first
// design runs on the f32 FMA pipes, with float4 shared-memory reads and the
// row dot products finished by two xor-shuffles; mma.sync / wgmma tiles
// are for a later change.
#include "attention_tile.cuh"

namespace rga3 {
namespace {

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;       // (B, H, Lq) contiguous
  float* delta;           // (B, H, Lq) contiguous scratch
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const int32_t* q_seg;   // (B, Lq) contiguous, or null
  const int32_t* kv_seg;  // (B, Lk) contiguous, or null
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int batch, lq, lk, h, rep;
  int causal;
  float mult;   // scale * log2(e)
  float scale;
};

__device__ __forceinline__ int q_segment(const BwdParams& p, int b, int pos) {
  return pos < p.lq ? (p.q_seg ? p.q_seg[(int64_t)b * p.lq + pos] : 0) : -2;
}

__device__ __forceinline__ int kv_segment(const BwdParams& p, int b, int pos) {
  return pos < p.lk ? (p.kv_seg ? p.kv_seg[(int64_t)b * p.lk + pos] : 0) : -1;
}

__device__ __forceinline__ void seg_range(const int* seg, int& lo, int& hi) {
  lo = seg[0];
  hi = seg[0];
  for (int i = 1; i < kTileRows; ++i) {
    lo = min(lo, seg[i]);
    hi = max(hi, seg[i]);
  }
}

// Partial dot product of this thread's chunks with a shared-memory row,
// completed across the row's four threads.
template <int D>
__device__ __forceinline__ float row_dot(const float4 (&a)[HeadDim<D>::kChunks],
                                         const float* row, int t4) {
  const float4* r = reinterpret_cast<const float4*>(row);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < HeadDim<D>::kChunks; ++c) {
    const float4 x = r[t4 + 4 * c];
    acc = fmaf(a[c].x, x.x, acc);
    acc = fmaf(a[c].y, x.y, acc);
    acc = fmaf(a[c].z, x.z, acc);
    acc = fmaf(a[c].w, x.w, acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

// acc += w * row (this thread's chunks of a shared-memory row).
template <int D>
__device__ __forceinline__ void row_axpy(float4 (&acc)[HeadDim<D>::kChunks], float w,
                                         const float* row, int t4) {
  const float4* r = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int c = 0; c < HeadDim<D>::kChunks; ++c) {
    const float4 x = r[t4 + 4 * c];
    acc[c].x = fmaf(w, x.x, acc[c].x);
    acc[c].y = fmaf(w, x.y, acc[c].y);
    acc[c].z = fmaf(w, x.z, acc[c].z);
    acc[c].w = fmaf(w, x.w, acc[c].w);
  }
}

template <int D>
__device__ __forceinline__ void zero(float4 (&a)[HeadDim<D>::kChunks]) {
#pragma unroll
  for (int c = 0; c < HeadDim<D>::kChunks; ++c) a[c] = make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int D>
__device__ __forceinline__ void store_row(__nv_bfloat16* row,
                                          const float4 (&a)[HeadDim<D>::kChunks],
                                          float mul, int t4) {
#pragma unroll
  for (int c = 0; c < HeadDim<D>::kChunks; ++c) {
    const int d0 = (t4 + 4 * c) * 4;
    const float x[4] = {a[c].x, a[c].y, a[c].z, a[c].w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d0 + e < D) row[d0 + e] = __float2bfloat16(x[e] * mul);
  }
}

// 1. D_i = sum_d dO[i, d] * O[i, d], one warp per (b, row, head).
template <int D>
__global__ void __launch_bounds__(kThreads) delta_kernel(BwdParams p) {
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (int64_t)p.batch * p.lq * p.h) return;
  const int h = static_cast<int>(warp % p.h);
  const int64_t rest = warp / p.h;
  const int i = static_cast<int>(rest % p.lq);
  const int b = static_cast<int>(rest / p.lq);
  const __nv_bfloat16* o = p.o + b * p.os.b + (int64_t)i * p.os.l + h * p.os.h;
  const __nv_bfloat16* g = p.dout + b * p.dos.b + (int64_t)i * p.dos.l + h * p.dos.h;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(__bfloat162float(o[d]), __bfloat162float(g[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[((int64_t)b * p.h + h) * p.lq + i] = acc;
}

// 2. dK and dV of 64 kv rows of one (b, kv head), over the group's heads.
template <int D>
__global__ void __launch_bounds__(kThreads) dkv_kernel(BwdParams p) {
  constexpr int DP = HeadDim<D>::kPadded;
  constexpr int NC = HeadDim<D>::kChunks;
  extern __shared__ float4 smem4[];
  float* qsm = reinterpret_cast<float*>(smem4);  // Q tile, unscaled
  float* gsm = qsm + kTileRows * DP;             // dO tile
  __shared__ int kseg[kTileRows];
  __shared__ int qseg[kTileRows];
  __shared__ float lse2[kTileRows];  // LSE * log2(e)
  __shared__ float dlt[kTileRows];

  const int b = blockIdx.z, hk = blockIdx.y;
  const int k0 = blockIdx.x * kTileRows;
  const int row = threadIdx.x >> 2, t4 = threadIdx.x & 3;
  const int kj = k0 + row;

  if (threadIdx.x < kTileRows) kseg[threadIdx.x] = kv_segment(p, b, k0 + threadIdx.x);
  float4 kr[NC], vr[NC], dk[NC], dv[NC];
  load_q<D>(kr, p.k + b * p.ks.b + (int64_t)kj * p.ks.l + hk * p.ks.h, kj < p.lk, t4,
            p.mult);
  load_q<D>(vr, p.v + b * p.vs.b + (int64_t)kj * p.vs.l + hk * p.vs.h, kj < p.lk, t4,
            1.f);
  zero<D>(dk);
  zero<D>(dv);
  __syncthreads();
  int kmin, kmax;
  seg_range(kseg, kmin, kmax);
  const int my_seg = kseg[row];
  const bool k_valid = kj < p.lk;

  const int ntiles = (p.lq + kTileRows - 1) / kTileRows;
#pragma unroll 1
  for (int hh = 0; hh < p.rep; ++hh) {
    const int h = hk * p.rep + hh;
    const __nv_bfloat16* qbase = p.q + b * p.qs.b + h * p.qs.h;
    const __nv_bfloat16* gbase = p.dout + b * p.dos.b + h * p.dos.h;
    const int64_t rbase = ((int64_t)b * p.h + h) * p.lq;
#pragma unroll 1
    for (int t = 0; t < ntiles; ++t) {
      const int q0 = t * kTileRows;
      __syncthreads();  // the previous tile is consumed
      if (threadIdx.x < kTileRows) {
        const int pos = q0 + threadIdx.x;
        qseg[threadIdx.x] = q_segment(p, b, pos);
        lse2[threadIdx.x] = pos < p.lq ? p.lse[rbase + pos] * kLog2e : 0.f;
        dlt[threadIdx.x] = pos < p.lq ? p.delta[rbase + pos] : 0.f;
      }
      __syncthreads();
      int qmin, qmax;
      seg_range(qseg, qmin, qmax);
      bool visit = qmax >= kmin && qmin <= kmax;
      if (p.causal) visit = visit && k0 <= q0 + kTileRows - 1;
      if (!visit) continue;  // uniform across the block
      load_kv_tile<D>(qsm, gsm, qbase, gbase, p.qs.l, p.dos.l, q0, p.lq);
      __syncthreads();
#pragma unroll 1
      for (int i = 0; i < kTileRows; ++i) {
        const float* qrow = qsm + i * DP;
        const float* grow = gsm + i * DP;
        const float s = row_dot<D>(kr, qrow, t4);
        const float dp = row_dot<D>(vr, grow, t4);
        const bool keep = k_valid && qseg[i] == my_seg && (!p.causal || kj <= q0 + i);
        const float pr = keep ? exp2f(s - lse2[i]) : 0.f;
        const float ds = pr * (dp - dlt[i]);
        row_axpy<D>(dv, pr, grow, t4);
        row_axpy<D>(dk, ds, qrow, t4);
      }
    }
  }
  if (k_valid) {
    store_row<D>(p.dk + b * p.dks.b + (int64_t)kj * p.dks.l + hk * p.dks.h, dk, p.scale, t4);
    store_row<D>(p.dv + b * p.dvs.b + (int64_t)kj * p.dvs.l + hk * p.dvs.h, dv, 1.f, t4);
  }
}

// 3. dQ of 64 query rows of one (b, head), over the admitted kv tiles.
template <int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(BwdParams p) {
  constexpr int DP = HeadDim<D>::kPadded;
  constexpr int NC = HeadDim<D>::kChunks;
  extern __shared__ float4 smem4[];
  float* ksm = reinterpret_cast<float*>(smem4);
  float* vsm = ksm + kTileRows * DP;
  __shared__ int kseg[kTileRows];
  __shared__ int qseg[kTileRows];

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kTileRows;
  const int row = threadIdx.x >> 2, t4 = threadIdx.x & 3;
  const int qi = q0 + row;
  const int hk = h / p.rep;
  const bool q_valid = qi < p.lq;

  if (threadIdx.x < kTileRows) qseg[threadIdx.x] = q_segment(p, b, q0 + threadIdx.x);
  float4 q[NC], g[NC], dq[NC];
  load_q<D>(q, p.q + b * p.qs.b + (int64_t)qi * p.qs.l + h * p.qs.h, q_valid, t4, p.mult);
  load_q<D>(g, p.dout + b * p.dos.b + (int64_t)qi * p.dos.l + h * p.dos.h, q_valid, t4,
            1.f);
  zero<D>(dq);
  const int64_t r = ((int64_t)b * p.h + h) * p.lq + qi;
  const float lse2 = q_valid ? p.lse[r] * kLog2e : 0.f;
  const float dlt = q_valid ? p.delta[r] : 0.f;
  __syncthreads();
  int qmin, qmax;
  seg_range(qseg, qmin, qmax);
  const int my_seg = qseg[row];

  const __nv_bfloat16* kbase = p.k + b * p.ks.b + hk * p.ks.h;
  const __nv_bfloat16* vbase = p.v + b * p.vs.b + hk * p.vs.h;
  const int ntiles = (p.lk + kTileRows - 1) / kTileRows;
#pragma unroll 1
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kTileRows;
    __syncthreads();  // the previous tile is consumed
    if (threadIdx.x < kTileRows) kseg[threadIdx.x] = kv_segment(p, b, k0 + threadIdx.x);
    __syncthreads();
    int kmin, kmax;
    seg_range(kseg, kmin, kmax);
    bool visit = qmax >= kmin && qmin <= kmax;
    if (p.causal) visit = visit && k0 <= q0 + kTileRows - 1;
    if (!visit) continue;  // uniform across the block
    load_kv_tile<D>(ksm, vsm, kbase, vbase, p.ks.l, p.vs.l, k0, p.lk);
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < kTileRows; ++j) {
      const float* krow = ksm + j * DP;
      const float s = row_dot<D>(q, krow, t4);
      const float dp = row_dot<D>(g, vsm + j * DP, t4);
      const int pos = k0 + j;
      const bool keep = pos < p.lk && kseg[j] == my_seg && (!p.causal || pos <= qi);
      const float pr = keep ? exp2f(s - lse2) : 0.f;
      row_axpy<D>(dq, pr * (dp - dlt), krow, t4);
    }
  }
  if (q_valid)
    store_row<D>(p.dq + b * p.dqs.b + (int64_t)qi * p.dqs.l + h * p.dqs.h, dq, p.scale, t4);
}

template <int D>
cudaError_t launch(const BwdParams& p, int kv_heads, cudaStream_t stream) {
  const int64_t rows = (int64_t)p.batch * p.lq * p.h;
  const int64_t delta_blocks = (rows * 32 + kThreads - 1) / kThreads;
  delta_kernel<D><<<static_cast<unsigned>(delta_blocks), kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = tile_smem_bytes<D>();
  if ((err = set_smem(dkv_kernel<D>, smem)) != cudaSuccess) return err;
  if ((err = set_smem(dq_kernel<D>, smem)) != cudaSuccess) return err;
  const dim3 dkv_grid((p.lk + kTileRows - 1) / kTileRows, kv_heads, p.batch);
  dkv_kernel<D><<<dkv_grid, kThreads, smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 dq_grid((p.lq + kTileRows - 1) / kTileRows, p.h, p.batch);
  dq_kernel<D><<<dq_grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rga3

// Plain C entry point for ctypes. Strides are in elements, each tensor's
// head dim contiguous; `delta` is f32 scratch of (B, H, Lq); the segment
// ids may be null. Returns a cudaError_t (0 on success);
// cudaErrorInvalidValue for an unsupported head dim.
extern "C" int rga3_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, const void* q_seg,
    const void* kv_seg, int batch, int lq, int lk, int heads, int kv_heads, int head_dim,
    int64_t q_sb, int64_t q_sl, int64_t q_sh, int64_t k_sb, int64_t k_sl, int64_t k_sh,
    int64_t v_sb, int64_t v_sl, int64_t v_sh, int64_t o_sb, int64_t o_sl, int64_t o_sh,
    int64_t do_sb, int64_t do_sl, int64_t do_sh, int64_t dq_sb, int64_t dq_sl,
    int64_t dq_sh, int64_t dk_sb, int64_t dk_sl, int64_t dk_sh, int64_t dv_sb,
    int64_t dv_sl, int64_t dv_sh, int causal, float scale, void* stream) {
  using namespace rga3;
  if (heads % kv_heads != 0 || lq <= 0 || lk <= 0 || batch <= 0)
    return cudaErrorInvalidValue;
  BwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
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

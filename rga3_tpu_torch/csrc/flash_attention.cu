// Flash attention forward for Hopper (sm_90a), (B, L, H, D) in bf16.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `_flash_call`
// (rga3_tpu/ops/attention.py:75,189), reached through `flash_attention`.
// Same function: online-softmax attention with f32 accumulation, GQA
// (kv head = h / (H / Hkv)), optional causal mask (lq == lk, top-left
// aligned), int32 q/kv segment ids, and the same block skipping: a kv tile
// is visited only when its segment-id range meets the q tile's range
// (q rows past lq count as segment -2, kv rows past lk as -1) and, when
// causal, when it starts at or below the q tile's last row.
//
// Rows with no valid key follow the TPU kernel's rule: zero output where no
// kv tile was visited; where a tile was visited but every key in it was
// masked, the mean of V over the visited tiles' keys (keys past lk count as
// zero vectors). Tiles here are 64 rows, the TPU's 1024, so those rows
// differ between the two; rows with at least one valid key agree with
// `mha_reference`. Keys past lk are always masked.
//
// Given an `lse` pointer it also writes each row's f32 log-sum-exp (natural
// log, (B, H, Lq)), the residual of the backward kernel
// (flash_attention_bwd.cu): the running max and sum are in registers at the
// end anyway, so this costs one store per row, and nothing without it.
//
// What bounds it on the H100: at the main path's shapes (LM prefill
// L~1.3k D=128, ViT L~4.8k D=80, Hiera global L=4096 D=72) attention does
// ~4*L*D flops per byte of q/k/v read, far above the card's ~295
// flop/byte balance point, so it is bound by compute. This first design runs
// on the f32 FMA pipes, not the tensor cores: each 64x64 tile of scores is
// computed from q held in registers and k/v staged in shared memory, with
// float4 shared-memory reads so that each load feeds four FMAs. It is simple
// and right; wgmma, TMA and a deeper pipeline are for a later change.
#include "attention_tile.cuh"

namespace rga3 {
namespace {

struct FlashParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const int32_t* q_seg;   // (B, Lq) contiguous, or null
  const int32_t* kv_seg;  // (B, Lk) contiguous, or null
  float* lse;             // (B, H, Lq) contiguous, or null
  Strides qs, ks, vs, os;
  int lq, lk, h, rep;
  int causal;
  float mult;  // scale * log2(e)
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_kernel(FlashParams p) {
  constexpr int DP = HeadDim<D>::kPadded;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kTileRows * DP;
  __shared__ int kseg[kTileRows];
  __shared__ int qseg[kTileRows];

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kTileRows;
  const int row = threadIdx.x >> 2, t4 = threadIdx.x & 3;
  const int qi = q0 + row;
  const int hk = h / p.rep;

  if (threadIdx.x < kTileRows) {
    const int pos = q0 + threadIdx.x;
    qseg[threadIdx.x] =
        pos < p.lq ? (p.q_seg ? p.q_seg[(int64_t)b * p.lq + pos] : 0) : -2;
  }
  float4 q[HeadDim<D>::kChunks];
  load_q<D>(q, p.q + b * p.qs.b + (int64_t)qi * p.qs.l + h * p.qs.h,
            qi < p.lq, t4, p.mult);
  __syncthreads();
  int qmin = qseg[0], qmax = qseg[0];
  for (int i = 1; i < kTileRows; ++i) {
    qmin = min(qmin, qseg[i]);
    qmax = max(qmax, qseg[i]);
  }
  const int my_seg = qseg[row];

  const __nv_bfloat16* kbase = p.k + b * p.ks.b + hk * p.ks.h;
  const __nv_bfloat16* vbase = p.v + b * p.vs.b + hk * p.vs.h;
  RowState<D> st;
  st.init();
  const int ntiles = (p.lk + kTileRows - 1) / kTileRows;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kTileRows;
    __syncthreads();  // the previous tile is consumed
    if (threadIdx.x < kTileRows) {
      const int pos = k0 + threadIdx.x;
      kseg[threadIdx.x] =
          pos < p.lk ? (p.kv_seg ? p.kv_seg[(int64_t)b * p.lk + pos] : 0) : -1;
    }
    __syncthreads();
    int kmin = kseg[0], kmax = kseg[0];
    for (int i = 1; i < kTileRows; ++i) {
      kmin = min(kmin, kseg[i]);
      kmax = max(kmax, kseg[i]);
    }
    bool visit = qmax >= kmin && qmin <= kmax;
    if (p.causal) visit = visit && k0 <= q0 + kTileRows - 1;
    if (!visit) continue;  // uniform across the block
    load_kv_tile<D>(ks, vs, kbase, vbase, p.ks.l, p.vs.l, k0, p.lk);
    __syncthreads();
    const int lk = p.lk;
    const bool causal = p.causal;
    auto keep = [=](int j) {
      const int pos = k0 + j;
      return pos < lk && kseg[j] == my_seg && (!causal || pos <= qi);
    };
#pragma unroll 1
    for (int j0 = 0; j0 < kTileRows; j0 += kChunk)
      st.chunk(q, ks, vs, j0, t4, keep);
  }
  if (qi < p.lq) {
    st.store(p.o + b * p.os.b + (int64_t)qi * p.os.l + h * p.os.h, t4);
    // m and l are base-2 (scores carry log2(e)); no key visited -> -inf
    if (p.lse && t4 == 0)
      p.lse[((int64_t)b * p.h + h) * p.lq + qi] =
          st.l == 0.f ? -INFINITY : (st.m + log2f(st.l)) * kLn2;
  }
}

template <int D>
cudaError_t launch(const FlashParams& p, int batch, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes<D>();
  cudaError_t err = set_smem(flash_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.lq + kTileRows - 1) / kTileRows, p.h, batch);
  flash_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rga3

// Plain C entry point for ctypes. Strides are in elements; `lse` may be
// null. Returns a
// cudaError_t (0 on success); cudaErrorInvalidValue for an unsupported head
// dim.
extern "C" int rga3_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, const void* q_seg,
    const void* kv_seg, void* lse, int batch, int lq, int lk, int heads, int kv_heads,
    int head_dim, int64_t q_sb, int64_t q_sl, int64_t q_sh, int64_t k_sb,
    int64_t k_sl, int64_t k_sh, int64_t v_sb, int64_t v_sl, int64_t v_sh,
    int64_t o_sb, int64_t o_sl, int64_t o_sh, int causal, float scale,
    void* stream) {
  using namespace rga3;
  if (heads % kv_heads != 0 || lq <= 0 || lk <= 0) return cudaErrorInvalidValue;
  FlashParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.q_seg = static_cast<const int32_t*>(q_seg);
  p.kv_seg = static_cast<const int32_t*>(kv_seg);
  p.lse = static_cast<float*>(lse);
  p.qs = {q_sb, q_sl, q_sh};
  p.ks = {k_sb, k_sl, k_sh};
  p.vs = {v_sb, v_sl, v_sh};
  p.os = {o_sb, o_sl, o_sh};
  p.lq = lq;
  p.lk = lk;
  p.h = heads;
  p.rep = heads / kv_heads;
  p.causal = causal;
  p.mult = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(p, batch, s);
    case 72: return launch<72>(p, batch, s);
    case 80: return launch<80>(p, batch, s);
    case 128: return launch<128>(p, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

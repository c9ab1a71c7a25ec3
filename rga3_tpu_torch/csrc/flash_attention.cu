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
// `mha_reference`. Keys past lk are always masked. Every warp of a block
// attends to every tile the block visits, so this rule holds per 64-row q
// tile, as it did in the SIMT design this kernel replaces.
//
// Given an `lse` pointer it also writes each row's f32 log-sum-exp (natural
// log, (B, H, Lq); -inf where no tile was visited), the residual of the
// backward kernel (flash_attention_bwd.cu): the running max and sum are in
// registers at the end anyway, so this costs one store per row.
//
// What bounds it on the H100: at the main path's shapes (LM prefill
// L~1.3k D=128, ViT L~4.8k D=80, Hiera global L=4096 D=72) attention does
// ~4*L*D flops per byte of q/k/v read, far above the card's ~295
// flop/byte balance point, so it is bound by the tensor cores. The design is
// the tensor-core tile of attention_mma.cuh (FlashAttention-2 on
// mma.sync.m16n8k16: Q in registers, K/V through a 2-stage cp.async ring of
// 64-key bf16 tiles), one block of 4 warps per (64-row q tile, head, batch).
// Block skipping: with segment ids, the block first takes every kv tile's
// segment range with warp reductions into shared memory and then walks only
// the tiles it visits, prefetching the next visited one; a warp applies the
// masks only on tiles where they can drop a key for its rows (the causal
// diagonal, the ragged end, a segment boundary). Causal calls are laid out
// with the q tile as the slowest grid dimension and the heaviest tiles
// (most kv tiles to walk) first, so the long LM prefills end in a short
// tail; other calls keep a head's q tiles together, which share its K/V in
// the L2 cache.
//
// D = 256 is the SAM2 tracker's memory attention (one head; 4096 queries
// against 4096 keys, and against the static bank of 7 x 4096 mask-memory
// and 64 object-pointer keys whose validity rides the kv segment ids). Its
// Q tile stays in shared memory (attention_mma.cuh, kQSmem), one block an
// SM; the segment-range skip passes over the bank's invalid frames whole
// (4096 keys each, 64 tiles), so a call costs what its valid keys cost; the
// 64 pointer keys (28736 = 449 x 64) form one tile masked per key.
#include "attention_mma.cuh"
#include "device.cuh"  // use_device, PerDevice

namespace rga3 {
namespace {

using namespace mma_attn;

struct FlashParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const int32_t* q_seg;   // (B, Lq) contiguous, or null
  const int32_t* kv_seg;  // (B, Lk) contiguous, or null
  float* lse;             // (B, H, Lq) contiguous, or null
  Strides qs, ks, vs, os;
  int lq, lk, h, rep;
  int causal;
  float mult;  // scale * log2(e)
};

template <int D>
__global__ void __launch_bounds__(kBlockThreads, min_blocks<D>()) flash_fwd_mma(FlashParams p) {
  constexpr int S = Dims<D>::kStride;
  extern __shared__ uint4 smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // stage s: K at 2 s kKeys S, V after it
  bf16* qsm = q_tile<D>(ring);  // the Q tile (D <= 128: stage 1's K rows)
  int2* krange = reinterpret_cast<int2*>(ring + ring_rows<D>() * S);  // per kv tile
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
  const bf16* qbase = p.q + b * p.qs.b + h * p.qs.h;
  const bf16* kbase = p.k + b * p.ks.b + hk * p.ks.h;
  const bf16* vbase = p.v + b * p.vs.b + hk * p.vs.h;
  const int32_t* kvseg = has_seg ? p.kv_seg + (int64_t)b * p.lk : nullptr;

  zero_pad<D>(ring, 2 * kStages * kKeys);
  load_rows<D, kRows>(qsm, qbase, p.qs.l, q0, p.lq);
  cp_async_commit();
  if (threadIdx.x < kRows) {
    const int pos = q0 + threadIdx.x;
    qseg[threadIdx.x] = pos < p.lq ? (has_seg ? p.q_seg[(int64_t)b * p.lq + pos] : 0) : -2;
  }
  __syncthreads();
  // the q tile's segment range, and this warp's rows'
  int qmin, qmax;
  {
    const int a = qseg[lane], c = qseg[lane + 32];
    qmin = __reduce_min_sync(0xffffffffu, min(a, c));
    qmax = __reduce_max_sync(0xffffffffu, max(a, c));
  }
  const int wrow = 16 * warp;
  const int wseg = qseg[wrow + (lane & 15)];
  const int wmin = __reduce_min_sync(0xffffffffu, wseg);
  const bool w_uniform = wmin == __reduce_max_sync(0xffffffffu, wseg);
  const int my_seg[2] = {qseg[wrow + (lane >> 2)], qseg[wrow + (lane >> 2) + 8]};

  const int nkt = p.causal ? qt + 1 : (p.lk + kKeys - 1) / kKeys;
  if (has_seg) {  // each kv tile's segment range (keys past lk: -1)
    for (int t = warp; t < nkt; t += kWarps) {
      const int pos = t * kKeys + lane;
      const int a = pos < p.lk ? kvseg[pos] : -1;
      const int c = pos + 32 < p.lk ? kvseg[pos + 32] : -1;
      const int lo = __reduce_min_sync(0xffffffffu, min(a, c));
      const int hi = __reduce_max_sync(0xffffffffu, max(a, c));
      if (lane == 0) krange[t] = make_int2(lo, hi);
    }
    __syncthreads();
  }
  auto next_tile = [&](int t) {
    if (has_seg)
      while (t < nkt && !(qmax >= krange[t].x && qmin <= krange[t].y)) ++t;
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

  int t = next_tile(0), stage = 0;
  if (t < nkt) load_tile(t, 0);
  cp_async_commit();
  cp_async_wait<0>();  // the Q tile and the first tile
  __syncthreads();
  WarpTile<D> st;
  st.init(qsm + wrow * S, lane);
  __syncthreads();  // every warp holds its Q (D <= 128): stage 1 is free

  const int lk = p.lk;
  const bool causal = p.causal;
  const int qrow = q0 + wrow + (lane >> 2);  // this thread's first row
  while (t < nkt) {
    // tile t is in `stage`; the other stage is free
    const int tn = next_tile(t + 1);
    if (tn < nkt) load_tile(tn, stage ^ 1);
    cp_async_commit();
    const int k0 = t * kKeys;
    const int2 kr = has_seg ? krange[t] : make_int2(0, 0);
    const bool masked =
        k0 + kKeys > lk || (causal && k0 + kKeys - 1 > q0 + wrow) ||
        (has_seg && !(w_uniform && kr.x == kr.y && kr.x == wmin));
    const int* kst = kseg[stage];
    const bf16* ks = ring + 2 * stage * kKeys * S;
    st.template attend<true>(ks, ks + kKeys * S, 0, 4, p.mult, masked, lane, [&](int r, int j) {
      const int pos = k0 + j;
      return (pos < lk) & (!has_seg | (kst[j] == my_seg[r])) & (!causal | (pos <= qrow + 8 * r));
    });
    cp_async_wait<0>();
    __syncthreads();  // tile tn landed, tile t consumed
    stage ^= 1;
    t = tn;
  }
  st.finish_sums();
  const int row0 = q0 + wrow;
  st.store(qsm + wrow * S, p.o + b * p.os.b + h * p.os.h + (int64_t)row0 * p.os.l, p.os.l,
           min(16, p.lq - row0), lane);
  if (p.lse && (lane & 3) == 0) {
    // m and l are base-2 (scores carry log2(e)); no tile visited -> -inf
    float* lse = p.lse + ((int64_t)b * p.h + h) * p.lq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = qrow + 8 * r;
      if (qi < p.lq)
        lse[qi] = st.l[r] == 0.f ? -INFINITY : (st.m[r] + log2f(st.l[r])) * kLn2;
    }
  }
}

template <int D>
cudaError_t launch(const FlashParams& p, int batch, cudaStream_t stream) {
  const int nqt = (p.lq + kRows - 1) / kRows;
  const int nkt = (p.lk + kKeys - 1) / kKeys;
  const size_t smem = ring_smem_bytes<D>() + (p.q_seg ? nkt * sizeof(int2) : 0);
  cudaError_t err = set_smem(flash_fwd_mma<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = p.causal ? dim3(p.h, batch, nqt) : dim3(nqt, p.h, batch);
  flash_fwd_mma<D><<<grid, kBlockThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rga3

// Plain C entry point for ctypes, on CUDA device `device` (device.cuh).
// Strides are in elements; q, k and v must
// have 16-byte aligned rows (data pointers 16-byte aligned, strides
// multiples of 8), which the wrapper checks; `lse` may be null. Returns a
// cudaError_t (0 on success); cudaErrorInvalidValue for an unsupported head
// dim.
extern "C" int rga3_flash_attention_bf16(
    int device, const void* q, const void* k, const void* v, void* o, const void* q_seg,
    const void* kv_seg, void* lse, int batch, int lq, int lk, int heads, int kv_heads,
    int head_dim, int64_t q_sb, int64_t q_sl, int64_t q_sh, int64_t k_sb,
    int64_t k_sl, int64_t k_sh, int64_t v_sb, int64_t v_sl, int64_t v_sh,
    int64_t o_sb, int64_t o_sl, int64_t o_sh, int causal, float scale,
    void* stream) {
  using namespace rga3;
  if (const cudaError_t err = use_device(device); err != cudaSuccess) return err;
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
    case 256: return launch<256>(p, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

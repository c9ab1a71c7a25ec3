// Block-diagonal window attention forward for Hopper (sm_90a), bf16.
//
// Replaces the Pallas TPU kernel `_local_flash_kernel` / `_local_flash_call`
// (rga3_tpu/ops/attention.py:228,266), reached through `window_attention`.
// Tokens are window-major over (B, L, H, D): every `window` consecutive
// tokens form one window and attend only within it. f32 softmax and
// accumulation, mask-free (every window is full).
//
// Pooled queries: the same kernel also runs the attention of the q-pool
// transition block, `_transition_kernel` (rga3_tpu/ops/fused_block.py:917),
// whose queries are pooled 2x2 inside each window, so a window of `window`
// keys has `q_window = window / 4` queries (kv 16/64/256, q 4/16/64 on
// Hiera-L). Query window w attends to key window w.
//
// What bounds it on the H100: at Hiera-L's shapes (D=72, windows of 16, 64
// and 256 tokens) each token does 4*window*D flops against 8*D bytes of
// q/k/v/o, 32-128 flops per byte for windows of 16-64, under the card's
// ~295 flop/byte balance point, so it is bound by memory (window 256 sits
// near the balance point). The design is the tensor-core tile of
// attention_mma.cuh: a block of 4 warps owns 64 consecutive query rows of
// one (b, h), a run of query windows (q_window < 64) or a slice of one
// (q_window >= 64), and stages the union of its windows' keys through the
// 2-stage cp.async ring of 64-key tiles, so the next tile's copy is in
// flight while the tensor cores work on this one. Each warp's 16 rows
// attend only to their own windows' keys: a warp computes the 16-key chunks
// of a tile inside its rows' key range and skips the rest, so with windows
// of 16 a warp does one chunk of the block's one tile. A mask is needed
// only where a warp's 16 rows span several query windows (q_window < 16:
// the pooled q_window = 4 with kv window 16, where a warp covers 4 query
// windows over 64 keys, masked block-diagonally); every other case, (16,
// 16), (64, 64), (64, 16), (256, 256) and (256, 64), is mask-free.
#include "attention_mma.cuh"

namespace rga3 {
namespace {

using namespace mma_attn;

struct WindowParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  Strides qs, ks, vs, os;
  int len_q, len_kv, window, q_window;
  float mult;  // scale * log2(e)
};

template <int D>
__global__ void __launch_bounds__(kBlockThreads, min_blocks<D>()) window_fwd_mma(WindowParams p) {
  constexpr int S = Dims<D>::kStride;
  extern __shared__ uint4 smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // stage s: K at 2 s kKeys S, V after it
  bf16* qsm = ring + 2 * kKeys * S;                  // the Q tile: stage 1's K rows

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = p.window, qw = p.q_window;
  // the block's keys: the key windows of its query windows
  const int first = q0 / qw * w;
  const int end = ((min(q0 + kRows, p.len_q) - 1) / qw + 1) * w;
  // this warp's rows and their keys (multiples of 16: windows are)
  const int wq0 = q0 + 16 * warp;
  const int n_rows = min(16, p.len_q - wq0);
  const int wfirst = wq0 / qw * w;
  const int wend = n_rows > 0 ? ((wq0 + n_rows - 1) / qw + 1) * w : wfirst;
  const bool masked = qw < 16;  // the warp's rows span several query windows

  const bf16* kbase = p.k + b * p.ks.b + h * p.ks.h;
  const bf16* vbase = p.v + b * p.vs.b + h * p.vs.h;
  auto load_tile = [&](int k0, int stage) {
    bf16* ks = ring + 2 * stage * kKeys * S;
    load_rows<D, kKeys>(ks, kbase, p.ks.l, k0, end);
    load_rows<D, kKeys>(ks + kKeys * S, vbase, p.vs.l, k0, end);
  };

  zero_pad<D>(ring, 2 * kStages * kKeys);
  load_rows<D, kRows>(qsm, p.q + b * p.qs.b + h * p.qs.h, p.qs.l, q0, p.len_q);
  cp_async_commit();
  load_tile(first, 0);
  cp_async_commit();
  cp_async_wait<0>();  // the Q tile and the first tile
  __syncthreads();
  WarpTile<D> st;
  st.init(qsm + 16 * warp * S, lane);
  __syncthreads();  // every warp holds its Q: stage 1 is free

  const int g = lane >> 2;
  int stage = 0;
  for (int k0 = first; k0 < end; k0 += kKeys) {
    // tile k0 is in `stage`; the other stage is free
    if (k0 + kKeys < end) load_tile(k0 + kKeys, stage ^ 1);
    cp_async_commit();
    const int c_lo = max(wfirst - k0, 0) / 16;
    const int c_hi = min(max(wend - k0, 0), kKeys) / 16;
    const bf16* ks = ring + 2 * stage * kKeys * S;
    auto keep = [&](int r, int j) {
      const int start = (wq0 + g + 8 * r) / qw * w;  // the row's key window
      return (k0 + j >= start) & (k0 + j < start + w);
    };
    if (c_hi - c_lo == 4)
      st.template attend<true>(ks, ks + kKeys * S, 0, 4, p.mult, masked, lane, keep);
    else if (c_lo < c_hi)
      st.template attend<false>(ks, ks + kKeys * S, c_lo, c_hi, p.mult, masked, lane, keep);
    cp_async_wait<0>();
    __syncthreads();  // the next tile landed, this one consumed
    stage ^= 1;
  }
  st.finish_sums();
  st.store(qsm + 16 * warp * S, p.o + b * p.os.b + h * p.os.h + (int64_t)wq0 * p.os.l,
           p.os.l, n_rows, lane);
}

template <int D>
cudaError_t launch(const WindowParams& p, int batch, int heads, cudaStream_t stream) {
  const size_t smem = ring_smem_bytes<D>();
  cudaError_t err = set_smem(window_fwd_mma<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.len_q + kRows - 1) / kRows, heads, batch);
  window_fwd_mma<D><<<grid, kBlockThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rga3

// Plain C entry point for ctypes. Strides are in elements; q, k and v must
// have 16-byte aligned rows (data pointers 16-byte aligned, strides
// multiples of 8), which the wrapper checks. `len` keys in windows of
// `window`, a multiple of 16 that divides `len`; queries in windows of
// `q_window` (== window, or window / 4 for pooled queries), which must
// divide 64 or be a multiple of 64. Returns a cudaError_t (0 on success).
extern "C" int rga3_window_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int batch, int len,
    int heads, int head_dim, int window, int q_window, int64_t q_sb, int64_t q_sl,
    int64_t q_sh, int64_t k_sb, int64_t k_sl, int64_t k_sh, int64_t v_sb,
    int64_t v_sl, int64_t v_sh, int64_t o_sb, int64_t o_sl, int64_t o_sh,
    float scale, void* stream) {
  using namespace rga3;
  using namespace rga3::mma_attn;
  if (window <= 0 || window % 16 != 0 || len % window != 0 || q_window <= 0 ||
      (q_window != window && 4 * q_window != window) ||
      (q_window < kRows ? kRows % q_window : q_window % kRows) != 0)
    return cudaErrorInvalidValue;
  WindowParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.qs = {q_sb, q_sl, q_sh};
  p.ks = {k_sb, k_sl, k_sh};
  p.vs = {v_sb, v_sl, v_sh};
  p.os = {o_sb, o_sl, o_sh};
  p.len_kv = len;
  p.len_q = len / window * q_window;
  p.window = window;
  p.q_window = q_window;
  p.mult = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(p, batch, heads, s);
    case 72: return launch<72>(p, batch, heads, s);
    case 80: return launch<80>(p, batch, heads, s);
    case 128: return launch<128>(p, batch, heads, s);
    default: return cudaErrorInvalidValue;
  }
}

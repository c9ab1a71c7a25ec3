// Block-diagonal window attention forward for Hopper (sm_90a), bf16.
//
// Replaces the Pallas TPU kernel `_local_flash_kernel` / `_local_flash_call`
// (rga3_tpu/ops/attention.py:228,266), reached through `window_attention`.
// Tokens are window-major over (B, L, H, D): every `window` consecutive
// tokens form one window and attend only within it. f32 softmax and
// accumulation, mask-free (every window is full).
//
// What bounds it on the H100: at Hiera-L's shapes (D=72, windows of 16, 64
// and 256 tokens) each token does 4*window*D flops against 8*D bytes of
// q/k/v/o, 32-128 flops per byte for windows of 16-64, under the card's
// ~295 flop/byte balance point, so the tensor-core version is bound by
// memory. This first design runs on the f32 FMA pipes, where it is bound by
// those instead. A block owns 64 consecutive query rows of one (b, h), a run
// of windows (window < 64) or a slice of one window (window >= 64); it stages
// only its window's keys in 64-row tiles of shared memory and each row runs
// an online softmax over its own window's keys, 16 at a time, so no
// window x window score matrix is ever held and no masked key is computed:
// with window 16 the warp's 8 rows share one window and visit one 16-key
// chunk of the tile.
//
// Pooled queries: the same kernel also runs the attention of the q-pool
// transition block, `_transition_kernel` (rga3_tpu/ops/fused_block.py:917),
// whose queries are pooled 2x2 inside each window, so a window of `window`
// keys has `q_window = window / 4` queries (kv 16/64/256, q 4/16/64 on
// Hiera-L). Query window w attends to key window w. With q windows of 4
// rows a warp's 8 rows span two key windows; each row then also visits the
// other window's 16-key chunk with every score masked, which the online
// softmax weighs to zero, so the warp's shuffles stay converged.
#include "attention_tile.cuh"

namespace rga3 {
namespace {

struct WindowParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  Strides qs, ks, vs, os;
  int len_q, len_kv, window, q_window;
  float mult;  // scale * log2(e)
};

template <int D>
__global__ void __launch_bounds__(kThreads) window_kernel(WindowParams p) {
  constexpr int DP = HeadDim<D>::kPadded;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kTileRows * DP;

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kTileRows;
  const int row = threadIdx.x >> 2, t4 = threadIdx.x & 3;
  const int qi = q0 + row;

  float4 q[HeadDim<D>::kChunks];
  load_q<D>(q, p.q + b * p.qs.b + (int64_t)qi * p.qs.l + h * p.qs.h,
            qi < p.len_q, t4, p.mult);
  // keys of this block: the key windows of its query windows (its own 64
  // rows when q_window == window < 64, else the one window holding them)
  const int w = p.window, qw = p.q_window;
  const int last = min(q0 + kTileRows, p.len_q) - 1;
  const int first = q0 / qw * w;
  const int end = (last / qw + 1) * w;
  const int my_start = qi / qw * w;  // this row's key window

  const __nv_bfloat16* kbase = p.k + b * p.ks.b + h * p.ks.h;
  const __nv_bfloat16* vbase = p.v + b * p.vs.b + h * p.vs.h;
  RowState<D> st;
  st.init();
  for (int k0 = first; k0 < end; k0 += kTileRows) {
    __syncthreads();  // the previous tile is consumed
    load_kv_tile<D>(ks, vs, kbase, vbase, p.ks.l, p.vs.l, k0, p.len_kv);
    __syncthreads();
#pragma unroll 1
    for (int j0 = 0; j0 < kTileRows; j0 += kChunk) {
      const int pos = k0 + j0;
      // windows are whole 16-key chunks: a chunk is all in or all out
      const bool mine = pos >= my_start && pos < my_start + w;
      if (__any_sync(0xffffffffu, mine))
        st.chunk(q, ks, vs, j0, t4, [mine](int) { return mine; });
    }
  }
  if (qi < p.len_q)
    st.store(p.o + b * p.os.b + (int64_t)qi * p.os.l + h * p.os.h, t4);
}

template <int D>
cudaError_t launch(const WindowParams& p, int batch, int heads,
                   cudaStream_t stream) {
  const size_t smem = tile_smem_bytes<D>();
  cudaError_t err = set_smem(window_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.len_q + kTileRows - 1) / kTileRows, heads, batch);
  window_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rga3

// Plain C entry point for ctypes. Strides are in elements. `len` keys in
// windows of `window`, a multiple of 16 that divides `len`; queries in
// windows of `q_window` (== window, or window / 4 for pooled queries), which
// must divide 64 or be a multiple of 64. Returns a cudaError_t (0 on
// success).
extern "C" int rga3_window_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int batch, int len,
    int heads, int head_dim, int window, int q_window, int64_t q_sb, int64_t q_sl,
    int64_t q_sh, int64_t k_sb, int64_t k_sl, int64_t k_sh, int64_t v_sb,
    int64_t v_sl, int64_t v_sh, int64_t o_sb, int64_t o_sl, int64_t o_sh,
    float scale, void* stream) {
  using namespace rga3;
  if (window <= 0 || window % kChunk != 0 || len % window != 0 || q_window <= 0 ||
      (q_window != window && 4 * q_window != window) ||
      (q_window < kTileRows ? kTileRows % q_window : q_window % kTileRows) != 0)
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

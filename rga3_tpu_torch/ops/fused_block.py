"""Fused Hiera transformer blocks: hand-written CUDA kernels and their plain
PyTorch versions. Counterpart of `rga3_tpu/ops/fused_block.py`.

The JAX package runs each Hiera block as one Pallas kernel (or a few) that
keeps the block's weights resident in VMEM. No block's weights fit in an
H100 block's shared memory, so the port computes the same functions, with
the same bf16 rounding points, as chains of three kernels through device
memory:

  * `gemm` launches `csrc/gemm.cu`: a bf16 product on TMA and wgmma with
    a bias, GELU or residual epilogue;
  * `layer_norm` (whose bf16 output is the operand the Pallas bodies
    multiply after each LayerNorm) and `window_pool2x2` launch
    `csrc/row_ops.cu`;
  * attention is `window_attention` (with pooled queries for the q-pool
    transition) or `flash_attention` from `ops.attention`.

Each Pallas kernel's function is a wrapper here, built from those:

  Pallas kernel (rga3_tpu/ops/fused_block.py)  wrapper
  `_ln_matmul_kernel` (:312)                  `ln_qkv`
  `_proj_mlp_kernel` (:324)                   `proj_mlp`
  `_proj_ln_kernel` (:543)                    `proj_ln`
  `_mlp_blocked_kernel` (:583)                `mlp_blocked`
  `_fused_kernel` (:105)                      `fused_window_block`
  (the split window block, :694)              `fused_window_block_split`
  (the global block, :481)                    `fused_global_block`
  `_transition_kernel` (:917)                 `fused_transition_block`

Tokens are (B, L, D) and window-major, as in the JAX package; the params
dict has the JAX package's keys with the weights in `nn.Linear`'s (out, in)
layout (qkv rows ordered (q|k|v) x heads x head_dim). The TPU block sizes
(`block_q`, `block_f`, the config's `fused_block_q_*`) do not change the
function and are not taken.

Under f32 parameters (the train entry point's release default) the JAX
package computes the encoder in f32, and its Pallas bodies in their inputs'
dtype. On an f32 CUDA tensor every wrapper here then runs the f32 variants
of its three kernels (`gemm_f32`, `layer_norm_f32`, `window_pool2x2_f32`,
`csrc/f32_ops.cu`, and the f32 attention of `ops.attention`): the same
functions, kept in f32 wherever the bf16 route rounds, on the CUDA cores
(no TF32). Those calls count in the f32 kernels' records, not in the block
wrappers', whose records are the bf16 route's.

Every wrapper computes its plain version for a CPU tensor and, for a CUDA
tensor, launches its kernels or raises; it counts the calls that took the
kernel route in `<wrapper>.launches` and records them in `<wrapper>.shapes`
(see `ops.attention.reset_launches`). On the card each wrapper is
differentiable through its plain version (`ops.attention.recompute_backward`:
the backward recomputes the plain function under autograd), as the JAX
package's custom_vjps (`_fused_block_bwd`, `_global_block_bwd`,
`_split_window_block_bwd`, `_transition_bwd`) run theirs through XLA. As in
the JAX package, the fused window and transition blocks are one function
each: they chain the three kernels directly, and only the global and split
window blocks call (and so count) `ln_qkv`, `proj_mlp`, `proj_ln` and
`mlp_blocked`. The plain
versions (`*_reference`, `reference_*`) round to bf16 where the Pallas
kernel bodies do: products take bf16 operands and add the bias in f32
before rounding; LayerNorm statistics are f32 and its output is rounded
before the product; GELU runs in f32 on the rounded pre-activation; the
residual adds are bf16 adds, except `mlp_blocked`'s, which adds in f32 and
rounds once.
"""
from __future__ import annotations

import math
import os
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F

from . import _kernels
from .attention import (
    _record, flash_attention, mha_reference, recompute_backward, register,
    window_attention, window_reference,
)

EPILOGUES = {"bias": 0, "gelu_tanh": 1, "gelu_erf": 2, "res_bf16": 3, "res_f32": 4}


def gelu_variant(cfg_tanh: Optional[bool] = None) -> bool:
    """The GELU form, True for tanh: `RGA3_GELU_EXACT=1` (erf) or `=0`
    (tanh) overrides the config field for the whole process, and without
    either the field decides, tanh by default (the JAX package's rule, read
    at each block's call as there)."""
    env = os.environ.get("RGA3_GELU_EXACT", "")
    if env == "1":
        return False
    if env == "0":
        return True
    return True if cfg_tanh is None else bool(cfg_tanh)


def _gelu_epilogue(gelu_tanh: bool) -> str:
    return "gelu_tanh" if gelu_tanh else "gelu_erf"


def _layernorm(x32, g, b, eps):
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * g.float() + b.float()


# --------------------------------------------------------------------------
# plain versions of the three kernels
# --------------------------------------------------------------------------


def gemm_reference(a, w, bias, *, epilogue="bias", residual=None):
    """epilogue(a @ w.T + bias) in a's dtype; see `gemm` for the epilogues."""
    dt = a.dtype
    acc = a.float() @ w.float().t()
    if epilogue == "res_f32":
        return (residual.float() + bias.float() + acc).to(dt)
    h = (acc + bias.float()).to(dt)
    if epilogue == "bias":
        return h
    if epilogue in ("gelu_tanh", "gelu_erf"):
        approx = "tanh" if epilogue == "gelu_tanh" else "none"
        return F.gelu(h.float(), approximate=approx).to(dt)
    if epilogue == "res_bf16":
        return residual + h
    raise ValueError(f"gemm: unknown epilogue {epilogue!r}")


def layer_norm_reference(x, g, b, eps):
    return _layernorm(x.float(), g, b, eps).to(x.dtype)


def window_pool2x2_reference(x, ws: int):
    """(B, n_win*ws*ws, C) window-major tokens -> the 2x2 max inside each
    window, (B, n_win*(ws//2)**2, C)."""
    b, l, c = x.shape
    t = x.reshape(b, l // (ws * ws), ws // 2, 2, ws // 2, 2, c)
    return t.amax(dim=(3, 5)).reshape(b, -1, c)


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------


def _check_cuda(name: str, *ts: torch.Tensor, dtype=torch.bfloat16) -> None:
    dev = ts[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {dev}")
    for t in ts:
        if t.dtype != dtype:
            raise TypeError(f"{name}: the CUDA kernel takes {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: inputs on different devices")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and 16-byte aligned")


def gemm(a, w, bias, *, epilogue="bias", residual=None):
    """out[..., n] = epilogue(a[..., :] @ w[n, :] + bias[n]).

    a: (..., K); w: (N, K); bias: (N,). `epilogue`: "bias"; "gelu_tanh" /
    "gelu_erf" (GELU of the rounded sum); "res_bf16" (residual + rounded
    sum, a bf16 add); "res_f32" (residual + bias + the f32 product, rounded
    once). `residual` is (..., N).

    On a CUDA tensor it launches `csrc/gemm.cu` (bf16, contiguous and
    16-byte aligned, the bias and residual too, since TMA reads a and w;
    K a multiple of 8, N even), or for f32 operands the f32 variant
    (`gemm_f32`), or raises before any launch; on a CPU tensor it computes
    `gemm_reference`."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"gemm: unknown epilogue {epilogue!r}")
    if a.device.type == "cpu":
        return gemm_reference(a, w, bias, epilogue=epilogue, residual=residual)
    f32 = a.dtype == torch.float32
    k = a.shape[-1]
    n = w.shape[0]
    m = a.numel() // k
    needs_res = epilogue.startswith("res")
    _check_cuda("gemm", a, w, bias, *((residual,) if needs_res else ()),
                dtype=torch.float32 if f32 else torch.bfloat16)
    if (w.shape != (n, k) or bias.shape != (n,) or k % (4 if f32 else 8) or (n % 2 and not f32)
            or m == 0):
        raise ValueError(f"gemm: unsupported shapes a {tuple(a.shape)} w {tuple(w.shape)}")
    if needs_res and residual.shape != a.shape[:-1] + (n,):
        raise ValueError("gemm: the residual must have the output's shape")
    return recompute_backward(
        lambda a, w, bias, *r: _gemm(a, w, bias, epilogue, *r),
        lambda a, w, bias, *r: gemm_reference(a, w, bias, epilogue=epilogue,
                                              residual=r[0] if r else None),
        a, w, bias, *((residual,) if needs_res else ()))


def _gemm(a, w, bias, epilogue, residual=None):
    f32 = a.dtype == torch.float32
    k = a.shape[-1]
    n = w.shape[0]
    m = a.numel() // k
    out = torch.empty(a.shape[:-1] + (n,), dtype=a.dtype, device=a.device)
    device, stream = _kernels.launch_on("gemm", a, w, bias, residual)
    lib = _kernels.library()
    err = (lib.rga3_gemm_f32 if f32 else lib.rga3_gemm_bf16)(
        device, a.data_ptr(), k, w.data_ptr(), k, bias.data_ptr(),
        None if residual is None else residual.data_ptr(), n,
        out.data_ptr(), n, m, n, k, EPILOGUES[epilogue], stream,
    )
    _kernels.check(err, "gemm")
    _record(gemm_f32 if f32 else gemm, (m, n, k, epilogue))
    return out


def _f32_only(name: str, x) -> None:
    if x.device.type == "cuda" and x.dtype != torch.float32:
        raise TypeError(f"{name}: the f32 variant takes float32, got {x.dtype}")


def gemm_f32(a, w, bias, *, epilogue="bias", residual=None):
    """`gemm` on f32 operands, whose launches this wrapper counts: the f32
    variant of `csrc/f32_ops.cu`, f32 operands and FMA accumulation on the
    CUDA cores (no TF32, no tensor cores), K a multiple of 4; "res_bf16" is
    residual + (acc + bias), which the bf16 kernel rounds in between."""
    _f32_only("gemm_f32", a)
    return gemm(a, w, bias, epilogue=epilogue, residual=residual)


def layer_norm(x, g, b, eps):
    """LayerNorm(x) over the last dim with f32 statistics, rounded to x's
    dtype. On a CUDA tensor it launches `csrc/row_ops.cu` (bf16 and
    contiguous, gamma and beta too; D a multiple of 8), or for f32 inputs
    the f32 variant (`layer_norm_f32`; D a multiple of 4); on a CPU tensor
    it computes `layer_norm_reference`."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, g, b, eps)
    f32 = x.dtype == torch.float32
    _check_cuda("layer_norm", x, g, b, dtype=torch.float32 if f32 else torch.bfloat16)
    d = x.shape[-1]
    rows = x.numel() // d
    if d % (4 if f32 else 8) or rows == 0 or g.shape != (d,) or b.shape != (d,):
        raise ValueError(f"layer_norm: unsupported shape {tuple(x.shape)}")
    return recompute_backward(lambda x, g, b: _layer_norm(x, g, b, eps),
                              lambda x, g, b: layer_norm_reference(x, g, b, eps), x, g, b)


def _layer_norm(x, g, b, eps):
    f32 = x.dtype == torch.float32
    d = x.shape[-1]
    rows = x.numel() // d
    out = torch.empty_like(x)
    device, stream = _kernels.launch_on("layer_norm", x, g, b)
    lib = _kernels.library()
    err = (lib.rga3_layer_norm_f32 if f32 else lib.rga3_layer_norm_bf16)(
        device, x.data_ptr(), d, g.data_ptr(), b.data_ptr(), out.data_ptr(), d,
        rows, d, float(eps), stream,
    )
    _kernels.check(err, "layer_norm")
    _record(layer_norm_f32 if f32 else layer_norm, (rows, d, float(eps)))
    return out


def layer_norm_f32(x, g, b, eps):
    """`layer_norm` on f32 inputs, whose launches this wrapper counts: the
    f32 variant of `csrc/f32_ops.cu` (two-pass statistics, f32 output)."""
    _f32_only("layer_norm_f32", x)
    return layer_norm(x, g, b, eps)


def window_pool2x2(x, ws: int):
    """The 2x2 max pool inside each ws x ws window of window-major tokens,
    (B, n_win*ws*ws, C) -> (B, n_win*(ws//2)**2, C). x may be a column slice
    of a wider tensor (the q of a packed qkv). On a CUDA tensor it launches
    `csrc/row_ops.cu` (bf16, C and the row stride multiples of 8), or for
    f32 inputs the f32 variant (`window_pool2x2_f32`; multiples of 4); on a
    CPU tensor it computes `window_pool2x2_reference`."""
    if x.device.type == "cpu":
        return window_pool2x2_reference(x, ws)
    if x.device.type != "cuda":
        raise RuntimeError(f"window_pool2x2: no kernel for {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"window_pool2x2: the CUDA kernel takes bf16 or f32, got {x.dtype}")
    b, l, c = x.shape
    ld = x.stride(1)
    piece = 4 if x.dtype == torch.float32 else 8  # elements in 16 bytes
    if (ws % 2 or l % (ws * ws) or c % piece or x.stride(2) != 1 or ld % piece
            or x.stride(0) != l * ld or x.data_ptr() % 16):
        raise ValueError(
            f"window_pool2x2: unsupported input {tuple(x.shape)} {x.stride()} ws={ws}")
    return recompute_backward(lambda x: _window_pool2x2(x, ws),
                              lambda x: window_pool2x2_reference(x, ws), x)


def _window_pool2x2(x, ws):
    f32 = x.dtype == torch.float32
    b, l, c = x.shape
    ld = x.stride(1)
    out = torch.empty((b, l // 4, c), dtype=x.dtype, device=x.device)
    device, stream = _kernels.launch_on("window_pool2x2", x)
    lib = _kernels.library()
    err = (lib.rga3_window_pool2x2_f32 if f32 else lib.rga3_window_pool2x2_bf16)(
        device, x.data_ptr(), ld, out.data_ptr(), c, b * l // 4, ws, c, stream,
    )
    _kernels.check(err, "window_pool2x2")
    _record(window_pool2x2_f32 if f32 else window_pool2x2, (tuple(x.shape), x.stride(), int(ws)))
    return out


def window_pool2x2_f32(x, ws: int):
    """`window_pool2x2` on f32 inputs, whose launches this wrapper counts:
    the f32 variant of `csrc/f32_ops.cu`."""
    _f32_only("window_pool2x2_f32", x)
    return window_pool2x2(x, ws)


# --------------------------------------------------------------------------
# the Pallas kernels' functions, written once over a table of operations:
# the plain versions (_PLAIN) or the kernels' wrappers (_KERNEL)
# --------------------------------------------------------------------------


def _record_bf16(x, wrapper, key) -> None:
    """Record a block wrapper's call on the bf16 route; an f32 call counts
    in the f32 kernels' records only."""
    if x.dtype != torch.float32:
        _record(wrapper, key)


def _ln_qkv(o, x, g, b, w, bias, eps):
    return o.gemm(o.layer_norm(x, g, b, eps), w, bias)


def _proj_ln(o, attn, x, wproj, bproj, ln2_g, ln2_b, eps):
    y = o.gemm(attn, wproj, bproj, epilogue="res_bf16", residual=x)
    return y, o.layer_norm(y, ln2_g, ln2_b, eps)


def _mlp(o, ln2y, y, w1, b1, w2, b2, gelu_tanh, residual_epilogue):
    h = o.gemm(ln2y, w1, b1, epilogue=_gelu_epilogue(gelu_tanh))
    return o.gemm(h, w2, b2, epilogue=residual_epilogue, residual=y)


def _proj_mlp(o, attn, x, wproj, bproj, ln2_g, ln2_b, w1, b1, w2, b2, eps, gelu_tanh):
    y, ln2y = _proj_ln(o, attn, x, wproj, bproj, ln2_g, ln2_b, eps)
    return _mlp(o, ln2y, y, w1, b1, w2, b2, gelu_tanh, "res_bf16")


def _mlp_blocked(o, ln2y, y, w1, b1, w2, b2, gelu_tanh):
    return _mlp(o, ln2y, y, w1, b1, w2, b2, gelu_tanh, "res_f32")


def _mlp_args(p):
    return (p["ln2_g"], p["ln2_b"], p["w1"], p["b1"], p["w2"], p["b2"])


# The window block (`_fused_kernel`) and the transition (`_transition_kernel`)
# are one function each and chain the kernels directly; the global and the
# split window block call rows 4-7 through `o`, as the JAX package's do.


def _window_block(o, x, p, heads, window, eps, scale, gelu_tanh, split):
    b, l, d = x.shape
    ln1 = (x, p["ln1_g"], p["ln1_b"], p["wqkv"], p["bqkv"])
    qkv = o.ln_qkv(*ln1, eps=eps) if split else _ln_qkv(o, *ln1, eps)
    qkv = qkv.view(b, l, 3, heads, -1)
    attn = o.window(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], window,
                    scale=scale).reshape(b, l, d)
    if split:
        y, ln2y = o.proj_ln(attn, x, p["wproj"], p["bproj"], p["ln2_g"], p["ln2_b"], eps=eps)
        return o.mlp_blocked(ln2y, y, p["w1"], p["b1"], p["w2"], p["b2"], gelu_tanh=gelu_tanh)
    return _proj_mlp(o, attn, x, p["wproj"], p["bproj"], *_mlp_args(p), eps, gelu_tanh)


def _global_block(o, x, p, heads, eps, scale, gelu_tanh):
    b, l, d = x.shape
    qkv = o.ln_qkv(x, p["ln1_g"], p["ln1_b"], p["wqkv"], p["bqkv"], eps=eps)
    qkv = qkv.view(b, l, 3, heads, -1)
    attn = o.flash(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], scale=scale).reshape(b, l, d)
    return o.proj_mlp(attn, x, p["wproj"], p["bproj"], *_mlp_args(p), eps=eps,
                      gelu_tanh=gelu_tanh)


def _transition(o, x, p, heads, ws, eps, scale, gelu_tanh):
    b, l_in, _ = x.shape
    c_out = p["wproj"].shape[0]
    l_out = l_in // 4
    ln1 = o.layer_norm(x, p["ln1_g"], p["ln1_b"], eps)
    shortcut = o.pool(o.gemm(ln1, p["wproj"], p["bproj"]), ws)
    qkv = o.gemm(ln1, p["wqkv"], p["bqkv"])
    q = o.pool(qkv[:, :, :c_out], ws).view(b, l_out, heads, -1)
    kv = qkv.view(b, l_in, 3, heads, -1)
    attn = o.window(q, kv[:, :, 1], kv[:, :, 2], ws * ws, q_window=ws * ws // 4,
                    scale=scale).reshape(b, l_out, c_out)
    return _proj_mlp(o, attn, shortcut, p["wattn"], p["battn"], *_mlp_args(p), eps,
                     gelu_tanh)


_PLAIN = SimpleNamespace(
    gemm=gemm_reference, layer_norm=layer_norm_reference, pool=window_pool2x2_reference,
    window=lambda q, k, v, window, *, scale, q_window=None: window_reference(
        q, k, v, window, scale, q_window=q_window),
    flash=lambda q, k, v, *, scale: mha_reference(q, k, v, scale=scale),
)
_KERNEL = SimpleNamespace(
    gemm=gemm, layer_norm=layer_norm, pool=window_pool2x2, window=window_attention,
    flash=flash_attention,
)


def _scale(scale, d, heads):
    return 1.0 / math.sqrt(d // heads) if scale is None else scale


# --------------------------------------------------------------------------
# rows 4-7 of the Pallas kernels: plain versions and wrappers
# --------------------------------------------------------------------------


def ln_qkv_reference(x, g, b, w, bias, *, eps=1e-6):
    return _ln_qkv(_PLAIN, x, g, b, w, bias, eps)


def proj_mlp_reference(attn, x, wproj, bproj, ln2_g, ln2_b, w1, b1, w2, b2, *,
                       eps=1e-6, gelu_tanh=True):
    return _proj_mlp(_PLAIN, attn, x, wproj, bproj, ln2_g, ln2_b, w1, b1, w2, b2, eps,
                     gelu_tanh)


def proj_ln_reference(attn, x, wproj, bproj, ln2_g, ln2_b, *, eps=1e-6):
    return _proj_ln(_PLAIN, attn, x, wproj, bproj, ln2_g, ln2_b, eps)


def mlp_blocked_reference(ln2y, y, w1, b1, w2, b2, *, gelu_tanh=True):
    return _mlp_blocked(_PLAIN, ln2y, y, w1, b1, w2, b2, gelu_tanh)


def ln_qkv(x, g, b, w, bias, *, eps=1e-6):
    """LayerNorm -> x @ w.T + bias (the Pallas `_ln_matmul_kernel`)."""
    if x.device.type == "cpu":
        return ln_qkv_reference(x, g, b, w, bias, eps=eps)
    out = recompute_backward(lambda *t: _ln_qkv(_KERNEL, *t, eps),
                             lambda *t: _ln_qkv(_PLAIN, *t, eps), x, g, b, w, bias)
    _record_bf16(x, ln_qkv, (tuple(x.shape), w.shape[0], float(eps)))
    return out


def proj_mlp(attn, x, wproj, bproj, ln2_g, ln2_b, w1, b1, w2, b2, *, eps=1e-6,
             gelu_tanh=True):
    """y = x + (attn @ wproj.T + bproj); y + MLP(LN2(y)) (the Pallas
    `_proj_mlp_kernel`)."""
    if x.device.type == "cpu":
        return proj_mlp_reference(attn, x, wproj, bproj, ln2_g, ln2_b, w1, b1, w2, b2,
                                  eps=eps, gelu_tanh=gelu_tanh)
    out = recompute_backward(
        lambda *t: _proj_mlp(_KERNEL, *t, eps, gelu_tanh),
        lambda *t: _proj_mlp(_PLAIN, *t, eps, gelu_tanh),
        attn, x, wproj, bproj, ln2_g, ln2_b, w1, b1, w2, b2)
    _record_bf16(x, proj_mlp, (tuple(x.shape), w1.shape[0], float(eps), bool(gelu_tanh)))
    return out


def proj_ln(attn, x, wproj, bproj, ln2_g, ln2_b, *, eps=1e-6):
    """(y, LN2(y)) with y = x + (attn @ wproj.T + bproj) (the Pallas
    `_proj_ln_kernel`)."""
    if x.device.type == "cpu":
        return proj_ln_reference(attn, x, wproj, bproj, ln2_g, ln2_b, eps=eps)
    out = recompute_backward(lambda *t: _proj_ln(_KERNEL, *t, eps),
                             lambda *t: _proj_ln(_PLAIN, *t, eps),
                             attn, x, wproj, bproj, ln2_g, ln2_b)
    _record_bf16(x, proj_ln, (tuple(x.shape), float(eps)))
    return out


def mlp_blocked(ln2y, y, w1, b1, w2, b2, *, gelu_tanh=True):
    """bf16(f32(y) + b2 + gelu(ln2y @ w1.T + b1) @ w2.T) (the Pallas
    `_mlp_blocked_kernel`, whose hidden-dim blocks change nothing here)."""
    if y.device.type == "cpu":
        return mlp_blocked_reference(ln2y, y, w1, b1, w2, b2, gelu_tanh=gelu_tanh)
    out = recompute_backward(lambda *t: _mlp_blocked(_KERNEL, *t, gelu_tanh),
                             lambda *t: _mlp_blocked(_PLAIN, *t, gelu_tanh),
                             ln2y, y, w1, b1, w2, b2)
    _record_bf16(y, mlp_blocked, (tuple(y.shape), w1.shape[0], bool(gelu_tanh)))
    return out


_PLAIN.ln_qkv, _PLAIN.proj_mlp = ln_qkv_reference, proj_mlp_reference
_PLAIN.proj_ln, _PLAIN.mlp_blocked = proj_ln_reference, mlp_blocked_reference
_KERNEL.ln_qkv, _KERNEL.proj_mlp, _KERNEL.proj_ln, _KERNEL.mlp_blocked = (
    ln_qkv, proj_mlp, proj_ln, mlp_blocked)


# --------------------------------------------------------------------------
# the blocks (rows 3 and 8, the global and the split window block)
# --------------------------------------------------------------------------


def reference_block(x, params, *, num_heads, window, eps=1e-6, scale=None,
                    gelu_tanh=None, split=False):
    """Plain windowed block (`_reference_block`): LN1 -> qkv -> window
    attention -> proj + residual -> LN2 -> MLP + residual. `split=True`
    rounds as the split block's kernels do (`mlp_blocked`'s f32 residual)."""
    return _window_block(_PLAIN, x, params, num_heads, window, eps,
                         _scale(scale, x.shape[-1], num_heads), gelu_variant(gelu_tanh),
                         split)


def reference_global_block(x, params, *, num_heads, eps=1e-6, scale=None, gelu_tanh=None):
    """Plain global-attention block (`_reference_global_block`)."""
    return _global_block(_PLAIN, x, params, num_heads, eps,
                         _scale(scale, x.shape[-1], num_heads), gelu_variant(gelu_tanh))


def reference_transition(x, params, *, num_heads, ws, eps=1e-6, scale=None,
                         gelu_tanh=None):
    """Plain q-pool transition block (`_reference_transition`)."""
    c_out = params["wproj"].shape[0]
    return _transition(_PLAIN, x, params, num_heads, ws, eps, _scale(scale, c_out, num_heads),
                       gelu_variant(gelu_tanh))


def _block_call(block, x, params, *args):
    """`block(_KERNEL, x, params, *args)`, differentiable through
    `block(_PLAIN, ...)` in x and every tensor of the params dict."""
    keys = tuple(params)

    def route(o):
        return lambda x, *vals: block(o, x, dict(zip(keys, vals)), *args)

    return recompute_backward(route(_KERNEL), route(_PLAIN), x, *params.values())


def fused_window_block(x, params, *, num_heads, window, eps=1e-6, scale=None,
                       gelu_tanh=None):
    """Windowed transformer block over (B, L, D), window-major (the Pallas
    `_fused_kernel`): `ln_qkv` -> `window_attention` -> `proj_mlp`."""
    gelu_tanh = gelu_variant(gelu_tanh)
    scale = _scale(scale, x.shape[-1], num_heads)
    if x.device.type == "cpu":
        return reference_block(x, params, num_heads=num_heads, window=window, eps=eps,
                               scale=scale, gelu_tanh=gelu_tanh)
    out = _block_call(_window_block, x, params, num_heads, window, eps, scale, gelu_tanh,
                      False)
    _record_bf16(x, fused_window_block, (tuple(x.shape), params["w1"].shape[0], num_heads,
                                         window, float(eps), float(scale), gelu_tanh))
    return out


def fused_window_block_split(x, params, *, num_heads, window, eps=1e-6, scale=None,
                             gelu_tanh=None):
    """The windowed block for wide dims (Hiera stage 4): `ln_qkv` ->
    `window_attention` -> `proj_ln` -> `mlp_blocked`; the same function as
    `fused_window_block` but for the f32 residual add of `mlp_blocked`."""
    gelu_tanh = gelu_variant(gelu_tanh)
    scale = _scale(scale, x.shape[-1], num_heads)
    if x.device.type == "cpu":
        return reference_block(x, params, num_heads=num_heads, window=window, eps=eps,
                               scale=scale, gelu_tanh=gelu_tanh, split=True)
    out = _block_call(_window_block, x, params, num_heads, window, eps, scale, gelu_tanh,
                      True)
    _record_bf16(x, fused_window_block_split, (
        tuple(x.shape), params["w1"].shape[0], num_heads, window, float(eps), float(scale),
        gelu_tanh))
    return out


def fused_global_block(x, params, *, num_heads, eps=1e-6, scale=None, gelu_tanh=None):
    """Global-attention block: `ln_qkv` -> `flash_attention` -> `proj_mlp`."""
    gelu_tanh = gelu_variant(gelu_tanh)
    scale = _scale(scale, x.shape[-1], num_heads)
    if x.device.type == "cpu":
        return reference_global_block(x, params, num_heads=num_heads, eps=eps, scale=scale,
                                      gelu_tanh=gelu_tanh)
    out = _block_call(_global_block, x, params, num_heads, eps, scale, gelu_tanh)
    _record_bf16(x, fused_global_block, (tuple(x.shape), params["w1"].shape[0], num_heads,
                                         float(eps), float(scale), gelu_tanh))
    return out


def fused_transition_block(x, params, *, num_heads, ws, eps=1e-6, scale=None,
                           gelu_tanh=None):
    """q-pool transition block (the Pallas `_transition_kernel`).

    x: (B, n_win*ws*ws, C_in) window-major; returns (B, n_win*(ws//2)**2,
    C_out). params: ln1_g/b (C_in,), wproj (C_out, C_in) + bproj, wqkv
    (3*C_out, C_in) + bqkv, wattn (C_out, C_out) + battn, ln2_g/b (C_out,),
    w1 (F, C_out) + b1, w2 (C_out, F) + b2. LN1 -> proj, pooled 2x2 (the
    shortcut); LN1 -> qkv, q pooled 2x2 -> window attention of the pooled
    queries over their window's keys -> `proj_mlp` onto the shortcut."""
    gelu_tanh = gelu_variant(gelu_tanh)
    c_out = params["wproj"].shape[0]
    scale = _scale(scale, c_out, num_heads)
    if x.device.type == "cpu":
        return reference_transition(x, params, num_heads=num_heads, ws=ws, eps=eps,
                                    scale=scale, gelu_tanh=gelu_tanh)
    out = _block_call(_transition, x, params, num_heads, ws, eps, scale, gelu_tanh)
    _record_bf16(x, fused_transition_block, (tuple(x.shape), c_out, params["w1"].shape[0],
                                             num_heads, ws, float(eps), float(scale),
                                             gelu_tanh))
    return out


register(gemm, layer_norm, window_pool2x2, ln_qkv, proj_mlp, proj_ln, mlp_blocked,
         fused_window_block, fused_window_block_split, fused_global_block,
         fused_transition_block, gemm_f32, layer_norm_f32, window_pool2x2_f32)

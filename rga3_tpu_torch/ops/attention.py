"""Attention: hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of `rga3_tpu/ops/attention.py`. Layout is (B, L, H, D) for q, k
and v at every public function, as in the JAX package.

  * `flash_attention` launches `csrc/flash_attention.cu` for a CUDA tensor
    (the port of the Pallas `_flash_kernel`) and computes `mha_reference`
    for a CPU tensor. It is differentiable: on the card, a call whose
    inputs require grad keeps the forward's log-sum-exp, and its backward
    is `flash_attention_bwd`, which launches `csrc/flash_attention_bwd.cu`
    (the port of the bundled Pallas dq/dkv kernels that `_flash_tpu_bwd`
    runs); on the CPU autograd runs through `mha_reference`.
  * `window_attention` launches `csrc/window_attention.cu` for a CUDA tensor
    (the port of the Pallas `_local_flash_kernel`) and computes
    `window_reference` for a CPU tensor. Its backward recomputes
    `window_reference` under autograd, as the JAX package's custom_vjp does.

Under f32 parameters the SAM2 encoder and mask decoder compute in f32, as
the JAX package's do: on an f32 CUDA tensor `window_attention` and
`flash_attention` (non-causal, without segment ids) launch the f32 variant
of `csrc/f32_ops.cu` instead, counted in `window_attention_f32` and
`flash_attention_f32`.

A wrapper never falls back: on a CUDA tensor it launches its kernel or
raises. Each wrapper counts its launches in `<wrapper>.launches`, so a run
can show that it went through the kernel, and keeps in `<wrapper>.shapes`
every distinct call it launched (shapes, strides, options) with its count
and, for flash, the segment ids of its first SEGMENT_RECORDS launches (for
its backward the first launch's), so that the kernel can be checked again
at exactly the calls a run gave it. `reset_launches()` clears both.

`mha_reference` is also the port's attention wherever the JAX package runs
plain XLA attention rather than a Pallas kernel (short query runs, the Qwen
ViT's per-window attention). `set_plain_attention(model, True)` routes a
model's kernel call sites to the plain versions, explicitly, so that a run
on the card can be held against them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _kernels

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# head dims of the forward kernel: SAM decoder, Hiera, ViT, LM, SAM2 memory attention
KERNEL_HEAD_DIMS = (16, 72, 80, 128, 256)
# of the backward kernel: the train step's (the tracker does not train)
BWD_HEAD_DIMS = (16, 72, 80, 128)
# of the f32 attention (csrc/f32_ops.cu): the SAM2 encoder's and decoder's
F32_HEAD_DIMS = (16, 72, 80, 128)
# launches of one flash call (shapes, strides, options) whose segment ids are
# kept: the tracker's bank gains valid frames from frame to frame at one shape
# (28 such launches an 8-frame track); bounded, so a long run holds ~16 MB a call
SEGMENT_RECORDS = 64


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Plain attention. q: (B, Lq, H, D); k/v: (B, Lk, Hkv, D). f32 logits
    and softmax; the causal mask is bottom-right aligned (tril k=lk-lq).
    `return_lse=True` also returns the rows' f32 log-sum-exp of the masked
    logits, (B, H, Lq)."""
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = None
    if causal:
        mask = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril(
            lk - lq
        )[None, None]
    if segment_ids is not None:
        kv_seg = kv_segment_ids if kv_segment_ids is not None else segment_ids
        seg = segment_ids[:, None, :, None] == kv_seg[:, None, None, :]
        mask = seg if mask is None else (mask & seg)
    if mask is not None:
        logits = logits.masked_fill(~mask, DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    if return_lse:
        return out.to(q.dtype), torch.logsumexp(logits, dim=-1)
    return out.to(q.dtype)


def _allowed(b, lq, lk, device, causal, segment_ids, kv_segment_ids):
    """(B, 1, Lq, Lk) bool: the (query, key) pairs the masks keep, or None
    for all of them (causal top-left aligned: lq == lk wherever it is set)."""
    mask = None
    if causal:
        mask = torch.ones(lq, lk, dtype=torch.bool, device=device).tril()[None, None]
    if segment_ids is not None:
        kv = kv_segment_ids if kv_segment_ids is not None else segment_ids
        seg = segment_ids.to(device)[:, None, :, None] == kv.to(device)[:, None, None, :]
        mask = seg if mask is None else mask & seg
    return mask


def flash_attention_bwd_reference(
    q, k, v, o, lse, do, *, causal: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
):
    """Plain backward of flash attention: (dq, dk, dv) in the inputs' dtypes
    from q, k, v, the forward's output o, its log-sum-exp `lse` (B, H, Lq,
    f32, natural log) and the output gradient do, in f32. P = exp(S - lse)
    on the pairs the masks keep and 0 elsewhere, D = sum(do * o), dS = P *
    (do . v - D); dK and dV are summed over each kv head's query heads.
    Rows with no valid key get zero dq and add nothing to dk / dv."""
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    qf, dof = q.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse.float()[..., None])
    mask = _allowed(b, lq, lk, q.device, causal, segment_ids, kv_segment_ids)
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)  # (B, H, Lq)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dk = dk.reshape(b, lk, hkv, rep, d).sum(3)
    dv = dv.reshape(b, lk, hkv, rep, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def window_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
    scale: float, q_window: Optional[int] = None,
) -> torch.Tensor:
    """Window-local attention: each `window`-token group of keys is attended
    by its group of `q_window` queries (default `window`: the same tokens,
    the function of block-diagonal masking)."""
    qw = window if q_window is None else q_window
    b, lk, h, d = k.shape
    nw = lk // window
    out = mha_reference(
        q.reshape(b * nw, qw, h, d), k.reshape(b * nw, window, h, d),
        v.reshape(b * nw, window, h, d), scale=scale,
    )
    return out.reshape(b, nw * qw, h, d)


def set_plain_attention(model: torch.nn.Module, plain: bool) -> None:
    """Route every attention call site of `model` (modules with a
    `plain_attention` attribute) to the plain versions, or back."""
    for m in model.modules():
        if hasattr(m, "plain_attention"):
            m.plain_attention = plain


def _check_cuda_inputs(name: str, *ts: torch.Tensor, head_dims=KERNEL_HEAD_DIMS) -> None:
    """The kernels' input contract for every tensor given (q, k and v; for
    the backward also o and do): bf16, the head dim contiguous, one device,
    a head dim in `head_dims`, and rows the kernels can copy in 16-byte pieces:
    the data pointer 16-byte aligned, the batch, row and head strides
    multiples of 8 elements (a dim of size 1 is never stepped)."""
    for t in ts:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bf16, got {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous")
        if t.device != ts[0].device:
            raise ValueError(f"{name}: inputs on different devices")
        if t.data_ptr() % 16 or any(t.stride(d) % 8 for d in range(3) if t.shape[d] > 1):
            raise ValueError(
                f"{name}: the kernel copies 16-byte rows; got a data pointer "
                f"{t.data_ptr() % 16} bytes past 16-byte alignment, strides {t.stride()}")
    if ts[0].shape[-1] not in head_dims:
        raise ValueError(f"{name}: head dim {ts[0].shape[-1]} not in {head_dims}")


def _ptr_strides(t: torch.Tensor):
    return [t.stride(0), t.stride(1), t.stride(2)]


def _check_f32_inputs(name: str, *ts: torch.Tensor) -> None:
    """The f32 attention's input contract (q, k, v): f32, the head dim
    contiguous, one device, a head dim in F32_HEAD_DIMS, and 8-byte pieces:
    the data pointer 8-byte aligned, the strides of every dim longer than
    one even."""
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the f32 CUDA kernel takes float32, got {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous")
        if t.device != ts[0].device:
            raise ValueError(f"{name}: inputs on different devices")
        if t.data_ptr() % 8 or any(t.stride(d) % 2 for d in range(3) if t.shape[d] > 1):
            raise ValueError(f"{name}: the f32 kernel reads 8-byte pieces; got a data pointer "
                             f"{t.data_ptr() % 8} bytes past 8-byte alignment, strides "
                             f"{t.stride()}")
    if ts[0].shape[-1] not in F32_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {ts[0].shape[-1]} not in {F32_HEAD_DIMS}")


def _f32_strides(t: torch.Tensor):
    """(batch, row, head) strides, 0 for a dim of one (never stepped)."""
    return [t.stride(d) if t.shape[d] > 1 else 0 for d in range(3)]


def _attention_f32(q, k, v, window, qw, scale):
    """Launch the f32 attention of `csrc/f32_ops.cu`: query window w
    (`qw` rows of q) attends to key window w (`window` keys of k and v)."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    out = torch.empty((b, lq, h, d), dtype=torch.float32, device=q.device)
    device, stream = _kernels.launch_on("attention_f32", q, k, v)
    err = _kernels.library().rga3_attention_f32(
        device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, lk, h, d, window, qw, *_f32_strides(q), *_f32_strides(k), *_f32_strides(v),
        *_f32_strides(out), float(scale), stream,
    )
    _kernels.check(err, "attention_f32")
    return out


def _record(wrapper, key, extra=None, keep=0) -> None:
    """Count one launch of `wrapper`'s kernel and the call it made: with
    `keep`, the `extra` of its first `keep` launches as a tuple (rebuilt,
    not appended to, so that a snapshot of the record keeps what it saw),
    else the first launch's."""
    wrapper.launches += 1
    seen = wrapper.shapes.get(key)
    if seen is None:
        wrapper.shapes[key] = [1, (extra,) if keep else extra]
    else:
        seen[0] += 1
        if keep and len(seen[1]) < keep:
            seen[1] = seen[1] + (extra,)


_WRAPPERS = []


def register(*wrappers) -> None:
    """Give kernel wrappers their `launches` and `shapes` records and put
    them under `reset_launches()`."""
    for wrapper in wrappers:
        wrapper.launches = 0
        wrapper.shapes = {}
        _WRAPPERS.append(wrapper)


def reset_launches() -> None:
    """Zero every registered wrapper's launch count and forget the calls it
    saw (these, and those of `ops.fused_block` and `ops.quant` once imported)."""
    for wrapper in _WRAPPERS:
        wrapper.launches = 0
        wrapper.shapes = {}


class _RecomputeBackward(torch.autograd.Function):
    """Forward through a kernel wrapper; backward by recomputing a plain
    version under autograd and differentiating it: the design of the JAX
    package's custom_vjps around its Pallas kernels, whose residuals are
    just the inputs."""

    @staticmethod
    def forward(ctx, kernel, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            outs = ctx.plain(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wanted = [t for t, n in zip(inputs, need) if n]
        got = iter(torch.autograd.grad(outs, wanted, grads, allow_unused=True))
        return (None, None, *(next(got) if n else None for n in need))


def recompute_backward(kernel, plain, *inputs: torch.Tensor):
    """`kernel(*inputs)`, differentiable through `plain(*inputs)` (the same
    function) when grad is on and an input requires it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _RecomputeBackward.apply(kernel, plain, *inputs)
    return kernel(*inputs)


def _flash_forward(q, k, v, q_seg, kv_seg, causal, scale, with_lse):
    """Launch the forward kernel: out (B, Lq, H, D), and the rows' f32
    log-sum-exp (B, H, Lq) when `with_lse`."""
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    device, stream = _kernels.launch_on("flash_attention", q, k, v, q_seg, kv_seg)
    lib = _kernels.library()
    err = lib.rga3_flash_attention_bf16(
        device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if q_seg is None else q_seg.data_ptr(),
        None if kv_seg is None else kv_seg.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, lq, lk, h, hkv, d,
        *_ptr_strides(q), *_ptr_strides(k), *_ptr_strides(v),
        *_ptr_strides(out), int(causal), float(scale), stream,
    )
    _kernels.check(err, "flash_attention")
    key = (tuple(q.shape), q.stride(), tuple(k.shape), k.stride(), v.stride(),
           bool(causal), float(scale))
    seen = flash_attention.shapes.get(key)
    segs = None  # device copies, no host sync
    if q_seg is not None and (seen is None or len(seen[1]) < SEGMENT_RECORDS):
        segs = (q_seg.clone(), kv_seg.clone())
    _record(flash_attention, key, segs, keep=SEGMENT_RECORDS)
    return out, lse


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *, causal: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
):
    """(dq, dk, dv) of flash attention, from its inputs, output o, the
    forward's log-sum-exp `lse` (B, H, Lq, f32) and the output gradient do.

    On a CUDA tensor it launches `csrc/flash_attention_bwd.cu` (bf16 q, k,
    v, o and do with 16-byte aligned rows, the head dims of the forward;
    dq / dk / dv contiguous); on a CPU tensor it computes
    `flash_attention_bwd_reference`."""
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    if causal and lq != lk:
        raise NotImplementedError("flash_attention_bwd(causal=True) requires lq == lk")
    kw = dict(causal=causal, segment_ids=segment_ids, kv_segment_ids=kv_segment_ids,
              scale=scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_bwd: no kernel for {q.device}")
    do = do.contiguous()
    _check_cuda_inputs("flash_attention_bwd", q, k, v, o, do, head_dims=BWD_HEAD_DIMS)
    if (h % hkv != 0 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or o.shape != q.shape or do.shape != q.shape):
        raise ValueError("flash_attention_bwd: mismatched q/k/v/o/do shapes")
    if lse.dtype != torch.float32 or lse.shape != (b, h, lq) or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be contiguous f32 (B, H, Lq)")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q_seg, kv_seg = _segments(q, b, lq, lk, segment_ids, kv_segment_ids)
    return _flash_backward(q, k, v, o, lse, do, q_seg, kv_seg, causal, scale)


def _flash_backward(q, k, v, o, lse, do, q_seg, kv_seg, causal, scale):
    """Launch the backward kernel: (dq, dk, dv)."""
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    device, stream = _kernels.launch_on("flash_attention_bwd", q, k, v, o, lse, do, q_seg,
                                        kv_seg)
    dq = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, lk, hkv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, lk, hkv, d), dtype=v.dtype, device=q.device)
    lib = _kernels.library()
    # f32 scratch: delta, then the dK / dV partials of the split grid
    scratch = torch.empty(lib.rga3_flash_attention_bwd_scratch_words(b, lq, lk, h, hkv, d),
                          dtype=torch.float32, device=q.device)
    err = lib.rga3_flash_attention_bwd_bf16(
        device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if q_seg is None else q_seg.data_ptr(),
        None if kv_seg is None else kv_seg.data_ptr(),
        b, lq, lk, h, hkv, d,
        *_ptr_strides(q), *_ptr_strides(k), *_ptr_strides(v), *_ptr_strides(o),
        *_ptr_strides(do), *_ptr_strides(dq), *_ptr_strides(dk), *_ptr_strides(dv),
        int(causal), float(scale), stream,
    )
    _kernels.check(err, "flash_attention_bwd")
    key = (tuple(q.shape), q.stride(), tuple(k.shape), k.stride(), v.stride(),
           bool(causal), float(scale))
    _record(flash_attention_bwd, key,
            None if q_seg is None else (q_seg.clone(), kv_seg.clone()))
    return dq, dk, dv


def _segments(q, b, lq, lk, segment_ids, kv_segment_ids):
    """The kernels' int32 contiguous (B, Lq) / (B, Lk) segment ids, or
    (None, None)."""
    if segment_ids is None:
        return None, None
    q_seg = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
    kv = kv_segment_ids if kv_segment_ids is not None else segment_ids
    kv_seg = kv.to(device=q.device, dtype=torch.int32).contiguous()
    if q_seg.shape != (b, lq) or kv_seg.shape != (b, lk):
        raise ValueError("flash_attention: segment ids must be (B, L)")
    return q_seg, kv_seg


class _FlashAttention(torch.autograd.Function):
    """The forward kernel keeping its log-sum-exp; the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, scale):
        out, lse = _flash_forward(q, k, v, q_seg, kv_seg, causal, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, q_seg, kv_seg)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, q_seg, kv_seg = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, causal=ctx.causal,
                                         segment_ids=q_seg, kv_segment_ids=kv_seg,
                                         scale=ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention, (B, L, H, D), GQA-aware (kv head = h // (H/Hkv)).

    On a CUDA tensor it launches the hand-written kernel (bf16; at f32 the
    non-causal, unmasked f32 variant, `flash_attention_f32`), and when grad
    is on and an input requires it, keeps the log-sum-exp for the backward
    kernel (`flash_attention_bwd`); on a CPU tensor it computes
    `mha_reference`, differentiable as it is. `causal=True` needs lq == lk,
    as in the JAX package: the kernel aligns the causal mask top-left and
    the reference bottom-right, which agree only then."""
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    if causal and lq != lk:
        raise NotImplementedError(
            "flash_attention(causal=True) requires lq == lk "
            f"(got lq={lq}, lk={lk}); use mha_reference for "
            "bottom-right-aligned cached/cross attention"
        )
    if q.device.type == "cpu":
        return mha_reference(
            q, k, v, causal=causal, segment_ids=segment_ids,
            kv_segment_ids=kv_segment_ids, scale=scale,
        )
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for {q.device}")
    if q.dtype == torch.float32:
        if causal or segment_ids is not None or kv_segment_ids is not None:
            raise ValueError("flash_attention: the f32 kernel takes no mask (causal=False, "
                             "no segment ids)")
        return flash_attention_f32(q, k, v, scale=scale)
    _check_cuda_inputs("flash_attention", q, k, v)
    if h % hkv != 0 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError("flash_attention: mismatched q/k/v shapes")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q_seg, kv_seg = _segments(q, b, lq, lk, segment_ids, kv_segment_ids)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if d not in BWD_HEAD_DIMS:
            raise ValueError(f"flash_attention: no backward kernel at head dim {d} "
                             f"(it takes {BWD_HEAD_DIMS}); call it under torch.no_grad()")
        return _FlashAttention.apply(q, k, v, q_seg, kv_seg, bool(causal), float(scale))
    return _flash_forward(q, k, v, q_seg, kv_seg, causal, scale, with_lse=False)[0]


def flash_attention_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Non-causal attention over (B, L, H, D) in f32, without masks: the
    f32 variant of `flash_attention` (Hiera's global blocks and the SAM2
    decoder under f32 parameters). On a CUDA tensor it launches the f32
    attention of `csrc/f32_ops.cu` (f32, 8-byte aligned rows, head dims
    F32_HEAD_DIMS; k and v with q's heads: a tensor-core tile whose
    products run in 3xTF32, f32's accuracy whatever the TF32 flags say),
    differentiable through `mha_reference`; on a CPU tensor it computes
    `mha_reference`."""
    b, lq, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return mha_reference(q, k, v, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_f32: no kernel for {q.device}")
    _check_f32_inputs("flash_attention_f32", q, k, v)
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:]:
        raise ValueError("flash_attention_f32: mismatched q/k/v shapes (no GQA at f32)")
    lk = k.shape[1]

    def kernel(q_, k_, v_):
        out = _attention_f32(q_, k_, v_, lk, lq, scale)
        _record(flash_attention_f32, (tuple(q_.shape), q_.stride(), tuple(k_.shape),
                                      k_.stride(), v_.stride(), False, float(scale)))
        return out

    return recompute_backward(kernel, lambda q_, k_, v_: mha_reference(q_, k_, v_, scale=scale),
                              q, k, v)


def _window_forward(q, k, v, window, qw, scale):
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    b, _, h, d = q.shape
    lk = k.shape[1]
    device, stream = _kernels.launch_on("window_attention", q, k, v)
    lib = _kernels.library()
    err = lib.rga3_window_attention_bf16(
        device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, lk, h, d, window, qw,
        *_ptr_strides(q), *_ptr_strides(k), *_ptr_strides(v),
        *_ptr_strides(out), float(scale), stream,
    )
    _kernels.check(err, "window_attention")
    key = (tuple(q.shape), q.stride(), k.stride(), v.stride(), int(window), float(scale),
           tuple(k.shape), int(qw))
    _record(window_attention, key)
    return out


def window_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    window: int,
    *,
    q_window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Block-diagonal windowed attention over (B, L, H, D) with tokens laid
    out window-major (every consecutive `window` tokens form one window).
    With `q_window` (the q-pool transition block's 2x2-pooled queries,
    `window / 4`), q is (B, L / window * q_window, H, D) and its w-th group
    of `q_window` rows attends to the w-th window of keys.

    On a CUDA tensor it launches the hand-written kernel (bf16; the window
    a multiple of 16 or 1, 2, 4 or 8 tokens, the query window dividing 64
    or a multiple of 64; at f32 the f32 variant, `window_attention_f32`),
    differentiable through `window_reference`; on a CPU tensor it computes
    `window_reference`."""
    qw = window if q_window is None else q_window
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if lk % window != 0 or lq != lk // window * qw:
        raise ValueError(
            f"window_attention: Lk={lk} in windows of {window} does not give "
            f"Lq={lq} in windows of {qw}")
    if q.device.type == "cpu":
        return window_reference(q, k, v, window, scale, q_window=qw)
    if q.device.type != "cuda":
        raise RuntimeError(f"window_attention: no kernel for {q.device}")
    if q.dtype == torch.float32:
        return window_attention_f32(q, k, v, window, q_window=qw, scale=scale)
    _check_cuda_inputs("window_attention", q, k, v)
    if (k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:]
            or qw not in (window, window // 4)):
        raise ValueError("window_attention: mismatched q/k/v shapes")
    if (16 % window if window < 16 else window % 16) or (64 % qw if qw < 64 else qw % 64):
        raise ValueError(f"window_attention: unsupported window {window}/{qw}")
    return recompute_backward(
        lambda q_, k_, v_: _window_forward(q_, k_, v_, window, qw, scale),
        lambda q_, k_, v_: window_reference(q_, k_, v_, window, scale, q_window=qw),
        q, k, v)


def window_attention_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int, *,
                         q_window: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """`window_attention` in f32 (the Hiera encoder under f32 parameters):
    any window and query window. On a CUDA tensor it launches the f32
    attention of `csrc/f32_ops.cu` (f32, 8-byte aligned rows, head dims
    F32_HEAD_DIMS; the tensor-core tile of `flash_attention_f32`, in
    3xTF32), differentiable through `window_reference`; on a CPU tensor it
    computes `window_reference`."""
    qw = window if q_window is None else q_window
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if lk % window != 0 or lq != lk // window * qw:
        raise ValueError(
            f"window_attention_f32: Lk={lk} in windows of {window} does not give "
            f"Lq={lq} in windows of {qw}")
    if q.device.type == "cpu":
        return window_reference(q, k, v, window, scale, q_window=qw)
    if q.device.type != "cuda":
        raise RuntimeError(f"window_attention_f32: no kernel for {q.device}")
    _check_f32_inputs("window_attention_f32", q, k, v)
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:]:
        raise ValueError("window_attention_f32: mismatched q/k/v shapes")

    def kernel(q_, k_, v_):
        out = _attention_f32(q_, k_, v_, window, qw, scale)
        _record(window_attention_f32, (tuple(q_.shape), q_.stride(), k_.stride(), v_.stride(),
                                       int(window), float(scale), tuple(k_.shape), int(qw)))
        return out

    return recompute_backward(
        kernel, lambda q_, k_, v_: window_reference(q_, k_, v_, window, scale, q_window=qw),
        q, k, v)


register(flash_attention, flash_attention_bwd, window_attention, flash_attention_f32,
         window_attention_f32)

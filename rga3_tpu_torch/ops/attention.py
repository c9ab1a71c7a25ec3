"""Attention: hand-written CUDA kernels and their plain PyTorch versions.

Counterpart of `rga3_tpu/ops/attention.py`. Layout is (B, L, H, D) for q, k
and v at every public function, as in the JAX package.

  * `flash_attention` launches `csrc/flash_attention.cu` for a CUDA tensor
    (the port of the Pallas `_flash_kernel`) and computes `mha_reference`
    for a CPU tensor.
  * `window_attention` launches `csrc/window_attention.cu` for a CUDA tensor
    (the port of the Pallas `_local_flash_kernel`) and computes
    `window_reference` for a CPU tensor.

A wrapper never falls back: on a CUDA tensor it launches its kernel or
raises. Each wrapper counts its launches in `<wrapper>.launches`, so a run
can show that it went through the kernel, and keeps in `<wrapper>.shapes`
every distinct call it launched (shapes, strides, options) with its count
and, for flash, the first call's segment ids, so that the kernel can be
checked again at exactly the shapes a run gave it. `reset_launches()`
clears both.

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
KERNEL_HEAD_DIMS = (16, 72, 80, 128)  # the main path's: SAM decoder, Hiera, ViT, LM


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain attention. q: (B, Lq, H, D); k/v: (B, Lk, Hkv, D). f32 logits
    and softmax; the causal mask is bottom-right aligned (tril k=lk-lq)."""
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
    return out.to(q.dtype)


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


def _check_cuda_inputs(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bf16, got {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous")
        if t.device != ts[0].device:
            raise ValueError(f"{name}: inputs on different devices")
    if ts[0].shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"{name}: head dim {ts[0].shape[-1]} not in {KERNEL_HEAD_DIMS}"
        )


def _ptr_strides(t: torch.Tensor):
    return [t.stride(0), t.stride(1), t.stride(2)]


def _record(wrapper, key, extra=None) -> None:
    """Count one launch of `wrapper`'s kernel and the call it made."""
    wrapper.launches += 1
    seen = wrapper.shapes.get(key)
    if seen is None:
        wrapper.shapes[key] = [1, extra]
    else:
        seen[0] += 1


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
    saw (these two, and those of `ops.fused_block` once it is imported)."""
    for wrapper in _WRAPPERS:
        wrapper.launches = 0
        wrapper.shapes = {}


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

    On a CUDA tensor it launches the hand-written kernel (bf16 only); on a
    CPU tensor it computes `mha_reference`. `causal=True` needs lq == lk, as
    in the JAX package: the kernel aligns the causal mask top-left and the
    reference bottom-right, which agree only then."""
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
    _check_cuda_inputs("flash_attention", q, k, v)
    if h % hkv != 0 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError("flash_attention: mismatched q/k/v shapes")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q_seg = kv_seg = None
    if segment_ids is not None:
        q_seg = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
        kv = kv_segment_ids if kv_segment_ids is not None else segment_ids
        kv_seg = kv.to(device=q.device, dtype=torch.int32).contiguous()
        if q_seg.shape != (b, lq) or kv_seg.shape != (b, lk):
            raise ValueError("flash_attention: segment ids must be (B, L)")
    out = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lib = _kernels.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.rga3_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if q_seg is None else q_seg.data_ptr(),
        None if kv_seg is None else kv_seg.data_ptr(),
        b, lq, lk, h, hkv, d,
        *_ptr_strides(q), *_ptr_strides(k), *_ptr_strides(v),
        *_ptr_strides(out), int(causal), float(scale), stream,
    )
    _kernels.check(err, "flash_attention")
    key = (tuple(q.shape), q.stride(), tuple(k.shape), k.stride(), v.stride(),
           bool(causal), float(scale))
    _record(flash_attention, key, None if q_seg is None else (q_seg.clone(), kv_seg.clone()))
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
    a multiple of 16, the query window dividing 64 or a multiple of 64); on
    a CPU tensor it computes `window_reference`."""
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
    _check_cuda_inputs("window_attention", q, k, v)
    if (k.shape != v.shape or k.shape[0] != b or k.shape[2:] != q.shape[2:]
            or qw not in (window, window // 4)):
        raise ValueError("window_attention: mismatched q/k/v shapes")
    if window % 16 or (64 % qw if qw < 64 else qw % 64):
        raise ValueError(f"window_attention: unsupported window {window}/{qw}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = _kernels.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.rga3_window_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, lk, h, d, window, qw,
        *_ptr_strides(q), *_ptr_strides(k), *_ptr_strides(v),
        *_ptr_strides(out), float(scale), stream,
    )
    _kernels.check(err, "window_attention")
    key = (tuple(q.shape), q.stride(), k.stride(), v.stride(), int(window), float(scale),
           tuple(k.shape), int(qw))
    _record(window_attention, key)
    return out


register(flash_attention, window_attention)

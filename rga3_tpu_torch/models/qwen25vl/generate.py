"""KV-cached autoregressive decoding (greedy / nucleus), counterpart of
`rga3_tpu/models/qwen25vl/generate.py`'s `greedy_generate`.

One prefill of the right-padded prompt into a fresh cache with the head on
each row's last valid position, then a Python loop of one-token forwards
that stops once every row has emitted EOS (the JAX package's
`lax.while_loop` with an all-done exit). It runs where the model is. The
loop skips a forward whose tokens nothing reads: the last step's, and the
one after every row is done. `suppress_ids` are banned by -inf logits;
tokens after a row's EOS are `pad_token_id`.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence

import torch

from .language import make_kv_cache


def _sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: float, top_p: float) -> torch.Tensor:
    """(B, V) f32 logits -> (B,) ids: argmax at temperature 0, otherwise a
    draw from `generator` after temperature and nucleus (top-p) filtering.
    The draws are not the JAX package's (another generator)."""
    if temperature <= 0.0:
        return logits.argmax(-1)
    logits = logits / temperature
    if top_p < 1.0:
        sorted_logits = logits.sort(-1, descending=True).values
        cum = torch.softmax(sorted_logits, -1).cumsum(-1)
        cutoff_idx = (cum < top_p).sum(-1, keepdim=True)
        cutoff = sorted_logits.gather(-1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, -1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def greedy_generate(
    model,
    input_ids: torch.Tensor,  # (B, L) right-padded prompt
    attention_mask: torch.Tensor,  # (B, L)
    position_ids: torch.Tensor,  # (3, B, L)
    rope_deltas: torch.Tensor,  # (B,)
    max_new_tokens: int,
    eos_token_id: int,
    pad_token_id: int,
    pixel_patches: Optional[torch.Tensor] = None,
    vision_layout: Optional[Dict[str, Any]] = None,
    suppress_ids: Sequence[int] = (),
    temperature: float = 0.0,
    top_p: float = 1.0,
    generator: Optional[torch.Generator] = None,
    stats: Optional[Dict[str, float]] = None,
    return_logits: bool = False,
):
    """Returns (B, max_new_tokens) generated ids (pad after EOS), and with
    `return_logits` also the (B, steps, V) f32 logits each token was chosen
    from (after suppression). `stats`, when given, receives the prefill
    and decode seconds (host clock, each ending in a device synchronize)
    and the count of forwards."""
    dev = model.device
    b, l = input_ids.shape
    input_ids = input_ids.to(dev, torch.long)
    attention_mask = attention_mask.to(dev)
    cache = make_kv_cache(model.cfg.text, b, l + max_new_tokens, dtype=model.dtype, device=dev)
    seg = attention_mask.to(torch.int32)
    last_idx = attention_mask.sum(1).long() - 1  # the only logits the head computes
    sup = torch.as_tensor(list(suppress_ids), dtype=torch.long, device=dev)

    def mask_logits(lg: torch.Tensor) -> torch.Tensor:
        lg = lg.float()
        if sup.numel():
            lg[:, sup] = float("-inf")
        return lg

    t0 = time.perf_counter()
    if pixel_patches is not None:
        pixel_patches = torch.as_tensor(pixel_patches, device=dev)
    out = model(input_ids, position_ids=torch.as_tensor(position_ids, device=dev),
                segment_ids=seg, pixel_patches=pixel_patches, vision_layout=vision_layout,
                cache=cache, logits_indices=last_idx)
    lg = mask_logits(out["logits"][:, 0])
    tok = _sample_token(lg, generator, temperature, top_p)
    _sync(dev)
    t1 = time.perf_counter()
    forwards = 1
    steps = [lg] if return_logits else []
    # decode positions: prompt length + rope delta + step, on all 3 streams
    next_pos = attention_mask.sum(1).long() + torch.as_tensor(rope_deltas, device=dev).long()
    buf = torch.full((b, max_new_tokens), pad_token_id, dtype=torch.long, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for i in range(max_new_tokens):
        buf[:, i] = torch.where(done, torch.full_like(tok, pad_token_id), tok)
        done = done | (tok == eos_token_id)
        if i == max_new_tokens - 1 or bool(done.all()):
            break
        pos = (next_pos + i)[None, :, None].expand(3, b, 1)
        out = model(tok[:, None], position_ids=pos, cache=cache)
        forwards += 1
        lg = mask_logits(out["logits"][:, -1])
        if return_logits:
            steps.append(lg)
        nxt = _sample_token(lg, generator, temperature, top_p)
        tok = torch.where(done, torch.full_like(nxt, pad_token_id), nxt)
    _sync(dev)
    if stats is not None:
        stats.update(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1,
                     forwards=forwards)
    if return_logits:
        return buf, torch.stack(steps, 1)
    return buf

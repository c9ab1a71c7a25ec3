"""KV-cached autoregressive decoding (greedy / nucleus) and speculative
greedy decoding, counterparts of `rga3_tpu/models/qwen25vl/generate.py`'s
`greedy_generate` and `speculative_greedy_generate`.

One prefill of the right-padded prompt into a fresh cache with the head on
each row's last valid position, then a Python loop of one-token forwards
that stops once every row has emitted EOS (the JAX package's
`lax.while_loop` with an all-done exit). It runs where the model is. The
loop skips a forward whose tokens nothing reads: the last step's, and the
one after every row is done. `suppress_ids` are banned by -inf logits;
tokens after a row's EOS are `pad_token_id`.

Over the mesh's tensor axis the head gives each rank its vocabulary columns:
greedy picks take `parallel.tensor.sharded_argmax` (the first index of the
maximum, as on one rank), sampling and `return_logits` gather the whole
logits first (every rank draws with its own generator seeded alike), and
the suppressed ids are banned in the columns that hold them. The output is
then the same on every rank, and the same as one rank's.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ...parallel.tensor import full_logits, sharded_argmax
from .language import make_kv_cache


class _Vocab:
    """The vocabulary columns a model's head gives this rank: suppression
    in them, the greedy pick and sampling over the whole vocabulary."""

    def __init__(self, model, suppress_ids: Sequence[int], device):
        self.lm = getattr(model, "lm", model)
        vr = getattr(self.lm, "vocab_range", None)
        self.start = 0 if vr is None else vr[0]
        self.sharded = vr is not None
        sup = [i - self.start for i in suppress_ids
               if vr is None or vr[0] <= i < vr[1]]
        self.sup = torch.as_tensor(sup, dtype=torch.long, device=device)

    def mask(self, lg: torch.Tensor) -> torch.Tensor:
        lg = lg.float()
        if self.sup.numel():
            lg[..., self.sup] = float("-inf")
        return lg

    def whole(self, lg: torch.Tensor) -> torch.Tensor:
        return full_logits(lg, self.lm)

    def greedy(self, lg: torch.Tensor) -> torch.Tensor:
        if self.sharded:
            return sharded_argmax(lg, self.start, self.lm.tp.group)
        return lg.argmax(-1)

    def pick(self, lg, generator, temperature: float, top_p: float) -> torch.Tensor:
        if temperature <= 0.0:
            return self.greedy(lg)
        return _sample_token(self.whole(lg), generator, temperature, top_p)


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
    vocab = _Vocab(model, suppress_ids, dev)
    cache = make_kv_cache(model.cfg.text, b, l + max_new_tokens, dtype=model.dtype, device=dev,
                          kv_heads=vocab.lm.kv_heads)
    seg = attention_mask.to(torch.int32)
    last_idx = attention_mask.sum(1).long() - 1  # the only logits the head computes
    mask_logits = vocab.mask

    t0 = time.perf_counter()
    if pixel_patches is not None:
        pixel_patches = torch.as_tensor(pixel_patches, device=dev)
    out = model(input_ids, position_ids=torch.as_tensor(position_ids, device=dev),
                segment_ids=seg, pixel_patches=pixel_patches, vision_layout=vision_layout,
                cache=cache, logits_indices=last_idx)
    lg = mask_logits(out["logits"][:, 0])
    tok = vocab.pick(lg, generator, temperature, top_p)
    _sync(dev)
    t1 = time.perf_counter()
    forwards = 1
    steps = [vocab.whole(lg)] if return_logits else []
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
            steps.append(vocab.whole(lg))
        nxt = vocab.pick(lg, generator, temperature, top_p)
        tok = torch.where(done, torch.full_like(nxt, pad_token_id), nxt)
    _sync(dev)
    if stats is not None:
        stats.update(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1,
                     forwards=forwards)
    if return_logits:
        return buf, torch.stack(steps, 1)
    return buf


@torch.no_grad()
def speculative_greedy_generate(
    model,
    draft_model,
    input_ids: torch.Tensor,  # (1, L) right-padded prompt
    attention_mask: torch.Tensor,  # (1, L)
    position_ids: torch.Tensor,  # (3, 1, L)
    rope_deltas: torch.Tensor,  # (1,)
    max_new_tokens: int,
    eos_token_id: int,
    pad_token_id: int,
    k: int = 4,
    pixel_patches: Optional[torch.Tensor] = None,
    vision_layout: Optional[Dict[str, Any]] = None,
    draft_pixel_patches: Optional[torch.Tensor] = None,
    draft_vision_layout: Optional[Dict[str, Any]] = None,
    suppress_ids: Sequence[int] = (),
    stats: Optional[Dict[str, float]] = None,
) -> Tuple[torch.Tensor, Dict[str, int]]:
    """Draft-and-verify greedy decoding, token for token the target's
    greedy decode for any draft. Batch 1: rows would accept different
    counts, and the cache index is one for the batch.

    Both models prefill the prompt into caches of `L + max_new_tokens + k
    + 2` slots (the draft with its own vision inputs, or as text alone
    without them). Each iteration the draft runs k + 1 one-token forwards
    from the last emitted token (the last one so that its cache covers the
    prefix even when every proposal is accepted) and proposes d_1..d_k;
    the target verifies [cur, d_1..d_k] in one (k + 1)-token forward
    through the cache's masked attention, giving its greedy tokens
    g_0..g_k. d_i is accepted while it equals g_{i-1} and no EOS came
    before; the emitted tokens are g_0..g_a (a accepted), cut after a
    first EOS. Rewinding is setting both caches' `idx` to the start plus
    the emitted count: the keys beyond it are causally masked and
    overwritten later.

    The cache index is a host int, so each iteration reads the target's
    k + 1 greedy tokens and the accepted count back to the host once (the
    JAX package's loop stays on the device).

    The tokens are greedy decoding's only if the verify's row i rounds as
    a one-token forward at its position does. The port's LM makes it so up
    to k + 1 = `language.ROW_EXACT_TOKENS` (8) tokens: its int4 products
    (decode launches) and its cached attention (one query at a time) give
    each row a one-token step's arithmetic.

    Returns ((1, max_new_tokens) ids, pad after an EOS, and {"steps":
    verify forwards, "emitted": tokens emitted}). `stats`, when given,
    receives the prefill seconds (both prefills) and decode seconds (host
    clock, each ending in a device synchronize), the target's and the
    draft's forwards, steps, emitted and accepted (proposals)."""
    b, l = input_ids.shape
    if b != 1:
        raise ValueError(f"speculative decode is a latency path at batch 1, got batch {b}")
    dev = model.device
    input_ids = input_ids.to(dev, torch.long)
    attention_mask = attention_mask.to(dev)
    position_ids = torch.as_tensor(position_ids, device=dev)
    size = l + max_new_tokens + k + 2
    tvocab = _Vocab(model, suppress_ids, dev)
    dvocab = _Vocab(draft_model, suppress_ids, dev)
    tcache = make_kv_cache(model.cfg.text, 1, size, dtype=model.dtype, device=dev,
                           kv_heads=tvocab.lm.kv_heads)
    dcache = make_kv_cache(draft_model.cfg.text, 1, size, dtype=draft_model.dtype, device=dev,
                           kv_heads=dvocab.lm.kv_heads)
    seg = attention_mask.to(torch.int32)
    last_idx = attention_mask.sum(1).long() - 1

    def greedy(lg: torch.Tensor, vocab: _Vocab = tvocab) -> torch.Tensor:
        return vocab.greedy(vocab.mask(lg))

    t0 = time.perf_counter()
    if pixel_patches is not None:
        pixel_patches = torch.as_tensor(pixel_patches, device=dev)
    out = model(input_ids, position_ids=position_ids, segment_ids=seg,
                pixel_patches=pixel_patches, vision_layout=vision_layout, cache=tcache,
                logits_indices=last_idx)
    if draft_pixel_patches is not None:
        draft_pixel_patches = torch.as_tensor(draft_pixel_patches, device=dev)
    draft_model(input_ids, position_ids=position_ids, segment_ids=seg,
                pixel_patches=draft_pixel_patches, vision_layout=draft_vision_layout,
                cache=dcache, logits=False)
    cur = greedy(out["logits"][:, 0])  # (1,)
    first = int(cur[0])
    _sync(dev)
    t1 = time.perf_counter()
    # M-RoPE position of the first generated token, on all 3 streams
    next_pos = int(attention_mask.sum()) + int(torch.as_tensor(rope_deltas).reshape(-1)[0])
    toks = [first]
    steps = accepted = 0
    done = first == eos_token_id  # greedy decode emits the first token even when EOS
    offs = torch.arange(k + 1, device=dev)
    while max_new_tokens > 0 and len(toks) < max_new_tokens and not done:
        cur_pos = next_pos + len(toks) - 1  # cur's own position
        t_idx0, d_idx0 = tcache["idx"], dcache["idx"]
        tok, drafts = cur, []
        for i in range(k + 1):
            pos = torch.full((3, 1, 1), cur_pos + i, dtype=torch.long, device=dev)
            tok = greedy(draft_model(tok[:, None], position_ids=pos, cache=dcache)["logits"][:, -1],
                         dvocab)
            drafts.append(tok)
        win_ids = torch.cat([cur] + drafts[:k])[None]  # (1, k + 1)
        pos = (cur_pos + offs)[None, None].expand(3, 1, k + 1)
        g = greedy(model(win_ids, position_ids=pos, cache=tcache)["logits"][0])  # (k + 1,)
        acc = torch.cumprod(((win_ids[0, 1:] == g[:k]) & (g[:k] != eos_token_id)).long(), 0)
        host = torch.cat([g, acc.sum()[None]]).tolist()  # the iteration's one host read
        a = host[-1]
        n_emit = a + 1  # g_0..g_a: the accepted proposals and a correction or bonus
        emitted = host[:n_emit]
        if eos_token_id in emitted:
            emitted = emitted[:emitted.index(eos_token_id) + 1]
            done = True
        toks += emitted
        steps += 1
        accepted += a
        tcache["idx"] = t_idx0 + n_emit
        dcache["idx"] = d_idx0 + n_emit
        cur = g[a:a + 1]
    _sync(dev)
    n = min(len(toks), max_new_tokens)
    ids = torch.full((1, max_new_tokens), pad_token_id, dtype=torch.long, device=dev)
    if n:
        ids[0, :n] = torch.as_tensor(toks[:n], device=dev)
    if stats is not None:
        stats.update(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1,
                     forwards=1 + steps, draft_forwards=1 + steps * (k + 1), steps=steps,
                     emitted=n, accepted=accepted)
    return ids, {"steps": steps, "emitted": n}

"""The mesh's tensor axis: Megatron-style parallel layers for the Qwen LM.

Each rank of a tensor group holds the block of every named LM leaf that the
sharding rule (`parallel.sharding`) gives a tensor dimension, and computes
with it:

  * column-parallel (q / k / v, gate / up): the rank's output columns,
    whole heads; the input enters through `copy_to_tensor` (its gradient,
    partial on each rank, is summed); a bias, which the rule leaves whole,
    is sliced to the rank's columns;
  * row-parallel (o_proj, down_proj): the rank's input rows, then
    `reduce_from_tensor` sums the partial outputs; a bias is added once,
    after the sum. int4 packs input rows j and j + K/2 into one byte, so the
    rank's block of packed rows [s, e) holds rows [s, e) and [K/2 + s, K/2 +
    e): it takes those columns of the whole input (gathered) and the two
    matching runs of scale groups; W8A8 scales each token by its absmax over
    the whole K (the ranks' maxima, all-reduced);
  * vocab-parallel `embed_tokens` (ids outside the rank's rows masked,
    embedded, all-reduced) and head (the rank's vocabulary columns of the
    logits); `vocab_parallel_cross_entropy` is `ops.losses.cross_entropy_loss`
    over the gathered logits, and `sharded_argmax` the first index of the
    maximum, as `torch.argmax` gives it.

The rest of the model (the vision tower, SAM2, `text_hidden_fcs`, the mask
losses) computes whole on every rank of the tensor group, as the JAX package
replicates it.

The port computes on whole heads, so the tensor size must divide the query
heads, and the KV heads where it is at most their count, else be a
multiple of it: each rank then computes the one KV head its query heads
read (the JAX package splits by shape alone and may cut a KV head in two).
`setup` raises ValueError for a size the port cannot compute (7B: 1, 2 or 4;
3B: 1, 2, 4 or 8 in float), including int4 row blocks whose packed rows are
not a multiple of 32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from .distributed import all_gather_along, all_reduce, gather_from_tensor, reduce_from_tensor

# Attention's LoRA factors: each rank uses B's columns of its own heads, so
# the gradients of A and B are partial on each rank of the tensor group
LORA_FACTORS = ("q_proj_lora_a", "q_proj_lora_b", "v_proj_lora_a", "v_proj_lora_b")


@dataclass(frozen=True)
class TensorAxis:
    """The tensor group a module computes over: its process group, size
    and this rank's index in it."""

    group: object
    size: int
    index: int


def block(n: int, parts: int, index: int) -> slice:
    """Block `index` of `n` split into `parts` equal blocks."""
    per = n // parts
    return slice(index * per, (index + 1) * per)


def vocab_parallel_embedding(embed: nn.Embedding, ids: torch.Tensor, start: int,
                             group) -> torch.Tensor:
    """`embed` holding rows [start, start + rows) of the table: the ids in
    them are embedded, the others give zeros, and the ranks' results are
    summed."""
    n = embed.weight.shape[0]
    local = ids - start
    outside = (local < 0) | (local >= n)
    out = embed(torch.where(outside, torch.zeros_like(local), local))
    out = out.masked_fill(outside[..., None], 0)
    return reduce_from_tensor(out, group)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, start: int,
                                 group, ignore_index: int = -100, total=None):
    """`ops.losses.cross_entropy_loss` of the logits whose vocabulary
    columns [start, start + V_rank) this rank holds (B, L, V_rank): the
    row max and the sum of exponentials all-reduced over `group`, the
    label's logit from the rank that holds it. Every rank returns the same
    loss; the gradient reaches each rank's columns."""
    from ..ops.losses import label_count

    shift = logits[:, :-1].float()
    lab = labels[:, 1:]
    valid = (lab != ignore_index).float()
    n = shift.shape[-1]
    m = all_reduce(shift.detach().amax(-1).contiguous(), group, op="max")
    sumexp = reduce_from_tensor(torch.exp(shift - m[..., None]).sum(-1), group)
    logz = m + torch.log(sumexp)
    local = lab.long() - start
    mine = (local >= 0) & (local < n) & (lab != ignore_index)
    picked = torch.gather(shift, -1, torch.where(mine, local, 0)[..., None])[..., 0]
    gold = reduce_from_tensor(torch.where(mine, picked, torch.zeros_like(picked)), group)
    count = label_count(labels, ignore_index) if total is None else total
    return ((logz - gold) * valid).sum() / count.clamp_min(1.0)


def sharded_argmax(logits: torch.Tensor, start: int, group) -> torch.Tensor:
    """The global argmax (..., V_rank) -> (...) of logits whose vocabulary
    columns start at `start` on this rank: the first index of the maximum
    on ties, as `torch.argmax` over the gathered logits gives it."""
    val, idx = logits.max(-1)
    pair = torch.stack([val.double(), (idx + start).double()], -1)[None].contiguous()
    every = all_gather_along(pair, 0, group)  # (ranks, ..., 2), in vocabulary order
    vals = every[..., 0]
    first = (vals == vals.amax(0, keepdim=True)).double().argmax(0, keepdim=True)
    return every[..., 1].gather(0, first)[0].long()


def full_logits(logits: torch.Tensor, lm) -> torch.Tensor:
    """The whole vocabulary of `lm`'s head output (gathered over its tensor
    group when it is vocab-parallel)."""
    tp = getattr(lm, "tp", None)
    if tp is None or getattr(lm, "vocab_range", None) is None:
        return logits
    return gather_from_tensor(logits.contiguous(), tp.group)


def _kv_layout(h: int, hkv: int, t: int) -> Tuple[int, int]:
    """(KV heads a rank computes, ranks that share one KV head)."""
    if h % t:
        raise ValueError(f"tensor size {t} does not divide the {h} query heads: the port "
                         "computes on whole heads")
    if t <= hkv:
        if hkv % t:
            raise ValueError(f"tensor size {t} does not divide the {hkv} KV heads")
        return hkv // t, 1
    if t % hkv:
        raise ValueError(f"tensor size {t} is neither a divisor nor a multiple of the "
                         f"{hkv} KV heads")
    return 1, t // hkv


def _check_int4_rows(name: str, lin: nn.Module, t: int) -> None:
    half = lin.kernel_q4.shape[0]
    if (2 * half) % 64 or half % t or (half // t) % 32:
        raise ValueError(
            f"{name}: int4 packed rows {half} over tensor {t} give {half / t:g} a rank, not a "
            "multiple of 32: the row-parallel block would split a scale group")


def setup(model: nn.Module, axis: TensorAxis,
          rule: Dict[str, Tuple[Optional[int], Optional[int]]]) -> Dict[str, Tuple[int, int]]:
    """Make every Qwen LM of `model` compute over `axis` (in place: each
    projection, embedding and head learns its part) and return
    {state name: (parts, index)}: the block along the rule's tensor
    dimension that this rank stores (the KV projections' blocks are whole
    KV heads). Raises ValueError for a tensor size the port cannot compute
    or a named leaf the rule leaves whole."""
    from ..models.qwen25vl.language import Attention, MLP, QuantLinear, QwenForCausalLM

    t, i = axis.size, axis.index
    blocks: Dict[str, Tuple[int, int]] = {}

    def need(prefix: str, lin: nn.Module, names=None, parts=t, index=i):
        keys = names or [n for n in ("weight", "kernel_q", "kernel_q4", "scale", "scale_g")
                         if hasattr(lin, n) and isinstance(getattr(lin, n), torch.Tensor)]
        for leaf in keys:
            key = f"{prefix}.{leaf}"
            tdim = rule[key][0]
            # an int4 row-parallel scale_g and an int8 one's scale stay whole
            if tdim is None and leaf in ("scale", "scale_g") and lin.tp_mode == "row":
                continue
            if tdim is None:
                raise ValueError(f"{key}: the tensor size {t} does not divide its named "
                                 "dimension, which the port computes split")
            blocks[key] = (parts, index)

    for path, mod in model.named_modules():
        pre = f"{path}." if path else ""
        if isinstance(mod, Attention):
            cfg = mod.cfg
            h, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
            kv_local, share = _kv_layout(h, hkv, t)
            mod.tp = axis
            mod.local_heads = (h // t, kv_local)
            mod.q_cols = block(h * hd, t, i)
            kv_parts, kv_index = (t, i) if share == 1 else (hkv, i // share)
            mod.kv_cols = block(hkv * hd, kv_parts, kv_index)
            for name, parts, index in (("q_proj", t, i), ("k_proj", kv_parts, kv_index),
                                       ("v_proj", kv_parts, kv_index), ("o_proj", t, i)):
                lin = getattr(mod, name)
                lin.tp, lin.tp_mode = axis, "row" if name == "o_proj" else "column"
                if isinstance(lin, QuantLinear) and lin.bits == 4 and name == "o_proj":
                    _check_int4_rows(pre + name, lin, t)
                need(pre + name, lin, parts=parts, index=index)
        elif isinstance(mod, MLP):
            mod.tp = axis
            for name in ("gate_proj", "up_proj", "down_proj"):
                lin = getattr(mod, name)
                lin.tp, lin.tp_mode = axis, "row" if name == "down_proj" else "column"
                if isinstance(lin, QuantLinear) and lin.bits == 4 and name == "down_proj":
                    _check_int4_rows(pre + name, lin, t)
                need(pre + name, lin)
        elif isinstance(mod, QwenForCausalLM):
            v = mod.cfg.vocab_size
            if v % t:
                raise ValueError(f"tensor size {t} does not divide the vocabulary {v}")
            mod.tp = axis
            mod.vocab_range = (block(v, t, i).start, block(v, t, i).stop)
            need(pre + "embed_tokens", mod.embed_tokens, names=["weight"])
            if not mod.cfg.tie_word_embeddings:
                mod.lm_head.tp, mod.lm_head.tp_mode = axis, "column"
                need(pre + "lm_head", mod.lm_head)
    return blocks


def partial_gradients(model: nn.Module) -> set:
    """Names of the trainable tensors whose gradient each rank of the tensor
    group holds only in part (the LoRA factors of tensor-parallel
    attention): summed over the group before the update."""
    from ..models.qwen25vl.language import Attention

    out = set()
    for path, mod in model.named_modules():
        if isinstance(mod, Attention) and getattr(mod, "tp", None) is not None:
            out.update(f"{path}.{n}" if path else n for n in LORA_FACTORS if hasattr(mod, n))
    return out

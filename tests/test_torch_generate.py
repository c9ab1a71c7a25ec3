"""The port's KV-cached `greedy_generate` against the JAX package's, tiny
config in f32 on the CPU, one seeded parameter tree (quantized by the JAX
package's own `quantize_qwen_params` / `quantize_for_serving` where the
mode asks) loaded into both.

Each mode must give the JAX package's tokens exactly, and at every step the
logits the token was chosen from within 1e-4 of the step's max|logit|
(f32 sums of two layers in another order; the JAX per-step logits come from
its own prefill and one-token cached forwards, the path of its decode loop).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rga3_tpu.models.qwen25vl import generate as jgen
from rga3_tpu.models.qwen25vl import tiny_config as jax_tiny_config
from rga3_tpu.models.qwen25vl.language import make_kv_cache as jax_make_kv_cache
from rga3_tpu.models.qwen25vl.model import Qwen25VL as JaxQwen
from rga3_tpu.models.qwen25vl.vision import (
    compute_vision_layout as jax_layout, layout_device_args as jax_layout_args,
)
from rga3_tpu.ops import quant as jq
from rga3_tpu_torch.convert import torch_state_dict_from_flax
from rga3_tpu_torch.models.qwen25vl import generate as tgen
from rga3_tpu_torch.models.qwen25vl import tiny_config
from rga3_tpu_torch.models.qwen25vl.model import Qwen25VL
from rga3_tpu_torch.models.qwen25vl.positions import get_rope_index
from rga3_tpu_torch.models.qwen25vl.vision import compute_vision_layout, layout_device_args

EOS, PAD = 151645, 151643
NEW = 5
GRID = (1, 8, 8)  # 64 patches: the vision tower's W8A8 threshold is 32 tokens
PROMPT = 64  # prompts right-padded to 64, like UniGRChat.answer

# mode: (text flags, vision flags, JAX tree transform, video, row lengths, suppress)
MODES = {
    "float": ({}, {}, None, False, (23,), ()),
    "quant_int8": ({"quant_int8": True}, {}, "lm8", False, (23,), ()),
    "quant_int4": ({"quant_int4": True}, {"quant_int8": True}, "int4", True, (30,), ()),
    "kv_cache_int8": ({"kv_cache_int8": True}, {}, None, False, (23,), ()),
    # text only: W8A8 rounds activations to 8 bits, so the vision tower's
    # f32 differences (~1e-6) would flip roundings in the LM; the same
    # activations reach both packages here, and the tower's W8A8 is held to
    # the JAX package's in test_torch_quant.py
    "int8_w8a8": ({"quant_int8": True, "quant_w8a8": True},
                  {"quant_int8": True, "quant_w8a8": True}, "int8", False, (40,), ()),
    "video": ({}, {}, None, True, (30,), ()),
    "batch2": ({}, {}, None, False, (40, 27), ()),
    "suppress": ({}, {}, None, False, (23,), "first"),
}


@pytest.fixture(scope="module")
def float_tree():
    jcfg = jax_tiny_config(vocab_size=152_000)
    la = jax_layout_args(jax_layout([GRID], jcfg.vision), jcfg.vision)
    from torch_port_support import jax_param_tree

    return jax_param_tree(JaxQwen(jcfg), jnp.zeros((1, 12), jnp.int32),
                          pixel_patches=jnp.zeros((64, 3 * 2 * 14 * 14)),
                          vision_layout=la, seed=6)


def _prompt(cfg, lengths, video, seed):
    """Right-padded ids, mask, M-RoPE positions, deltas and uint8 patches."""
    rng = np.random.default_rng(seed)
    n_vis = GRID[0] * GRID[1] * GRID[2] // 4
    ids = np.full((len(lengths), PROMPT), PAD, np.int64)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lengths):
        row = rng.integers(1000, 30_000, n)
        if video:
            row[5] = cfg.vision_start_token_id
            row[6:6 + n_vis] = cfg.video_token_id
        ids[i, :n], mask[i, :n] = row, 1
    grids = [GRID] if video else None
    pos, deltas = get_rope_index(cfg, ids, video_grid_thw=grids,
                                 second_per_grid_ts=[1.0] if video else None,
                                 attention_mask=mask)
    patches = (rng.integers(0, 256, (64, 3 * 2 * 14 * 14), dtype=np.uint8)
               if video else None)
    return ids, mask, pos, deltas, patches


def _jax_step_logits(jm, params, ids, mask, pos, deltas, patches, layout, sup):
    """The JAX package's per-step logits: its prefill into a fresh cache, then
    one-token cached forwards fed the greedy tokens (pad once a row is done)."""
    b, l = ids.shape
    cache = jax_make_kv_cache(jm.cfg.text, b, l + NEW, dtype=jnp.float32)
    prefill = jgen._prefill_fn(jm, jnp.float32, patches is not None)
    out = prefill(params, jnp.asarray(ids, jnp.int32), jnp.asarray(pos),
                  jnp.asarray(mask, jnp.int32), cache,
                  None if patches is None else jnp.asarray(patches), layout,
                  jnp.asarray(mask.sum(1) - 1, jnp.int32))
    step = jax.jit(lambda p, t, ps, c: jm.apply(
        p, input_ids=t, position_ids=ps, cache=c, compute_dtype=jnp.float32))

    def masked(lg):
        lg = np.array(lg, np.float32)
        lg[:, list(sup)] = -np.inf
        return lg

    cache, lg = out["cache"], masked(out["logits"][:, 0])
    steps, tok = [lg], lg.argmax(-1)
    done = np.zeros(b, bool)
    next_pos = mask.sum(1) + deltas
    for i in range(NEW - 1):
        done |= tok == EOS
        ps = np.broadcast_to((next_pos + i)[None, :, None], (3, b, 1)).astype(np.int32)
        out = step(params, jnp.asarray(tok[:, None], jnp.int32), jnp.asarray(ps), cache)
        cache, lg = out["cache"], masked(out["logits"][:, -1])
        steps.append(lg)
        tok = np.where(done, PAD, lg.argmax(-1))
    return np.stack(steps, 1)


@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_generate_matches_jax(float_tree, mode):
    text, vision, transform, video, lengths, sup = MODES[mode]
    jcfg = jax_tiny_config(vocab_size=152_000)
    jcfg = jcfg.replace(text=jcfg.text.replace(**text), vision=jcfg.vision.replace(**vision))
    cfg = tiny_config(vocab_size=152_000)
    cfg = cfg.replace(text=cfg.text.replace(**text), vision=cfg.vision.replace(**vision))
    params = float_tree
    if transform == "lm8":
        params = jq.quantize_qwen_params(params)
    elif transform is not None:
        params = jq.quantize_for_serving(params, transform)
    jm = JaxQwen(jcfg)
    tm = Qwen25VL(cfg, device="cpu")
    tm.load_state_dict(torch_state_dict_from_flax(params), strict=True)

    ids, mask, pos, deltas, patches = _prompt(cfg, lengths, video, seed=len(mode))
    jl = jax_layout_args(jax_layout([GRID], jcfg.vision), jcfg.vision) if video else None
    tl = layout_device_args(compute_vision_layout([GRID], cfg.vision), cfg.vision) if video else None
    tkw = dict(pixel_patches=None if patches is None else torch.from_numpy(patches),
               vision_layout=tl)
    targs = (tm, torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(pos),
             torch.from_numpy(deltas), NEW, EOS, PAD)
    if sup == "first":  # ban the first two tokens the unsuppressed model picks
        sup = tuple(int(t) for t in tgen.greedy_generate(*targs, **tkw)[0, :2])
    toks, logits = tgen.greedy_generate(*targs, suppress_ids=sup, return_logits=True, **tkw)

    jtoks = jgen.greedy_generate(
        jm, params, jnp.asarray(ids, jnp.int32), jnp.asarray(mask), jnp.asarray(pos),
        jnp.asarray(deltas), max_new_tokens=NEW, eos_token_id=EOS, pad_token_id=PAD,
        pixel_patches=None if patches is None else jnp.asarray(patches),
        vision_layout=jl, suppress_ids=sup, compute_dtype=jnp.float32)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    if sup:
        assert not np.isin(toks.numpy(), sup).any()

    ref = _jax_step_logits(jm, params, ids, mask, pos, deltas,
                           patches, jl, sup)[:, :logits.shape[1]]
    got = logits.numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    for s in range(ref.shape[1]):
        f = fin[:, s]
        err = np.abs(got[:, s][f] - ref[:, s][f]).max()
        assert err <= 1e-4 * np.abs(ref[:, s][f]).max(), (mode, s, err)

"""The port's UniGRChat against the JAX package's: the same processor
settings and tokenizer, one seeded parameter tree, f32 on the CPU, 56x56
frames (no resize, so both towers see the same pixels). Answers must be
the same strings; the port's batched answers must equal its sequential
ones; and its KV-cached decode must equal a forward without a cache over
the prompt and the generated tokens (logits within 1e-4 of each step's
max|logit|: the same f32 sums in another order).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rga3_tpu.data.processor import QwenVLProcessor as JaxProcessor
from rga3_tpu.evaluation.segmentor import UniGRChat as JaxChat
from rga3_tpu.models.qwen25vl import tiny_config as jax_tiny_config
from rga3_tpu.models.qwen25vl.model import Qwen25VL as JaxQwen
from rga3_tpu.models.qwen25vl.vision import (
    compute_vision_layout as jax_layout, layout_device_args as jax_layout_args,
)
from rga3_tpu_torch.convert import torch_state_dict_from_flax
from rga3_tpu_torch.data.processor import QwenVLProcessor
from rga3_tpu_torch.evaluation.segmentor import UniGRChat
from rga3_tpu_torch.models.qwen25vl import generate as tgen
from rga3_tpu_torch.models.qwen25vl import tiny_config
from rga3_tpu_torch.models.qwen25vl.model import Qwen25VL

from tests.test_data_pipeline import DummyTokenizer
from torch_port_support import jax_param_tree

KW = dict(min_pixels=4 * 28 * 28, max_pixels=16 * 28 * 28, video_max_pixels=16 * 28 * 28)


class DecodingTokenizer(DummyTokenizer):
    def decode(self, ids):
        return " ".join(f"tok{i}" for i in ids)


def _frames(seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (56, 56, 3), dtype=np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def chats():
    jcfg = jax_tiny_config(vocab_size=152_000)
    la = jax_layout_args(jax_layout([(1, 4, 4)], jcfg.vision), jcfg.vision)
    params = jax_param_tree(JaxQwen(jcfg), jnp.zeros((1, 12), jnp.int32),
                            pixel_patches=jnp.zeros((16, 3 * 2 * 14 * 14)),
                            vision_layout=la, seed=8)
    tm = Qwen25VL(tiny_config(vocab_size=152_000), device="cpu")
    tm.load_state_dict(torch_state_dict_from_flax(params), strict=True)
    tok = DecodingTokenizer()
    jchat = JaxChat(JaxQwen(jcfg), params, JaxProcessor(tok, **KW), max_new_tokens=4,
                    compute_dtype=jnp.float32)
    return jchat, UniGRChat(tm, QwenVLProcessor(tok, **KW), max_new_tokens=4)


def test_answer_matches_jax(chats):
    jchat, tchat = chats
    frames = _frames(0)
    for kw in (dict(video_frames=frames), dict(images=frames[:1]), {}):
        ours = tchat.answer("What is shown?", **kw)
        assert ours == jchat.answer("What is shown?", **kw)
        assert len(ours.split()) == 4
    assert tchat.last_stats["forwards"] == 4


def test_answer_batch_matches_jax_and_sequential(chats):
    jchat, tchat = chats
    frames, frames2 = _frames(0), _frames(7)
    qs = ["What is shown?", "Describe the motion in detail please."]
    seq = [tchat.answer(qs[0], video_frames=frames), tchat.answer(qs[1], video_frames=frames2)]
    batch = tchat.answer_batch(qs, video_frames_list=[frames, frames2])
    assert batch == seq
    assert batch == jchat.answer_batch(qs, video_frames_list=[frames, frames2])


def test_suppress_ids_and_unigr_composite(chats):
    from rga3_tpu_torch.config import SegHeadConfig
    from rga3_tpu_torch.models.sam2.config import tiny_sam2_config, unfused
    from rga3_tpu_torch.models.unigr import UniGR, UniGRConfig

    jchat, tchat = chats
    frames = _frames(1)
    base = tchat.answer("What is shown?", video_frames=frames)
    first = int(base.split()[0].replace("tok", ""))
    ours = tchat.answer("What is shown?", video_frames=frames, suppress_ids=[first])
    assert f"tok{first}" not in ours.split()
    assert ours == jchat.answer("What is shown?", video_frames=frames, suppress_ids=[first])

    cfg = UniGRConfig(qwen=tiny_config(vocab_size=152_000), sam2=unfused(tiny_sam2_config(64)),
                      seg=SegHeadConfig(out_dim=32, seg_token_id=151665))
    composite = UniGR(cfg, device="cpu")
    composite.qwen.load_state_dict(tchat.model.state_dict())
    chat2 = UniGRChat(composite, tchat.processor, max_new_tokens=4)
    assert chat2.model is composite.qwen
    assert chat2.answer("What is shown?", video_frames=frames) == base


def test_rejects_mixed_modality_and_draft_model(chats):
    """Mixed modalities raise; a draft model, refused before speculative
    decoding was ported, is taken and answers as the chat without it."""
    _, tchat = chats
    with pytest.raises(ValueError):
        tchat.answer_batch(["q"], video_frames_list=[_frames(0)],
                           images_list=[[np.zeros((28, 28, 3), np.uint8)]])
    spec = UniGRChat(tchat.model, tchat.processor, max_new_tokens=4, draft_model=tchat.model,
                     spec_k=2)
    frames = _frames(0)
    assert spec.answer("What is shown?", video_frames=frames) == tchat.answer(
        "What is shown?", video_frames=frames)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["cache", "int8_cache"])
def test_cached_decode_matches_a_forward_without_cache(chats, kv_int8):
    """Decode step logits against one forward over prompt + tokens (the
    port alone). The int8 cache rounds K / V to 1/127 of each vector's
    absmax, so it is held to 2e-2 of max|logit| instead of 1e-4."""
    _, tchat = chats
    model = tchat.model
    if kv_int8:
        cfg = model.cfg.replace(text=model.cfg.text.replace(kv_cache_int8=True))
        model = Qwen25VL(cfg, device="cpu")
        model.load_state_dict(tchat.model.state_dict())
    rng = np.random.default_rng(3)
    b, l, new = 2, 24, 6
    ids = rng.integers(1000, 30_000, (b, l))
    mask = np.ones((b, l), np.int64)
    mask[1, 17:] = 0
    ids[1, 17:] = 151643
    pos = np.broadcast_to(np.arange(l), (3, b, l)).copy()
    deltas = np.zeros(b, np.int64)
    toks, logits = tgen.greedy_generate(
        model, torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(pos),
        torch.from_numpy(deltas), new, 151645, 151643, return_logits=True)
    n = logits.shape[1]
    assert n == new
    # the no-cache sequence: the padded prompt, then every token but the
    # last; pads are segment 0, the rest 1; decode positions prompt_len +
    # rope delta + i
    full = torch.cat([torch.from_numpy(ids), toks[:, :n - 1]], 1)
    seg = torch.cat([torch.from_numpy(mask), torch.ones(b, n - 1, dtype=torch.long)], 1)
    lens = torch.from_numpy(mask.sum(1))
    gen_pos = (lens + torch.from_numpy(deltas))[:, None] + torch.arange(n - 1)[None]
    fpos = torch.cat([torch.from_numpy(pos), gen_pos[None].expand(3, b, n - 1)], 2)
    with torch.no_grad():
        ref = model(full, position_ids=fpos, segment_ids=seg)["logits"].float()
    at = torch.cat([(lens - 1)[:, None], l + torch.arange(n - 1)[None].expand(b, -1)], 1)
    ref = ref[torch.arange(b)[:, None], at]
    tol = 2e-2 if kv_int8 else 1e-4
    for s in range(n):
        err = (logits[:, s] - ref[:, s]).abs().amax(-1)
        assert (err <= tol * ref[:, s].abs().amax(-1)).all(), (s, err)
    if not kv_int8:
        assert torch.equal(toks, ref.argmax(-1))

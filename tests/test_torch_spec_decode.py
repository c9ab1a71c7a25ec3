"""The port's speculative greedy decoding against the JAX package's
(`rga3_tpu.models.qwen25vl.generate.speculative_greedy_generate`) and
against its own greedy decode: tiny Qwen2.5-VL models in f32 on the CPU,
one seeded parameter tree per model in both packages. Tokens and
{"steps", "emitted"} must be equal in every case: a draft with other
weights and fewer layers, the self-draft (every proposal accepted), an EOS
inside a verify window, max_new_tokens 0 and 1, suppressed ids, and a
text-only draft under a video prompt. `UniGRChat` with a draft answers as
the JAX chat with the same draft and as the port without one.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rga3_tpu.data.processor import QwenVLProcessor as JaxProcessor
from rga3_tpu.evaluation.segmentor import UniGRChat as JaxChat
from rga3_tpu.models.qwen25vl import tiny_config as jax_tiny_config
from rga3_tpu.models.qwen25vl import generate as jgen
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
from rga3_tpu_torch.models.qwen25vl.positions import get_rope_index

from test_torch_chat import DecodingTokenizer, KW, _frames
from torch_port_support import jax_param_tree

VOCAB = 152_000
NO_EOS = 10_000_000  # an id no model emits


def _pair(seed, layers=2):
    """(JAX module, params, port model) of a tiny Qwen2.5-VL with
    `layers` decoder layers, from one seeded tree."""
    jcfg = jax_tiny_config(VOCAB)
    jcfg = jcfg.replace(text=jcfg.text.replace(num_hidden_layers=layers))
    la = jax_layout_args(jax_layout([(1, 4, 4)], jcfg.vision), jcfg.vision)
    params = jax_param_tree(JaxQwen(jcfg), jnp.zeros((1, 12), jnp.int32),
                            pixel_patches=jnp.zeros((16, 3 * 2 * 14 * 14)),
                            vision_layout=la, seed=seed)
    cfg = tiny_config(VOCAB)
    tm = Qwen25VL(cfg.replace(text=cfg.text.replace(num_hidden_layers=layers)), device="cpu")
    tm.load_state_dict(torch_state_dict_from_flax(params), strict=True)
    return JaxQwen(jcfg), params, tm


@pytest.fixture(scope="module")
def models():
    return {"target": _pair(11), "draft": _pair(12, layers=1)}


@pytest.fixture(scope="module")
def text_prompt():
    ids = np.random.default_rng(3).integers(0, 2000, (1, 7)).astype(np.int64)
    pos, deltas = get_rope_index(tiny_config(VOCAB), ids)
    return dict(input_ids=ids, attention_mask=np.ones((1, 7), np.int64),
                position_ids=pos, rope_deltas=deltas)


@pytest.fixture(scope="module")
def video_prompt(models):
    """A chat prompt with a 2-frame video, right-padded to 64, and its
    vision inputs, from the port's processor."""
    chat = UniGRChat(models["target"][2], QwenVLProcessor(DecodingTokenizer(), **KW))
    enc = chat.encode("What is shown?", video_frames=_frames(0))
    jvis = models["target"][0].cfg.vision
    return {**chat.prepare([enc]), "jax_vision_layout": jax_layout_args(
        jax_layout(list(enc["video_grid_thw"]), jvis), jvis)}


def _run(models, prompt, draft_name, k, max_new, eos=NO_EOS, suppress=(), draft_vision=True):
    """(JAX tokens, JAX stats, port tokens, port stats, port greedy tokens)."""
    jm, jp, tm = models["target"]
    djm, djp, dtm = models[draft_name]
    pp, la = prompt.get("pixel_patches"), prompt.get("vision_layout")
    jla = prompt.get("jax_vision_layout")
    base = {key: prompt[key] for key in
            ("input_ids", "attention_mask", "position_ids", "rope_deltas")}
    gkw = dict(max_new_tokens=max_new, eos_token_id=eos, pad_token_id=0, suppress_ids=suppress)
    jtoks, jstats = jgen.speculative_greedy_generate(
        jm, jp, djm, djp, k=k,
        **{key: jnp.asarray(np.asarray(v)) for key, v in base.items()},
        pixel_patches=None if pp is None else jnp.asarray(np.asarray(pp)),
        vision_layout=jla,
        draft_pixel_patches=None if (pp is None or not draft_vision) else jnp.asarray(
            np.asarray(pp)),
        draft_vision_layout=jla if draft_vision else None,
        compute_dtype=jnp.float32, **gkw)
    tbase = {key: torch.as_tensor(np.asarray(v)) for key, v in base.items()}
    ttoks, tstats = tgen.speculative_greedy_generate(
        tm, dtm, k=k, **tbase, pixel_patches=pp, vision_layout=la,
        draft_pixel_patches=pp if draft_vision else None,
        draft_vision_layout=la if draft_vision else None, **gkw)
    greedy = tgen.greedy_generate(tm, **tbase, pixel_patches=pp, vision_layout=la, **gkw)
    return np.asarray(jtoks), jstats, ttoks.numpy(), tstats, greedy.numpy()


def _check(out, max_new):
    jtoks, jstats, ttoks, tstats, greedy = out
    assert ttoks.shape == jtoks.shape == (1, max_new)
    np.testing.assert_array_equal(ttoks, jtoks)
    assert tstats == jstats
    np.testing.assert_array_equal(ttoks, greedy)


def test_other_draft_fewer_layers(models, text_prompt):
    out = _run(models, text_prompt, "draft", k=3, max_new=12)
    _check(out, 12)
    assert out[3]["emitted"] == 12 and 1 <= out[3]["steps"] <= 11


def test_self_draft_accepts_every_proposal(models, text_prompt):
    out = _run(models, text_prompt, "target", k=3, max_new=9)
    _check(out, 9)
    assert out[3] == {"steps": 2, "emitted": 9}  # 1 + 2 x (3 + 1) tokens
    tm = models["target"][2]
    stats = {}
    tgen.speculative_greedy_generate(
        tm, tm, k=3, max_new_tokens=9, eos_token_id=NO_EOS, pad_token_id=0, stats=stats,
        **{key: torch.as_tensor(np.asarray(v)) for key, v in text_prompt.items()})
    assert stats["accepted"] == 6 and stats["forwards"] == 3 and stats["draft_forwards"] == 9


def test_eos_inside_a_verify_window(models, text_prompt):
    """EOS is a token greedy emits at some step j >= 2 and not before: the
    self-draft proposes past it, and the window is cut after it."""
    greedy = _run(models, text_prompt, "target", k=3, max_new=9)[4][0]
    j = next(i for i in range(2, 9) if greedy[i] not in greedy[:i])
    out = _run(models, text_prompt, "target", k=3, max_new=9, eos=int(greedy[j]))
    _check(out, 9)
    assert out[3]["emitted"] == j + 1 and (out[2][0, j + 1:] == 0).all()


@pytest.mark.parametrize("max_new", [0, 1])
def test_zero_and_one_new_tokens(models, text_prompt, max_new):
    out = _run(models, text_prompt, "draft", k=2, max_new=max_new)
    _check(out, max_new)
    assert out[3] == {"steps": 0, "emitted": max_new}


def test_suppress_ids(models, text_prompt):
    first = int(_run(models, text_prompt, "draft", k=2, max_new=1)[4][0, 0])
    out = _run(models, text_prompt, "draft", k=2, max_new=6, suppress=(first,))
    _check(out, 6)
    assert first not in out[2][0]


def test_text_only_draft_under_a_video_prompt(models, video_prompt):
    out = _run(models, video_prompt, "draft", k=2, max_new=6, draft_vision=False)
    _check(out, 6)


def test_chat_with_a_draft_matches_jax_and_plain(models):
    jm, jp, tm = models["target"]
    djm, djp, dtm = models["draft"]
    tok = DecodingTokenizer()
    frames = _frames(1)
    jchat = JaxChat(jm, jp, JaxProcessor(tok, **KW), max_new_tokens=5,
                    compute_dtype=jnp.float32, draft_model=djm, draft_params=djp, spec_k=2)
    spec = UniGRChat(tm, QwenVLProcessor(tok, **KW), max_new_tokens=5, draft_model=dtm, spec_k=2)
    plain = UniGRChat(tm, QwenVLProcessor(tok, **KW), max_new_tokens=5)
    ours = spec.answer("Describe the video.", video_frames=frames)
    assert ours == jchat.answer("Describe the video.", video_frames=frames)
    assert ours == plain.answer("Describe the video.", video_frames=frames)
    assert len(ours.split()) == 5
    st = spec.last_stats
    assert st["emitted"] == 5 and st["forwards"] == 1 + st["steps"]
    assert st["draft_forwards"] == 1 + 3 * st["steps"]

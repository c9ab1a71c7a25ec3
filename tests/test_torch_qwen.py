"""The port's Qwen2.5-VL (vision tower, LM with LoRA, positions, processor)
against the JAX package's on identical arrays, tiny config, f32 on the CPU.

Tolerances: 1e-4 absolute for a module stack in f32 (4 vision blocks or 2
decoder layers summed in another order); exact for integer outputs
(position ids, token ids); for pixel values, the port resizes with torch's
antialiased bicubic where the JAX package uses PIL: at most one 8-bit level
apart on any pixel (at most 1/255 of the range), on at most 1% of them.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rga3_tpu.data import processor as jproc
from rga3_tpu.evaluation.segmentor import build_seg_messages as jax_messages
from rga3_tpu.models.qwen25vl import tiny_config as jax_tiny_config
from rga3_tpu.models.qwen25vl.model import Qwen25VL as JaxQwen
from rga3_tpu.models.qwen25vl.positions import get_rope_index as jax_rope_index
from rga3_tpu.models.qwen25vl.vision import (
    compute_vision_layout as jax_layout, layout_device_args as jax_layout_args,
)
from rga3_tpu_torch.convert import torch_state_dict_from_flax
from rga3_tpu_torch.data import processor as tproc
from rga3_tpu_torch.evaluation.segmentor import build_seg_messages
from rga3_tpu_torch.models.qwen25vl import tiny_config
from rga3_tpu_torch.models.qwen25vl.model import Qwen25VL
from rga3_tpu_torch.models.qwen25vl.positions import get_rope_index
from rga3_tpu_torch.models.qwen25vl.vision import (
    compute_vision_layout, layout_device_args,
)

from torch_port_support import jax_param_tree

ATOL = 1e-4
KW = dict(min_pixels=4 * 28 * 28, max_pixels=16 * 28 * 28,
          video_max_pixels=16 * 28 * 28)


def _frames(seed, n, h, w):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def test_processor_ids_and_pixels_match_jax():
    frames = _frames(0, 3, 50, 70)
    msgs = build_seg_messages("the red car")
    jmsgs = jax_messages("the red car")
    tenc = tproc.QwenVLProcessor.from_pretrained("dummy", **KW)(
        msgs, videos=[frames], add_generation_prompt=False)
    jenc = jproc.QwenVLProcessor.from_pretrained("dummy", **KW)(
        jmsgs, videos=[frames], add_generation_prompt=False)
    assert tenc["text"] == jenc["text"]
    np.testing.assert_array_equal(tenc["input_ids"], jenc["input_ids"])
    assert tenc["video_grid_thw"] == jenc["video_grid_thw"]
    a = tenc["pixel_values_videos"].astype(np.int32)
    b = jenc["pixel_values_videos"].astype(np.int32)
    diff = np.abs(a - b)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01


@pytest.mark.parametrize("grids", [[(2, 8, 12)], [(1, 4, 6), (3, 6, 4)]])
def test_layout_and_rope_index_match_jax(grids):
    from rga3_tpu.models.qwen25vl import tiny_config as jtc

    cfg, jcfg = tiny_config(), jtc()
    tl = layout_device_args(compute_vision_layout(grids, cfg.vision), cfg.vision)
    jl = jax_layout_args(jax_layout(grids, jcfg.vision), jcfg.vision)
    for k, v in tl.items():
        np.testing.assert_array_equal(v, np.asarray(jl[k]))
    n = sum(t * h * w // 4 for t, h, w in grids)
    ids = np.concatenate([
        np.arange(5), np.full(n, cfg.video_token_id), np.arange(7)])[None]
    spg = [1.0] * len(grids)
    tp, td = get_rope_index(cfg, ids, video_grid_thw=grids, second_per_grid_ts=spg)
    jp, jd = jax_rope_index(jcfg, ids, video_grid_thw=grids, second_per_grid_ts=spg)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(td, jd)


@pytest.fixture(scope="module")
def qwen_pair():
    jcfg = jax_tiny_config(vocab_size=152_000)
    jcfg = jcfg.replace(text=jcfg.text.replace(lora_rank=8, lora_alpha=16.0))
    jm = JaxQwen(jcfg)
    la = jax_layout_args(jax_layout([(1, 4, 4)], jcfg.vision), jcfg.vision)
    patches = jnp.zeros((16, 3 * 2 * 14 * 14))
    ids = jnp.zeros((1, 12), jnp.int32)
    params = jax_param_tree(jm, ids, pixel_patches=patches, vision_layout=la, seed=4)
    cfg = tiny_config(vocab_size=152_000)
    cfg = cfg.replace(text=cfg.text.replace(lora_rank=8, lora_alpha=16.0))
    tm = Qwen25VL(cfg, device="cpu")
    tm.load_state_dict(torch_state_dict_from_flax(params), strict=True)
    return jm, params, tm


def test_vision_tower_and_lm_match_jax(qwen_pair):
    jm, params, tm = qwen_pair
    cfg = tm.cfg
    grids = [(2, 8, 12)]
    rng = np.random.default_rng(7)
    patches = rng.integers(0, 256, (2 * 8 * 12, 3 * 2 * 14 * 14), dtype=np.uint8)
    n_vis = 2 * 8 * 12 // 4
    ids = np.concatenate([rng.integers(0, 1000, 6), np.full(n_vis, cfg.video_token_id),
                          rng.integers(0, 1000, 5)])[None].astype(np.int32)
    pos, _ = get_rope_index(cfg, ids, video_grid_thw=grids, second_per_grid_ts=[1.0])
    jl = jax_layout_args(jax_layout(grids, jm.cfg.vision), jm.cfg.vision)
    tl = layout_device_args(compute_vision_layout(grids, cfg.vision), cfg.vision)

    vis = jax.jit(lambda p, x, l_: jm.apply(
        p, x, l_, method=lambda m, x_, la_: m.encode_vision(x_, la_)))
    jvis = vis(params, jnp.asarray(patches), jl)
    fwd = jax.jit(lambda p, i, ps, x, l_: jm.apply(
        p, input_ids=i, position_ids=ps, pixel_patches=x, vision_layout=l_))
    jout = fwd(params, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(patches), jl)
    with torch.no_grad():
        tvis = tm.visual(torch.from_numpy(patches), tl)
        tout = tm(torch.from_numpy(ids).long(), position_ids=torch.from_numpy(pos),
                  pixel_patches=torch.from_numpy(patches), vision_layout=tl)
    np.testing.assert_allclose(tvis.numpy(), np.asarray(jvis), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tout["hidden_states"].numpy(),
                               np.asarray(jout["hidden_states"]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tout["logits"].numpy(), np.asarray(jout["logits"]),
                               atol=ATOL, rtol=0)

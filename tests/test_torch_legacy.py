"""The port's legacy UniGR (Qwen2.5-VL + [SEG] + SAM-v1,
`models/unigr/legacy.py`) against the JAX package's, f32 on the CPU, at the
tiny Qwen2.5-VL (LoRA r=8, nonzero B) and `tiny_sam1_config(64)`, one
seeded parameter tree in both packages:

* `train_forward`'s five losses within 1e-5 relative and every trainable
  gradient (LoRA, lm_head, embed_tokens, text_hidden_fcs) within 1e-4 of
  its tensor's max, with and without a sample that has no [SEG];
* `evaluate_step`'s low-resolution masks and logits within 1e-4;
* `UniGRSegmentor.segment_video_multi` on the legacy model (the SAM frames
  resized by PIL in the JAX package, by torch's antialiased bicubic in the
  port, within one 8-bit level): the [SEG] embeddings within 1e-4, the
  masks on >= 99.9% of the pixels;
* the weight bridge both ways (`flax_tree_from_torch` gives the tree back
  leaf for leaf), and `init_weights` draws the Qwen2.5-VL parameters as
  `UniGR.init_weights` does from the same seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rga3_tpu.config import SegHeadConfig as JaxSegHead
from rga3_tpu.data.processor import QwenVLProcessor as JaxProcessor
from rga3_tpu.evaluation.segmentor import UniGRSegmentor as JaxSegmentor
from rga3_tpu.models.qwen25vl import tiny_config as jax_tiny_config
from rga3_tpu.models.sam1 import tiny_sam1_config as jax_tiny_sam1
from rga3_tpu.models.unigr.legacy import (
    UniGRLegacy as JaxLegacy, UniGRLegacyConfig as JaxLegacyConfig,
)
from rga3_tpu.train.optimizer import trainable_mask as jax_trainable_mask
from rga3_tpu_torch.config import SegHeadConfig
from rga3_tpu_torch.convert import _flatten, flax_tree_from_torch, torch_state_dict_from_flax
from rga3_tpu_torch.data.processor import QwenVLProcessor
from rga3_tpu_torch.evaluation.segmentor import UniGRSegmentor
from rga3_tpu_torch.models.qwen25vl import tiny_config
from rga3_tpu_torch.models.sam1 import tiny_sam1_config
from rga3_tpu_torch.models.sam2.config import tiny_sam2_config
from rga3_tpu_torch.models.unigr import UniGR, UniGRConfig
from rga3_tpu_torch.models.unigr.legacy import UniGRLegacy, UniGRLegacyConfig
from rga3_tpu_torch.train.optimizer import trainable_mask

from torch_port_support import jax_param_tree

SEG_ID = 151665
KW = dict(min_pixels=4 * 28 * 28, max_pixels=16 * 28 * 28, video_max_pixels=16 * 28 * 28)
LORA = dict(lora_rank=8, lora_alpha=16.0)
B, L, T = 2, 10, 2


@pytest.fixture(scope="module")
def pair():
    jq = jax_tiny_config(152_000)
    jcfg = JaxLegacyConfig(qwen=jq.replace(text=jq.text.replace(**LORA)),
                           sam1=jax_tiny_sam1(64), seg=JaxSegHead(out_dim=32, seg_token_id=SEG_ID))
    jm = JaxLegacy(jcfg)
    params = jax_param_tree(jm, jnp.zeros((T, 64, 64, 3)), jnp.zeros((T, 1, 32)),
                            jnp.zeros((1, 8), jnp.int32), seed=7)
    q = tiny_config(152_000)
    cfg = UniGRLegacyConfig(qwen=q.replace(text=q.text.replace(**LORA)),
                            sam1=tiny_sam1_config(64),
                            seg=SegHeadConfig(out_dim=32, seg_token_id=SEG_ID))
    tm = UniGRLegacy(cfg, device="cpu")
    tm.load_state_dict(torch_state_dict_from_flax(params), strict=True)
    return jm, params, tm


def _inputs(seg_in_both=True):
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 1000, (B, L)).astype(np.int32)
    ids[0, 6] = SEG_ID
    if seg_in_both:
        ids[1, 4] = SEG_ID
    labels = ids.copy()
    labels[:, :3] = -100
    pos = np.broadcast_to(np.arange(L)[None, None], (3, B, L)).copy().astype(np.int32)
    images = rng.integers(0, 256, (B, T, 64, 64, 3), dtype=np.uint8)
    gt = (rng.random((B, T, 48, 56)) > 0.5).astype(np.float32)
    return ids, labels, pos, images, gt, np.ones((B,), np.float32)


@pytest.mark.parametrize("seg_in_both", [True, False], ids=["seg", "one_without_seg"])
def test_train_forward_losses_and_gradients_match_jax(pair, seg_in_both):
    jm, params, tm = pair
    ids, labels, pos, images, gt, valid = _inputs(seg_in_both)
    # JAX's legacy train step takes ImageNet-normalized frames; the port's
    # normalizes uint8 itself (the same f32 arithmetic)
    mean = np.array([123.675, 116.28, 103.53], np.float32)
    std = np.array([58.395, 57.12, 57.375], np.float32)
    frames = (images.astype(np.float32) - mean) / std

    def loss(p):
        out = jm.apply(p, jnp.asarray(ids), jnp.asarray(labels), jnp.asarray(pos), None,
                       jnp.asarray(frames), jnp.asarray(gt), jnp.asarray(valid),
                       compute_dtype=jnp.float32, method=JaxLegacy.train_forward)
        return out["loss"], out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    trainable_mask(tm)
    tm.zero_grad()
    tout = tm.train_forward(*(torch.from_numpy(a) for a in (ids, labels, pos)), None,
                            torch.from_numpy(images), torch.from_numpy(gt),
                            torch.from_numpy(valid))
    tout["loss"].backward()
    for k in ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss", "mask_loss"):
        np.testing.assert_allclose(float(tout[k].detach()), float(jout[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    want = torch_state_dict_from_flax(jax.tree.map(np.asarray, jgrads))
    names = [n for n, p in tm.named_parameters() if p.requires_grad]
    mask = jax_trainable_mask(params)
    assert len(names) == sum(jax.tree.leaves(mask)) > 10
    for name in names:
        p = dict(tm.named_parameters())[name]
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        w = want[name].numpy()
        np.testing.assert_allclose(g, w, atol=1e-4 * max(np.abs(w).max(), 1e-6), rtol=0,
                                   err_msg=name)
    assert dict(tm.named_parameters())["text_hidden_fcs.fc1.weight"].grad is not None
    for p in tm.parameters():
        p.requires_grad_(True)


def test_evaluate_step_matches_jax(pair):
    jm, params, tm = pair
    ids, _, pos, images, _, _ = _inputs()
    frames = images[0]
    jout = jax.jit(lambda p, i, ps, f: jm.apply(
        p, i, ps, f, compute_dtype=jnp.float32, method=JaxLegacy.evaluate_step))(
        params, jnp.asarray(ids[:1]), jnp.asarray(pos[:, :1]), jnp.asarray(frames))
    tout = tm.evaluate_step(torch.from_numpy(ids[:1]), torch.from_numpy(pos[:, :1]),
                            torch.from_numpy(frames))
    assert tout["low_res_masks"].shape == (T, 1, 16, 16) and bool(tout["has_seg"][0])
    for key in ("low_res_masks", "logits"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), atol=1e-4, rtol=0,
                                   err_msg=key)


def test_segment_video_multi_matches_jax(pair):
    jm, params, tm = pair
    jseg = JaxSegmentor(jm, params, JaxProcessor.from_pretrained("dummy", **KW),
                        num_frames_mllm=2, sam_chunk=2, compute_dtype=jnp.float32)
    tseg = UniGRSegmentor(tm, QwenVLProcessor.from_pretrained("dummy", **KW),
                          num_frames_mllm=2, sam_chunk=2)
    assert tseg.model.sam_image_size == tm.cfg.sam1.image_size
    frames = [f for f in np.random.default_rng(4).integers(0, 256, (3, 56, 84, 3),
                                                           dtype=np.uint8)]
    je, jh = jseg._seg_embedding(frames, "the moving thing")
    te, th = tseg._seg_embedding(frames, "the moving thing")
    assert jh and th
    np.testing.assert_allclose(te.numpy(), je, atol=1e-4, rtol=0)
    exprs = ["the moving thing", "a dog"]
    jmask = jseg.segment_video_multi(frames, exprs)
    tmask = tseg.segment_video_multi(frames, exprs)
    assert tmask.shape == jmask.shape == (2, 3, 56, 84) and tmask.dtype == bool
    assert (tmask == jmask).mean() >= 0.999
    assert tseg.segment_video(frames, "a dog").shape == (3, 56, 84)


def test_weight_bridge_both_ways(pair):
    _, params, tm = pair
    want = _flatten(params["params"] if "params" in params else params)
    got = _flatten(flax_tree_from_torch(tm))
    assert set(got) == set(want)
    for path, x in want.items():
        np.testing.assert_array_equal(got[path], x, err_msg="/".join(path))


def test_init_weights_draws_qwen_as_unigr():
    q = tiny_config(152_000)
    legacy = UniGRLegacy(UniGRLegacyConfig(qwen=q, sam1=tiny_sam1_config(64),
                                           seg=SegHeadConfig(out_dim=32)), device="cpu")
    unigr = UniGR(UniGRConfig(qwen=q, sam2=tiny_sam2_config(64), seg=SegHeadConfig(out_dim=32)),
                  device="cpu")
    legacy.init_weights(torch.Generator().manual_seed(3))
    unigr.init_weights(torch.Generator().manual_seed(3))
    for (name, a), (_, b) in zip(legacy.qwen.state_dict().items(),
                                 unigr.qwen.state_dict().items()):
        assert torch.equal(a, b), name
    # sharing a Qwen2.5-VL leaves it untouched and draws the rest
    shared = UniGRLegacy(legacy.cfg, device="cpu", qwen=unigr.qwen)
    before = {k: v.clone() for k, v in unigr.qwen.state_dict().items()}
    shared.init_weights(torch.Generator().manual_seed(4), qwen=False)
    assert all(torch.equal(before[k], v) for k, v in unigr.qwen.state_dict().items())
    assert shared.sam_model.image_encoder.pos_embed.abs().sum() > 0

"""The port's train step against the JAX package's, on the CPU in f32, at
the tiny UniGR config (LoRA r=8 on q_proj / v_proj, nonzero LoRA B) with one
seeded parameter tree in both packages and one collated batch (two video
samples with [SEG] answers, a padded vision token budget, uint8 SAM frames,
0/1 gt masks):

* the five `train_forward` losses within 1e-5 and every trainable gradient
  within 1e-4 of its tensor's max;
* `trainable_mask` selects the same parameters and `lr_schedule` gives the
  same learning rates;
* three steps of `build_train_step` with grad_accum_steps 1 and 2: the loss
  trace within 1e-5, the trainable parameters within a few learning rates of
  JAX's (Adam moves an element whose gradient is rounding noise by up to
  +-lr a step, whichever way the noise falls), the frozen ones bit-identical;
* `remat="full"` and `remat="dots"` give the gradients of `remat="none"`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rga3_tpu.config import SegHeadConfig as JaxSegHead, TrainConfig as JaxTrainConfig
from rga3_tpu.data import collate as jc
from rga3_tpu.data.processor import ChatMessage as JaxMessage, QwenVLProcessor as JaxProcessor
from rga3_tpu.models.qwen25vl import tiny_config as jax_tiny_config
from rga3_tpu.models.sam2 import tiny_sam2_config as jax_tiny_sam2
from rga3_tpu.models.unigr import UniGR as JaxUniGR, UniGRConfig as JaxUniGRConfig
from rga3_tpu.train import optimizer as jopt
from rga3_tpu.train.step import build_train_step as jax_build_train_step
from rga3_tpu.train.step import make_train_state as jax_make_train_state
from rga3_tpu_torch.config import SegHeadConfig, TrainConfig
from rga3_tpu_torch.convert import torch_state_dict_from_flax
from rga3_tpu_torch.models.qwen25vl import tiny_config
from rga3_tpu_torch.models.sam2.config import tiny_sam2_config
from rga3_tpu_torch.models.unigr import UniGR, UniGRConfig
from rga3_tpu_torch.train import optimizer as topt
from rga3_tpu_torch.train.step import build_train_step, make_train_state

from torch_port_support import jax_param_tree

SEG_ID = 151665
T = 2  # SAM frames per sample
KW = dict(min_pixels=4 * 28 * 28, max_pixels=16 * 28 * 28, video_max_pixels=16 * 28 * 28)
BUDGET = 128  # vision patches per micro-batch
TRAIN = dict(lr=1e-3, epochs=1, steps_per_epoch=10, warmup_ratio=0.1, grad_clip=1.0)
BATCH_KEYS = ("input_ids", "labels", "position_ids", "segment_ids", "images_sam", "gt_masks",
              "masks_valid", "pixel_patches")


def _lora(cfg):
    return cfg.replace(text=cfg.text.replace(lora_rank=8, lora_alpha=16.0))


def _samples(mod, message, seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        frames = [rng.integers(0, 256, (56, 84, 3), dtype=np.uint8) for _ in range(2)]
        out.append(mod.TrainSample(
            sample_id=str(i),
            messages=[
                message("user", [{"type": "video"},
                                 {"type": "text", "text": f"segment the moving thing {i}"}]),
                message("assistant", [{"type": "text",
                                       "text": "sure it is [SEG] ." if i % 2 else "[SEG] ."}]),
            ],
            video_frames=frames,
            sam_frames=rng.integers(0, 256, (T, 64, 64, 3), dtype=np.uint8),
            gt_masks=(rng.random((T, 48, 56)) > 0.5).astype(np.float32),
        ))
    return out


def _micro(c):
    """The train batch of one collated micro-batch (the attention mask as the
    segment ids)."""
    mb = {k: c[k] for k in ("input_ids", "labels", "position_ids", "images_sam", "gt_masks",
                            "masks_valid", "pixel_patches")}
    mb["segment_ids"] = c["attention_mask"].astype(np.int32)
    mb["vision_layout"] = c["vision_layout"]
    return mb


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxUniGRConfig(qwen=_lora(jax_tiny_config(152_000)), sam2=jax_tiny_sam2(64),
                          seg=JaxSegHead(out_dim=32, seg_token_id=SEG_ID))
    jm = JaxUniGR(jcfg)
    params = jax_param_tree(jm, jnp.zeros((T, 64, 64, 3)), jnp.zeros((T, 1, 32)),
                            jnp.zeros((1, 8), jnp.int32), seed=3)
    cfg = UniGRConfig(qwen=_lora(tiny_config(152_000)), sam2=tiny_sam2_config(64),
                      seg=SegHeadConfig(out_dim=32, seg_token_id=SEG_ID))
    jproc = JaxProcessor.from_pretrained("dummy", **KW)
    # micro-batches: both samples together, and each alone (the same text
    # length and vision budget, so that JAX can stack them)
    samples = _samples(jc, JaxMessage, 5, 2)
    full = _micro(jc.collate(samples, jproc, jcfg.qwen, vision_budget_tokens=2 * BUDGET))
    halves = [_micro(jc.collate([s], jproc, jcfg.qwen, vision_budget_tokens=BUDGET))
              for s in samples]
    sd = torch_state_dict_from_flax(params)
    return jm, params, cfg, sd, full, halves


def _port_model(cfg, sd, remat="none"):
    tm = UniGR(cfg, device="cpu", remat=remat)
    tm.load_state_dict(sd, strict=True)
    return tm


def _jax_loss(jm, p, mb):
    return jm.apply(p, *(mb[k] for k in BATCH_KEYS[:-1]),
                    pixel_patches=mb["pixel_patches"], vision_layout=mb["vision_layout"],
                    compute_dtype=jnp.float32, method=JaxUniGR.train_forward)


def _port_loss(model, mb):
    return model.train_forward(*(torch.as_tensor(mb[k]) for k in BATCH_KEYS[:-1]),
                               pixel_patches=torch.as_tensor(mb["pixel_patches"]),
                               vision_layout=mb["vision_layout"])


def _trainable_grads(model):
    """{name: grad} of the trainable parameters; None where the loss does
    not reach the parameter."""
    return {n: p.grad for n, p in model.named_parameters() if p.requires_grad}


def test_train_forward_and_gradients_match_jax(setup):
    jm, params, cfg, sd, full, _ = setup
    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        lambda p, mb: (_jax_loss(jm, p, mb)["loss"], _jax_loss(jm, p, mb)),
        has_aux=True))(params, full)
    tm = _port_model(cfg, sd)
    topt.trainable_mask(tm)
    out = _port_loss(tm, full)
    out["loss"].backward()
    assert set(out) == set(jout) == {"loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
                                     "mask_loss"}
    for k in out:
        assert abs(out[k].item() - float(jout[k])) <= 1e-5 * max(1.0, abs(float(jout[k]))), k
    assert float(jout["mask_loss"]) > 0 and float(jout["ce_loss"]) > 0
    want = torch_state_dict_from_flax(jax.tree.map(np.asarray, jgrads))
    grads = _trainable_grads(tm)
    assert any("lora_a" in n for n in grads) and "qwen.lm.lm_head.weight" in grads
    for name, g in grads.items():
        w = want[name]
        if g is None:  # not on the loss's path (the IoU head feeds an argmax)
            g = torch.zeros_like(w)
        err = (g - w).abs().max().item()
        assert err <= 1e-4 * max(w.abs().max().item(), 1e-6), (name, err)
    # the frozen SAM backbone and vision tower get no gradient
    assert not any(p.requires_grad for n, p in tm.named_parameters()
                   if "image_encoder" in n or ".visual." in n)


def test_trainable_mask_and_schedule_match_jax(setup):
    jm, params, cfg, sd, _, _ = setup
    jmask = jopt.trainable_mask({"params": params})["params"]
    flags = torch_state_dict_from_flax(jax.tree.map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32), jmask, params))
    tm = _port_model(cfg, sd)
    mask = topt.trainable_mask(tm)
    assert set(mask) == set(flags)
    for name, on in mask.items():
        assert bool(flags[name].all()) == on and bool(flags[name].any()) == on, name
        assert tm.get_parameter(name).requires_grad == on
    assert sum(mask.values()) > 0 and not all(mask.values())
    for kw in ({}, TRAIN, dict(lr=3e-4, epochs=3, steps_per_epoch=50, min_lr_ratio=0.1)):
        jsched, tsched = jopt.lr_schedule(JaxTrainConfig(**kw)), topt.lr_schedule(
            TrainConfig(**kw))
        total = TrainConfig(**kw).epochs * TrainConfig(**kw).steps_per_epoch
        for step in (0, 1, 2, 3, 7, 24, 25, total // 2, total - 1, total, total + 9):
            want = float(jsched(step))
            assert abs(tsched(step) - want) <= 1e-6 * max(want, 1e-12), (kw, step)
    assert topt.lr_schedule(TrainConfig(**TRAIN))(0) == 0.0


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_jax(setup, accum):
    jm, params, cfg, sd, full, halves = setup
    micro = [full] if accum == 1 else halves
    jcfg = JaxTrainConfig(**TRAIN, grad_accum_steps=accum)
    state, tx = jax_make_train_state(jcfg, {"params": params})
    jstep = jax_build_train_step(lambda p, mb: _jax_loss(jm, p["params"], mb), tx,
                                 grad_accum_steps=accum, donate=False)
    batch = jax.tree.map(lambda *xs: np.stack(xs), *micro)
    tm = _port_model(cfg, sd)
    tstate, opt = make_train_state(TrainConfig(**TRAIN, grad_accum_steps=accum), tm)
    tstep = build_train_step(_port_loss, opt, grad_accum_steps=accum)
    frozen = {n: p.detach().clone() for n, p in tm.named_parameters() if not p.requires_grad}
    lrs = []
    for _ in range(3):
        state, jaux = jstep(state, batch)
        tstate, taux = tstep(tstate, micro)
        lrs.append(taux["lr"])
        for k in ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss", "mask_loss"):
            want = float(jaux[k])
            assert abs(taux[k].item() - want) <= 1e-5 * max(1.0, abs(want)), (k, taux[k], want)
    assert lrs[0] == 0.0 and lrs[1] > 0
    want = torch_state_dict_from_flax(jax.tree.map(np.asarray, state.params["params"]))
    bound = 3 * sum(lrs)
    moved = 0
    for name, p in tm.named_parameters():
        if p.requires_grad:
            assert (p.detach() - want[name]).abs().max().item() <= bound, name
            # a parameter the loss does not reach (the IoU head) stays in both
            assert torch.equal(p.detach(), sd[name]) == torch.equal(want[name], sd[name]), name
            moved += int(not torch.equal(p.detach(), sd[name]))
        else:
            assert torch.equal(p.detach(), frozen[name]) and torch.equal(p.detach(), sd[name])
            assert torch.equal(want[name], sd[name]), name
    assert moved > sum(p.requires_grad for p in tm.parameters()) // 2
    assert tstate.step == 3 and opt.count == 3


def test_remat_full_gives_the_gradients_of_none(setup):
    _, _, cfg, sd, full, _ = setup
    grads = {}
    for remat in ("none", "full", "dots"):
        tm = _port_model(cfg, sd, remat=remat)
        topt.trainable_mask(tm)
        _port_loss(tm, full)["loss"].backward()
        grads[remat] = _trainable_grads(tm)
    for remat in ("full", "dots"):
        for name, g in grads["none"].items():
            if g is None:
                assert grads[remat][name] is None, (remat, name)
                continue
            tol = 1e-6 * g.abs().max().item()
            assert torch.allclose(grads[remat][name], g, rtol=0, atol=tol), (remat, name)
    with pytest.raises(ValueError):
        UniGR(cfg, device="cpu", remat="everything")

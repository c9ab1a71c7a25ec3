"""The main path's switches in the port against the JAX package's, on the
CPU in f32 at tiny widths, one seeded parameter tree in both packages:

* `QwenVisionConfig.window_resident`: the vision tower keeps its tokens in
  padded window order (with and without a padded token budget) and gives
  the JAX package's resident tower's output, and its own default route's,
  within 1e-4;
* `QwenTextConfig.scan_layers` / `QwenVisionConfig.scan_blocks`: the JAX
  package's stacked trees load into the port's per-layer modules (logits
  within 1e-4 of the scanned JAX model's) and `flax_tree_from_torch` writes
  them back leaf for leaf; the train CLI's `--model_dir dummy` draw at a
  config forced to scan equals `scripts/train.py`'s, bit for bit; a
  generator's normal stream does not depend on how a draw is chunked;
* SAM2's single-mask selection by stability (at thresholds where every
  mask, some, or none is stable) and a mask-prompted `forward_sam_heads`
  (`PromptEncoder.embed_masks`) within 1e-4;
* `RGA3_GELU_EXACT`: the fused and unfused Hiera routes follow it as the
  JAX package's do (within 1e-4 of JAX under each setting), and it changes
  the output;
* `UniGRSegmentor(device_preprocess=True)`: the device preprocessing of
  SAM frames within 2e-3 of JAX's (normalized units) at an upscale
  (480x854) and where one side shrinks (720x1280), and the segmentor's
  masks on >= 99.9% of the pixels of JAX's.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rga3_tpu.config import SegHeadConfig as JaxSegHead
from rga3_tpu.data.processor import QwenVLProcessor as JaxProcessor
from rga3_tpu.evaluation.segmentor import UniGRSegmentor as JaxSegmentor
from rga3_tpu.models.qwen25vl import tiny_config as jax_tiny_config
from rga3_tpu.models.qwen25vl.model import Qwen25VL as JaxQwen
from rga3_tpu.models.qwen25vl.vision import (
    compute_vision_layout as jax_layout, layout_device_args as jax_layout_args,
    pad_vision_inputs as jax_pad_vision_inputs,
)
from rga3_tpu.models.sam2 import tiny_sam2_config as jax_tiny_sam2
from rga3_tpu.models.sam2.model import Sam2Model as JaxSam2
from rga3_tpu.models.unigr import UniGR as JaxUniGR, UniGRConfig as JaxUniGRConfig
from rga3_tpu.ops.resize import sam_preprocess_frames_device as jax_preprocess
from rga3_tpu_torch.config import SegHeadConfig
from rga3_tpu_torch.convert import (
    _flatten, flax_tree_from_torch, load_flax_tree, torch_state_dict_from_flax,
)
from rga3_tpu_torch.data.processor import QwenVLProcessor
from rga3_tpu_torch.evaluation.segmentor import UniGRSegmentor
from rga3_tpu_torch.models.qwen25vl import tiny_config
from rga3_tpu_torch.models.qwen25vl.model import Qwen25VL
from rga3_tpu_torch.models.qwen25vl.positions import get_rope_index
from rga3_tpu_torch.models.qwen25vl.vision import (
    compute_vision_layout, layout_device_args, pad_vision_inputs,
)
from rga3_tpu_torch.models.sam2.config import tiny_sam2_config, unfused
from rga3_tpu_torch.models.sam2.model import Sam2Model
from rga3_tpu_torch.models.unigr import UniGR, UniGRConfig
from rga3_tpu_torch.ops import fused_block as tfb
from rga3_tpu_torch.ops.resize import sam_preprocess_frames_device
from rga3_tpu_torch.train import __main__ as cli

from torch_port_support import jax_param_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
SEG_ID = 151665
KW = dict(min_pixels=4 * 28 * 28, max_pixels=16 * 28 * 28, video_max_pixels=16 * 28 * 28)
GRIDS = [(2, 8, 12), (1, 6, 4)]


def _qwen_configs(**vision):
    jcfg, cfg = jax_tiny_config(152_000), tiny_config(152_000)
    return (jcfg.replace(vision=jcfg.vision.replace(**vision)),
            cfg.replace(vision=cfg.vision.replace(**vision)))


def _qwen_params(jm, seed=4):
    la = jax_layout_args(jax_layout([(1, 4, 4)], jm.cfg.vision), jm.cfg.vision)
    return jax_param_tree(jm, jnp.zeros((1, 12), jnp.int32),
                          pixel_patches=jnp.zeros((16, 3 * 2 * 14 * 14)), vision_layout=la,
                          seed=seed)


@pytest.fixture(scope="module")
def resident_pair():
    jcfg, cfg = _qwen_configs(window_resident=True)
    jm = JaxQwen(jcfg)
    params = _qwen_params(jm)
    tm = Qwen25VL(cfg, device="cpu")
    tm.load_state_dict(torch_state_dict_from_flax(params), strict=True)
    base = Qwen25VL(cfg.replace(vision=cfg.vision.replace(window_resident=False)), device="cpu")
    base.load_state_dict(tm.state_dict(), strict=True)
    return jm, params, tm, base


@pytest.mark.parametrize("budget", [None, 512], ids=["exact", "padded"])
def test_window_resident_matches_jax_and_the_default_route(resident_pair, budget):
    jm, params, tm, base = resident_pair
    n = sum(t * h * w for t, h, w in GRIDS)
    rng = np.random.default_rng(7)
    patches = rng.integers(0, 256, (n, 3 * 2 * 14 * 14), dtype=np.uint8)
    tl = compute_vision_layout(GRIDS, tm.cfg.vision)
    jl_ = jax_layout(GRIDS, jm.cfg.vision)
    if budget is None:
        tpatch, targs = patches, layout_device_args(tl, tm.cfg.vision)
        jpatch, jargs = patches, jax_layout_args(jl_, jm.cfg.vision)
    else:
        tpatch, targs = pad_vision_inputs(patches, tl, tm.cfg.vision, budget)
        jpatch, jargs = jax_pad_vision_inputs(patches, jl_, jm.cfg.vision, budget)
        jargs = {k: jnp.asarray(v) for k, v in jargs.items()}
    vis = jax.jit(lambda p, x, l_: jm.apply(
        p, x, l_, method=lambda m, x_, la_: m.encode_vision(x_, la_)))
    want = np.asarray(vis(params, jnp.asarray(jpatch), jargs))
    with torch.no_grad():
        got = tm.visual(torch.from_numpy(tpatch), targs).numpy()
        default = base.visual(torch.from_numpy(tpatch), targs).numpy()
    rows = n // 4  # the budget's pad rows never reach the LM
    np.testing.assert_allclose(got[:rows], want[:rows], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[:rows], default[:rows], atol=ATOL, rtol=0)


@pytest.mark.parametrize("flags", [dict(text=True), dict(text=True, vision=True)],
                         ids=["scan_layers", "scan_layers+scan_blocks"])
def test_scanned_trees_load_and_write_back(flags):
    jcfg, cfg = _qwen_configs(scan_blocks=flags.get("vision", False))
    jcfg = jcfg.replace(text=jcfg.text.replace(scan_layers=True, lora_rank=4, lora_alpha=8.0))
    cfg = cfg.replace(text=cfg.text.replace(scan_layers=True, lora_rank=4, lora_alpha=8.0))
    jm = JaxQwen(jcfg)
    params = _qwen_params(jm, seed=6)
    stacked = _flatten(params["params"] if "params" in params else params)
    assert any("layers_scan" in p for p in stacked)
    assert flags.get("vision", False) == any("blocks_scan" in p for p in stacked)
    tm = Qwen25VL(cfg, device="cpu")
    tm.load_state_dict(torch_state_dict_from_flax(params), strict=True)
    filled = Qwen25VL(cfg, device="cpu")
    load_flax_tree(filled, params)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, filled.state_dict()[k]), k
    back = _flatten(flax_tree_from_torch(tm))
    assert set(back) == set(stacked)
    for path, x in stacked.items():
        np.testing.assert_array_equal(back[path], x, err_msg="/".join(path))

    grids = [(2, 8, 12)]
    rng = np.random.default_rng(3)
    patches = rng.integers(0, 256, (2 * 8 * 12, 3 * 2 * 14 * 14), dtype=np.uint8)
    ids = np.concatenate([rng.integers(0, 1000, 6), np.full(48, cfg.video_token_id),
                          rng.integers(0, 1000, 5)])[None].astype(np.int32)
    pos, _ = get_rope_index(cfg, ids, video_grid_thw=grids, second_per_grid_ts=[1.0])
    jl_ = jax_layout_args(jax_layout(grids, jcfg.vision), jcfg.vision)
    jout = jax.jit(lambda p, i, ps, x, l_: jm.apply(
        p, input_ids=i, position_ids=ps, pixel_patches=x, vision_layout=l_))(
        params, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(patches), jl_)
    with torch.no_grad():
        tout = tm(torch.from_numpy(ids).long(), position_ids=torch.from_numpy(pos),
                  pixel_patches=torch.from_numpy(patches),
                  vision_layout=layout_device_args(compute_vision_layout(grids, cfg.vision),
                                                   cfg.vision))
    np.testing.assert_allclose(tout["logits"].numpy(), np.asarray(jout["logits"]),
                               atol=ATOL, rtol=0)


def test_normal_stream_does_not_depend_on_the_chunking():
    whole = np.random.default_rng(11).normal(0, 0.02, (5, 33, 17))
    rng = np.random.default_rng(11)
    by_layer = np.stack([rng.normal(0, 0.02, (33, 17)) for _ in range(5)])
    np.testing.assert_array_equal(whole, by_layer)


def test_scanned_dummy_draw_matches_the_jax_script():
    """`assemble_params` on a tiny UniGR whose LM scans (as the CLI's 3B /
    7B) against `scripts/train.py`'s draw of the same scanned JAX model."""
    spec = importlib.util.spec_from_file_location("jax_train_script",
                                                  os.path.join(ROOT, "scripts", "train.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    lora = dict(lora_rank=8, lora_alpha=16.0, scan_layers=True)
    jq = jax_tiny_config()
    jcfg = JaxUniGRConfig(qwen=jq.replace(text=jq.text.replace(**lora)), sam2=jax_tiny_sam2(),
                          seg=JaxSegHead(out_dim=32, seg_token_id=SEG_ID))
    want_tree = script.assemble_params(JaxUniGR(jcfg), jcfg, {}, "float32")
    assert any("layers_scan" in p for p in _flatten(want_tree["params"]))
    want = torch_state_dict_from_flax(jax.tree.map(np.asarray, want_tree))
    q = tiny_config()
    cfg = UniGRConfig(qwen=q.replace(text=q.text.replace(**lora)), sam2=tiny_sam2_config(),
                      seg=SegHeadConfig(out_dim=32, seg_token_id=SEG_ID))
    model = UniGR(cfg, device="cpu")
    kept = cli.assemble_params(model, keep=lambda key: "lora_a" in key)
    got = model.state_dict()
    assert set(got) == set(want)
    for key, t in got.items():
        assert torch.equal(t, want[key]), key
    assert kept and all(torch.equal(kept[k], want[k]) for k in kept)


@pytest.fixture(scope="module")
def sam_pair():
    jcfg, tcfg = jax_tiny_sam2(64), tiny_sam2_config(64)
    jm = JaxSam2(jcfg)
    params = jax_param_tree(jm, jnp.zeros((2, 64, 64, 3)), jnp.zeros((2, 1, 32)), seed=8)
    return jm, params, tcfg


def _sam_port(tcfg, params):
    tm = Sam2Model(tcfg, device="cpu")
    tm.load_state_dict(torch_state_dict_from_flax(params), strict=True)
    return tm


@pytest.mark.parametrize("thresh", [0.0, 0.9, 1.01], ids=["all", "some", "none"])
def test_single_mask_selection_by_stability(sam_pair, thresh):
    jm0, params, tcfg = sam_pair
    jcfg = jm0.cfg.replace(dynamic_multimask_stability_thresh=thresh,
                           dynamic_multimask_stability_delta=1.0)
    jm = JaxSam2(jcfg)
    tm = _sam_port(tcfg.replace(dynamic_multimask_stability_thresh=thresh,
                                dynamic_multimask_stability_delta=1.0), params)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    lang = rng.standard_normal((4, 1, 32)).astype(np.float32)

    def heads(m, img, le):
        s0, s1, s2 = m.forward_image(img)["backbone_fpn"]
        return m.forward_sam_heads(s2, (s0, s1), language_embd=le, multimask_output=False)

    jout = jax.jit(lambda p, a, b: jm.apply(p, a, b, method=heads))(
        params, jnp.asarray(x), jnp.asarray(lang))
    with torch.no_grad():
        s0, s1, s2 = tm.forward_image(torch.from_numpy(x))["backbone_fpn"]
        tout = tm.forward_sam_heads(s2, (s0, s1), language_embd=torch.from_numpy(lang),
                                    multimask_output=False)
    for key in ("low_res_masks", "ious", "high_res_masks", "obj_ptr"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), atol=ATOL, rtol=0,
                                   err_msg=key)
    # the selection took the first mask exactly where it was stable
    if thresh == 0.0:
        np.testing.assert_allclose(tout["low_res_masks"][:, 0].numpy(),
                                   tout["low_res_multimasks"][:, 0].numpy(), atol=0)


def test_mask_prompted_forward_sam_heads(sam_pair):
    jm, params, tcfg = sam_pair
    tm = _sam_port(tcfg, params)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    masks = (4 * rng.standard_normal((2, 16, 16, 1))).astype(np.float32)
    pts = rng.uniform(0, 64, (2, 2, 2)).astype(np.float32)
    labels = np.array([[1, 0], [1, 1]], np.int32)

    def heads(m, img, mk, c, l_):
        s0, s1, s2 = m.forward_image(img)["backbone_fpn"]
        return m.forward_sam_heads(s2, (s0, s1), point_coords=c, point_labels=l_,
                                   mask_inputs=mk, multimask_output=True)

    jout = jax.jit(lambda p, *a: jm.apply(p, *a, method=heads))(
        params, *(jnp.asarray(a) for a in (x, masks, pts, labels)))
    with torch.no_grad():
        s0, s1, s2 = tm.forward_image(torch.from_numpy(x))["backbone_fpn"]
        tout = tm.forward_sam_heads(s2, (s0, s1), point_coords=torch.from_numpy(pts),
                                    point_labels=torch.from_numpy(labels),
                                    mask_inputs=torch.from_numpy(masks), multimask_output=True)
        dense = tm.sam_prompt_encoder.embed_masks(torch.from_numpy(masks))
    jdense = jax.jit(lambda p, mk: jm.apply(
        p, mk, method=lambda m, a: m.sam_prompt_encoder.embed_masks(a)))(params, masks)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), atol=ATOL, rtol=0)
    for key in ("low_res_multimasks", "ious", "high_res_masks"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), atol=ATOL, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("route", ["fused", "unfused"])
def test_gelu_exact_override(sam_pair, route, monkeypatch):
    jm0, params, tcfg = sam_pair
    jcfg = jm0.cfg
    if route == "unfused":
        jcfg = jcfg.replace(hiera=jcfg.hiera.replace(use_fused_block=False,
                                                     use_fused_transition=False))
        tcfg = unfused(tcfg)
    jm = JaxSam2(jcfg)
    tm = _sam_port(tcfg, params)
    x = np.random.default_rng(12).standard_normal((2, 64, 64, 3)).astype(np.float32)
    outs = {}
    for env in ("1", "0"):
        monkeypatch.setenv("RGA3_GELU_EXACT", env)
        assert tfb.gelu_variant(True) is (env == "0")
        # a new function each time: JAX reads the variable when it traces
        jout = jax.jit(lambda p, a: jm.apply(
            p, a, method=lambda m, a_: m.forward_image(a_)["backbone_fpn"][2]))(
            params, jnp.asarray(x))
        with torch.no_grad():
            tout = tm.forward_image(torch.from_numpy(x))["backbone_fpn"][2].numpy()
        np.testing.assert_allclose(tout, np.asarray(jout), atol=ATOL, rtol=0)
        outs[env] = tout
    monkeypatch.delenv("RGA3_GELU_EXACT")
    assert tfb.gelu_variant(None) and not tfb.gelu_variant(False)
    assert np.abs(outs["1"] - outs["0"]).max() > 10 * ATOL


@pytest.mark.parametrize("size", [(480, 854), (720, 1280)], ids=["upscale", "one_side_shrinks"])
def test_device_preprocess_matches_jax(size):
    frames = np.random.default_rng(13).integers(0, 256, (2, *size, 3), dtype=np.uint8)
    want = np.asarray(jax_preprocess(jnp.asarray(frames), 1024))
    got = sam_preprocess_frames_device(torch.from_numpy(frames), 1024, pad_to=3)
    assert got.shape == (3, 1024, 1024, 3) and got.dtype == torch.float32
    err = np.abs(got[:2].numpy() - want)
    assert err.max() <= 2e-3, err.max()
    zero = np.asarray(jax_preprocess(jnp.zeros((1, *size, 3), jnp.uint8), 1024))
    np.testing.assert_allclose(got[2:].numpy(), zero, atol=1e-6, rtol=0)


def test_segmentor_device_preprocess_matches_jax():
    jcfg = JaxUniGRConfig(qwen=jax_tiny_config(152_000), sam2=jax_tiny_sam2(64),
                          seg=JaxSegHead(out_dim=32, seg_token_id=SEG_ID))
    jm = JaxUniGR(jcfg)
    params = jax_param_tree(jm, jnp.zeros((2, 64, 64, 3)), jnp.zeros((2, 1, 32)),
                            jnp.zeros((1, 8), jnp.int32), seed=5)
    jseg = JaxSegmentor(jm, params, JaxProcessor.from_pretrained("dummy", **KW),
                        num_frames_mllm=2, sam_chunk=2, compute_dtype=jnp.float32,
                        device_preprocess=True)
    cfg = UniGRConfig(qwen=tiny_config(152_000), sam2=tiny_sam2_config(64),
                      seg=SegHeadConfig(out_dim=32, seg_token_id=SEG_ID))
    tm = UniGR(cfg, device="cpu")
    tm.load_state_dict(torch_state_dict_from_flax(params), strict=True)
    tseg = UniGRSegmentor(tm, QwenVLProcessor.from_pretrained("dummy", **KW),
                          num_frames_mllm=2, sam_chunk=2, device_preprocess=True)
    frames = [f for f in np.random.default_rng(1).integers(0, 256, (3, 56, 84, 3),
                                                           dtype=np.uint8)]
    exprs = ["the moving thing", "a dog"]
    jmask = jseg.segment_video_multi(frames, exprs)
    tmask = tseg.segment_video_multi(frames, exprs)
    assert tmask.shape == jmask.shape == (2, 3, 56, 84)
    assert (tmask == jmask).mean() >= 0.999

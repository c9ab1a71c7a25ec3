"""The port's CoTracker3 (`rga3_tpu_torch/models/stom/cotracker3.py`) and its
weight bridge (`convert.load_keystr_npz`) against the JAX package's, on the
CPU.

Modules at `tiny_cotracker3_config()` from one seeded parameter tree, f32,
within 1e-5. The whole tracker on the repo's trained weights
(`cotracker3_small.npz`) and three clips of the JAX package's `synth`
(160x224, the model resolution, so no resize stands between the two):

  * f32, one refinement iteration: tracks within 1e-3 px, vis / conf logits
    within 1e-4 of their max;
  * the file's bf16 and four iterations: each clip's mean track error
    against the clip's ground truth within 0.05 px of JAX's, and its
    visibility accuracy against the ground truth within 0.01 of JAX's.

Four iterations are not compared point by point: the flow embedding's
sin/cos run at up to ~1000 rad per grid pixel, so each refinement multiplies
a rounding difference many times over. At the file's bf16 the reference's
own rounding spread (its jitted against its op-by-op forward) is measured,
and the port held within it, at one iteration by
`test_torch_cotracker3_spread.py`; the bf16 rounding points are held one
module at a time by `test_torch_cotracker3_bf16.py`.
"""
import dataclasses
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rga3_tpu.models.stom import cotracker3 as jct
from rga3_tpu.models.stom import synth
from rga3_tpu_torch.convert import load_keystr_npz, torch_state_dict_from_flax
from rga3_tpu_torch.models.stom import cotracker3 as tct

from torch_port_support import jax_param_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "rga3_tpu", "models", "stom", "weights")
ATOL = 1e-5
CLIP_SEEDS = (5000, 5001, 5002)


def _np(t):
    return t.detach().float().numpy()


def _port(module, params):
    module.load_state_dict(torch_state_dict_from_flax(params), strict=True)
    return module.eval()


# -- modules at the tiny config ------------------------------------------------


def test_instance_norm():
    x = np.random.default_rng(0).normal(2.0, 3.0, (2, 12, 16, 8)).astype(np.float32)
    ref = np.asarray(jct.instance_norm(jnp.asarray(x)))
    got = tct.instance_norm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(_np(got), ref, atol=ATOL)


def test_basic_encoder():
    cfg = tct.tiny_cotracker3_config()
    mh, mw = cfg.model_resolution
    x = np.random.default_rng(1).uniform(-1, 1, (2, mh, mw, 3)).astype(np.float32)
    jm = jct.BasicEncoder(cfg.latent_dim, cfg.stride)
    params = jax_param_tree(jm, jnp.zeros((2, mh, mw, 3)), seed=1)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    tm = _port(tct.BasicEncoder(cfg.latent_dim, cfg.stride), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == ref.shape == (2, mh // 4, mw // 4, cfg.latent_dim)
    np.testing.assert_allclose(_np(got), ref, atol=ATOL)


def test_efficient_update_former():
    cfg = tct.tiny_cotracker3_config()
    x = np.random.default_rng(2).normal(0, 1, (2, 5, 4, cfg.input_dim)).astype(np.float32)
    jm = jct.EfficientUpdateFormer(cfg)
    params = jax_param_tree(jm, jnp.zeros((2, 5, 4, cfg.input_dim)), seed=2)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    tm = _port(tct.EfficientUpdateFormer(cfg), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == ref.shape == (2, 5, 4, 4)
    np.testing.assert_allclose(_np(got), ref, atol=ATOL)


@pytest.mark.parametrize("radius", [1, 3])
def test_stencil_sample_border_centres(radius):
    rng = np.random.default_rng(3)
    h, w, c = 12, 16, 8
    fmap = rng.normal(0, 1, (h, w, c)).astype(np.float32)
    inside = rng.uniform([0, 0], [w - 1, h - 1], (20, 2))
    border = np.array([[0, 0], [w - 1, h - 1], [0.3, h - 1.2], [w - 1.01, 0.5],
                       [-2.5, 4.2], [w + 3.1, h + 0.7], [7.5, -1.0]])
    centers = np.concatenate([inside, border]).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ref = np.asarray(jct.stencil_sample(jnp.asarray(fmap).astype(jdt), jnp.asarray(centers),
                                            radius).astype(jnp.float32))
        got = tct.stencil_sample(torch.from_numpy(fmap).to(dt), torch.from_numpy(centers), radius)
        assert got.shape == ref.shape == (len(centers), (2 * radius + 1) ** 2, c)
        np.testing.assert_allclose(_np(got), ref, atol=ATOL if dt == torch.float32 else 0)


def test_get_2d_embedding():
    xy = np.random.default_rng(4).uniform(-20, 20, (3, 7, 2)).astype(np.float32)
    for dim, cat in ((8, True), (64, True), (8, False)):
        ref = np.asarray(jct.get_2d_embedding(jnp.asarray(xy), dim, cat_coords=cat))
        got = tct.get_2d_embedding(torch.from_numpy(xy), dim, cat_coords=cat)
        assert got.shape == ref.shape
        np.testing.assert_allclose(_np(got), ref, atol=ATOL)


def test_get_1d_sincos_embed():
    for dim, length in ((8, 4), (708, 8), (1156, 8)):
        ref = np.asarray(jct.get_1d_sincos_embed(dim, length))
        np.testing.assert_allclose(_np(tct.get_1d_sincos_embed(dim, length)), ref, atol=ATOL)


# the encoder's ratios at the tiny and at the model resolution (stage a down
# by 2, c up by 2, e up by 4) and the video resize of a 480x854 clip
@pytest.mark.parametrize("hw,out", [
    ((32, 48), (16, 24)), ((8, 12), (16, 24)), ((4, 6), (16, 24)),
    ((80, 112), (40, 56)), ((20, 28), (40, 56)), ((10, 14), (40, 56)),
    ((480, 854), (160, 224)),
])
def test_resize_bilinear(hw, out):
    x = np.random.default_rng(5).normal(0, 1, (2, *hw, 3)).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ref = np.asarray(jct._resize_bilinear(jnp.asarray(x).astype(jdt), out).astype(jnp.float32))
        got = tct._resize_bilinear(torch.from_numpy(x).to(dt).permute(0, 3, 1, 2), out)
        got = _np(got.permute(0, 2, 3, 1))
        if dt == torch.float32:
            np.testing.assert_allclose(got, ref, atol=ATOL)
        else:  # each contraction rounded to bf16 as the reference's einsum does
            np.testing.assert_allclose(got, ref, rtol=2 ** -8, atol=0)


def test_tiny_tracker_batched_matches_per_clip_reference():
    """One batched forward over two clips (the predictor's track_batch
    route) against the reference's vmapped per-clip forward, f32, one refinement
    iteration, queries on several frames and a resize (48x64 -> 64x96)."""
    cfg = tct.tiny_cotracker3_config().replace(iters=1)
    rng = np.random.default_rng(6)
    frames = rng.uniform(0, 255, (2, 4, 48, 64, 3)).astype(np.float32)
    queries = np.stack([np.stack([rng.integers(0, 4, 6), rng.uniform(0, 63, 6),
                                  rng.uniform(0, 47, 6)], -1) for _ in range(2)]).astype(np.float32)
    jm = jct.CoTracker3Offline(cfg)
    params = jax_param_tree(jm, jnp.zeros((4, 48, 64, 3)), jnp.zeros((6, 3)), seed=6, std=0.05)
    tm = _port(tct.CoTracker3Offline(cfg), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(frames), torch.from_numpy(queries))
    # the reference's track_batch route: its per-clip forward under vmap
    ref = jax.jit(jax.vmap(jm.apply, in_axes=(None, 0, 0)))(
        params, jnp.asarray(frames), jnp.asarray(queries))
    assert got["tracks"].shape == ref["tracks"].shape == (2, 1, 4, 6, 2)
    np.testing.assert_allclose(_np(got["tracks"]), np.asarray(ref["tracks"]), atol=1e-4)
    for k in ("vis", "conf"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(ref[k]), atol=ATOL)


# -- the trained weights ------------------------------------------------------


@pytest.fixture(scope="module")
def shipped():
    """(JAX params, JAX config, the port's model) of cotracker3_small.npz."""
    path = os.path.join(WEIGHTS, "cotracker3_small.npz")
    params, cfg = jct.load_cotracker3(path)
    model, tcfg = tct.load_cotracker3(path, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    return params, cfg, model


@pytest.fixture(scope="module")
def clips():
    return [synth.make_training_clip(np.random.default_rng(s)) for s in CLIP_SEEDS]


def _run_both(shipped, clips, **override):
    params, cfg, model = shipped
    jm = jct.CoTracker3Offline(dataclasses.replace(cfg, **override))
    tm = tct.CoTracker3Offline(model.cfg.replace(**override))
    tm.load_state_dict(model.state_dict(), strict=True)
    tm.eval()
    apply = jax.jit(jm.apply)
    out = []
    for frames, queries, gt, gv in clips:
        video = (frames * 255.0).astype(np.float32)
        ref = jax.tree.map(np.asarray, apply(params, jnp.asarray(video), jnp.asarray(queries)))
        with torch.inference_mode():
            got = tm(torch.from_numpy(video), torch.from_numpy(np.asarray(queries, np.float32)))
        out.append((ref, {k: _np(v) for k, v in got.items()}, gt, gv))
    return out


def test_shipped_tracker_f32_one_iteration(shipped, clips):
    for ref, got, _, _ in _run_both(shipped, clips, compute_dtype="float32", iters=1):
        assert got["tracks"].shape == ref["tracks"].shape
        np.testing.assert_allclose(got["tracks"], ref["tracks"], atol=1e-3)
        for k in ("vis", "conf"):
            assert np.abs(got[k] - ref[k]).max() <= 1e-4 * np.abs(ref[k]).max(), k


def _visible(out):
    p = 0.5 * (1 + np.tanh(0.5 * out["vis"])) * 0.5 * (1 + np.tanh(0.5 * out["conf"]))
    return p > 0.6


def test_shipped_tracker_bf16_quality(shipped, clips):
    for ref, got, gt, gv in _run_both(shipped, clips):
        err = [np.linalg.norm(o["tracks"][-1] - gt, axis=-1).mean() for o in (ref, got)]
        acc = [(_visible(o) == gv).mean() for o in (ref, got)]
        assert np.isfinite(got["tracks"]).all()
        assert abs(err[1] - err[0]) <= 0.05, err
        assert abs(acc[1] - acc[0]) <= 0.01, acc


# -- the weight bridge ---------------------------------------------------------


@pytest.mark.parametrize("name", ["cotracker3_small.npz", "cotracker3_official.npz"])
def test_weight_bridge_loads_shipped_files(name):
    """load_keystr_npz + torch_state_dict_from_flax load both shipped files
    strictly, with tensors equal to the JAX loader's (Dense transposed, Conv
    HWIO -> OIHW, LayerNorm scale -> weight, virual_tracks raw)."""
    path = os.path.join(WEIGHTS, name)
    tree, raw = load_keystr_npz(path)
    cfg = tct.config_from_dict(raw)
    model = tct.CoTracker3Offline(cfg)
    sd = torch_state_dict_from_flax(tree)
    model.load_state_dict(sd, strict=True)
    params, jcfg = jct.load_cotracker3(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    ref = torch_state_dict_from_flax(jax.tree.map(np.asarray, params))
    assert set(ref) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref[k]), k
    p = params["params"]
    np.testing.assert_array_equal(
        _np(model.fnet.layer2_0.downsample_0.weight),
        np.asarray(p["fnet"]["layer2_0"]["downsample_0"]["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        _np(model.updateformer.space_virtual2point_blocks_0.norm_context.weight),
        np.asarray(p["updateformer"]["space_virtual2point_blocks_0"]["norm_context"]["scale"]))
    np.testing.assert_array_equal(_np(model.updateformer.virual_tracks),
                                  np.asarray(p["updateformer"]["virual_tracks"]))
    np.testing.assert_array_equal(_np(model.corr_mlp_fc1.weight),
                                  np.asarray(p["corr_mlp_fc1"]["kernel"]).T)

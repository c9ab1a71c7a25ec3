"""The port's LK tracker (`models/stom/tracker.LKTracker`), `stom.default_tracker`
and the official CoTracker3 key map (`models/stom/convert.py`) against the
JAX package's, on the CPU.

  * LK: identical tracks and visibility on synthetic clips (several key
    frames, an empty mask: both call this process's OpenCV), STOM over LK
    compositing byte-identical frames, and a textured patch shifted by a
    known step a frame propagated to within 1 px;
  * `default_tracker`: the same backend in all five cases (`lk`, an existing
    `.npz`, a missing `.npz`, `cotracker3` and `auto` without weights);
  * convert: the JAX package's `export_torch_state_dict` of a seeded JAX
    CoTracker3 at the tiny and the small config loads into the port (config
    inferred equal to JAX's, tracks within the one-iteration tolerance of
    `test_torch_cotracker3.py`), the port's export loads into JAX with every
    leaf equal bit for bit, and a missing key, an extra key and a wrong
    shape raise with both names.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rga3_tpu.models.stom import convert as jcv
from rga3_tpu.models.stom import cotracker3 as jct
from rga3_tpu.models.stom import stom as jstom
from rga3_tpu.models.stom import tracker as jtr
from rga3_tpu_torch.models.stom import convert as tcv
from rga3_tpu_torch.models.stom import cotracker3 as tct
from rga3_tpu_torch.models.stom import stom as tstom
from rga3_tpu_torch.models.stom import tracker as ttr
from rga3_tpu_torch.tools.synth_trees import shifted_patch_clip

from torch_port_support import jax_param_tree

# -- LK -----------------------------------------------------------------------


def _lk_clip(seed, t=6, h=72, w=96):
    frames, _ = shifted_patch_clip(np.random.default_rng(seed), t, (h, w), (24, 32),
                                   (2.0, 1.0), (20, 30))
    return frames


def _mask(h, w, box):
    m = np.zeros((h, w), np.uint8)
    if box:
        y0, y1, x0, x1 = box
        m[y0:y1, x0:x1] = 1
    return m


@pytest.mark.parametrize("key", [0, 2, 5])
@pytest.mark.parametrize("box", [(22, 40, 32, 58), None])
def test_lk_tracks_equal_jax(key, box):
    frames = _lk_clip(3 + key)
    mask = _mask(72, 96, box)
    want = jtr.LKTracker().track(frames, mask, key, grid_size=30)
    got = ttr.LKTracker().track(frames, mask, key, grid_size=30)
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    n = 0 if box is None else got[0].shape[1]
    assert got[0].shape == (6, n, 2) and (box is None or n > 20)
    pts = np.asarray([[40.5, 30.0], [50.0, 35.25]], np.float32)
    for w_, g in zip(jtr.LKTracker(9, 1).track_points(frames, pts, key),
                     ttr.LKTracker(9, 1).track_points(frames, pts, key)):
        assert np.array_equal(w_, g)


@pytest.mark.parametrize("shape", ["rectangle", "mask"])
def test_stom_over_lk_matches_jax(shape):
    frames = _lk_clip(11)
    vip = np.zeros((72, 96, 4), np.uint8)
    if shape == "rectangle":
        vip[18:46, 28:64] = (255, 0, 0, 255)
        vip[21:43, 31:61] = 0
    else:
        vip[22:40, 32:58] = (30, 220, 90, 128)
    want = jstom.STOM(tracker=jtr.LKTracker()).propagate_in_video(frames, vip, 1, shape=shape)
    got = tstom.STOM(tracker=ttr.LKTracker()).propagate_in_video(frames, vip, 1, shape=shape)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert sum(not np.array_equal(g, f) for g, f in zip(got, frames)) == len(frames)


def test_lk_propagates_a_known_shift():
    """A textured patch moved by (dx, dy) a frame over a static background:
    the propagated rectangle sits within 1 px of the shift in every frame."""
    shift, key = (3.0, -2.0), 2
    frames, boxes = shifted_patch_clip(np.random.default_rng(5), 7, (96, 128), (32, 40),
                                       shift, (40, 30))
    y0, y1, x0, x1 = boxes[key]
    vip = np.zeros((96, 128, 4), np.uint8)
    vip[y0 - 3:y1 + 3, x0 - 3:x1 + 3] = (255, 0, 0, 255)
    vip[y0:y1, x0:x1] = 0
    out = tstom.STOM(tracker=ttr.LKTracker()).propagate_in_video(frames, vip, key)
    for t, f in enumerate(out):
        ys, xs = np.nonzero((f[..., 0] == 255) & (f[..., 1] == 0) & (f[..., 2] == 0))
        dy, dx = ys.min() - (y0 - 3), xs.min() - (x0 - 3)
        assert abs(dx - (t - key) * shift[0]) <= 1 and abs(dy - (t - key) * shift[1]) <= 1, (
            t, dx, dy)


# -- default_tracker ------------------------------------------------------------


SMALL = jct._SHIPPED_WEIGHTS


@pytest.mark.parametrize("choice,weights", [("lk", True), (SMALL, True),
                                            ("/nonexistent/w.npz", True),
                                            ("cotracker3", False), ("auto", False)])
def test_default_tracker_matches_jax(monkeypatch, choice, weights):
    monkeypatch.setenv("RGA3_STOM_TRACKER", choice)
    if not weights:
        monkeypatch.setattr(jct, "_SHIPPED_WEIGHTS", "/nonexistent/cotracker3_small.npz")
        monkeypatch.setattr(tct, "_SHIPPED_WEIGHTS", "/nonexistent/cotracker3_small.npz")
    outs = []
    for fn in (jstom.default_tracker, lambda: tstom.default_tracker("cpu")):
        try:
            outs.append(type(fn()).__name__)
        except FileNotFoundError:
            outs.append("FileNotFoundError")
    assert outs[0] == outs[1], outs
    assert outs[0] == {"lk": "LKTracker", SMALL: "CoTracker3Predictor", "auto": "LKTracker"}.get(
        choice, "FileNotFoundError")


# -- convert ---------------------------------------------------------------------


def _jax_tree(cfg, seed):
    mh, mw = cfg.model_resolution
    return jax_param_tree(jct.CoTracker3Offline(cfg), jnp.zeros((2, mh, mw, 3)),
                          jnp.zeros((4, 3)), seed=seed, std=0.05)


CONFIGS = {"tiny": (jct.tiny_cotracker3_config, tct.tiny_cotracker3_config, 1e-4),
           "small": (jct.cotracker3_small_config, tct.cotracker3_small_config, 1e-3)}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_official_state_dict_round_trip(name):
    jcfg_fn, tcfg_fn, tol = CONFIGS[name]
    jcfg = dataclasses.replace(jcfg_fn(), compute_dtype="float32", iters=1)
    tcfg = tcfg_fn().replace(compute_dtype="float32", iters=1)
    params = _jax_tree(jcfg, seed=21)
    sd = jcv.export_torch_state_dict(params)
    model = tcv.build_cotracker3_from_state_dict(sd, base=tcfg, device="cpu")
    assert dataclasses.asdict(model.cfg) == dataclasses.asdict(
        jcv.infer_config_from_state_dict(sd, base=jcfg))
    assert not model.training and next(model.parameters()).device.type == "cpu"

    # tracks at one iteration, f32
    mh, mw = jcfg.model_resolution
    rng = np.random.default_rng(22)
    frames = rng.uniform(0, 255, (3, mh, mw, 3)).astype(np.float32)
    queries = np.stack([rng.integers(0, 3, 6), rng.uniform(0, mw - 1, 6),
                        rng.uniform(0, mh - 1, 6)], -1).astype(np.float32)
    ref = jax.jit(jct.CoTracker3Offline(jcfg).apply)(params, jnp.asarray(frames),
                                                      jnp.asarray(queries))
    with torch.inference_mode():
        got = model(torch.from_numpy(frames), torch.from_numpy(queries))
    np.testing.assert_allclose(got["tracks"].numpy(), np.asarray(ref["tracks"]), atol=tol)

    # the port's export into JAX: every leaf bit-equal
    back = tcv.export_torch_state_dict(model)
    assert set(back) == set(sd)
    loaded = jcv.load_torch_state_dict(params, {k: v.numpy() for k, v in back.items()})
    flat_a, flat_b = jax.tree_util.tree_leaves_with_path(loaded), jax.tree_util.tree_leaves(params)
    assert len(flat_a) == len(flat_b)
    for (path, a), b in zip(flat_a, flat_b):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.asarray(a), np.asarray(b)), jax.tree_util.keystr(path)


def test_checkpoint_file_and_strict_errors(tmp_path):
    jcfg = jct.tiny_cotracker3_config()
    sd = jcv.export_torch_state_dict(_jax_tree(jcfg, seed=23))
    # a torch.save'd file under "model", with the official buffers beside
    path = str(tmp_path / "scaled_offline.pth")
    torch.save({"model": {**{f"model.{k}": torch.from_numpy(v) for k, v in sd.items()},
                          "time_emb": torch.zeros(1, 5, 68), "pos_emb": torch.zeros(1, 68, 8, 8)}},
               path)
    model = tcv.build_cotracker3_from_checkpoint(path, base=tct.tiny_cotracker3_config(),
                                                 device="cpu")
    for k, v in tcv.export_torch_state_dict(model).items():
        assert np.array_equal(v.numpy(), sd[k]), k
    assert tcv.to_official_key("updateformer.space_virtual2point_blocks_1.norm_context.weight") \
        == "updateformer.space_virtual2point_blocks.1.norm_context.weight"
    assert tcv.from_official_key("corr_mlp.fc2.bias") == "corr_mlp_fc2.bias"
    assert all(tcv.from_official_key(tcv.to_official_key(k)) == k for k in model.state_dict())

    fresh = tct.CoTracker3Offline(tct.tiny_cotracker3_config())
    missing = dict(sd)
    missing.pop("fnet.layer2.0.downsample.0.weight")
    with pytest.raises(KeyError, match=r"missing=\[.fnet\.layer2\.0\.downsample\.0\.weight "
                       r"\(model: fnet\.layer2_0\.downsample_0\.weight\)"):
        tcv.load_torch_state_dict(fresh, missing)
    extra = {**sd, "updateformer.time_blocks.9.attn.to_q.weight": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match=r"unexpected=\[.updateformer\.time_blocks\.9\.attn\.to_q"
                       r"\.weight \(model: updateformer\.time_blocks_9\.attn\.to_q\.weight\)"):
        tcv.load_torch_state_dict(fresh, extra)
    wrong = {**sd, "corr_mlp.fc1.weight": np.zeros((3, 3), np.float32)}
    with pytest.raises(ValueError, match=r"checkpoint corr_mlp\.fc1\.weight \(3, 3\) vs model "
                       r"corr_mlp_fc1\.weight"):
        tcv.load_torch_state_dict(fresh, wrong)

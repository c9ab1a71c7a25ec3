"""The port's STOM (`rga3_tpu_torch/models/stom/stom.py`, `raster.py`,
`tracker.py`), its CoTracker3 predictor and `evaluation/videoinfer.py`'s
`run_inference` against the JAX package's, on the CPU.

  * `raster` against cv2 byte for byte (the filled circle across frame
    borders, the ellipse structuring element, the closing, the moments);
    `ops.resize.resize_u8_bilinear_aa` byte for byte against PIL's BILINEAR;
  * `propagate_in_video` / `propagate_in_video_batch` byte for byte against
    the JAX `STOM`, with one stub tracker handed to both packages (the query
    mask, N and the compositing alone), and with the repo's trained
    CoTracker3 weights at f32 and one refinement iteration on 160x224
    frames (the model resolution: no resize between the two);
  * the key-frame visibility fallback of `track_in_video`, which the batch
    path lacks in both packages;
  * the predictor's `track_batch` against `track`;
  * `run_inference` with a recording stub chat, both packages, batch sizes
    1 and 2: the same questions, the same frames, and resume.

The tests pass their tracker explicitly or set `RGA3_STOM_TRACKER` with
monkeypatch (the suite's conftest pins it to `lk`).
"""
import dataclasses
import json
import os

import cv2
import numpy as np
import pytest
import jax
import torch
from PIL import Image

from rga3_tpu.evaluation import videoinfer_eval as jvi
from rga3_tpu.models.stom import cotracker3 as jct
from rga3_tpu.models.stom import stom as jstom
from rga3_tpu.models.stom import synth
from rga3_tpu_torch.convert import torch_state_dict_from_flax
from rga3_tpu_torch.evaluation import videoinfer as tvi
from rga3_tpu_torch.models.stom import cotracker3 as tct
from rga3_tpu_torch.models.stom import raster
from rga3_tpu_torch.models.stom import stom as tstom
from rga3_tpu_torch.ops.resize import resize_u8_bilinear_aa

from torch_port_support import jax_param_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = os.path.join(ROOT, "rga3_tpu", "models", "stom", "weights", "cotracker3_small.npz")


# -- cv2 and PIL counterparts -------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_fill_circle_matches_cv2(seed):
    rng = np.random.default_rng(seed)
    for _ in range(400):
        h, w = rng.integers(1, 70, 2)
        r = int(rng.integers(0, 45))
        cx, cy = int(rng.integers(-40, w + 40)), int(rng.integers(-40, h + 40))
        want = np.zeros((h, w), np.uint8)
        cv2.circle(want, (cx, cy), r, 1, cv2.FILLED)
        got = np.zeros((h, w), np.uint8)
        raster.fill_circle(got, (cx, cy), r, 1)
        assert np.array_equal(got, want), (h, w, cx, cy, r)


def test_ellipse_kernel_matches_cv2():
    for k in range(1, 90):
        want = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k))
        assert np.array_equal(raster.ellipse_kernel(k), want), k


@pytest.mark.parametrize("seed", range(3))
def test_close_and_moments_match_cv2(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        h, w = int(rng.integers(10, 200)), int(rng.integers(10, 300))
        m = np.zeros((h, w), np.uint8)
        n = int(rng.integers(0, 120))
        spread = rng.uniform(0.05, 0.5)
        ys = np.clip(rng.normal(rng.uniform(0, h), h * spread, n), 0, h - 1).astype(int)
        xs = np.clip(rng.normal(rng.uniform(0, w), w * spread, n), 0, w - 1).astype(int)
        m[ys, xs] = 255
        k = max(min(h, w) // 15, 3) + int(rng.integers(0, 3))
        want = cv2.morphologyEx(m, cv2.MORPH_CLOSE,
                                cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k)))
        got = raster.morph_close(m, raster.ellipse_kernel(k))
        assert np.array_equal(got, want), (h, w, k)
        mw, mg = cv2.moments(want), raster.moments(got)
        assert all(mw[key] == mg[key] for key in ("m00", "m10", "m01"))


@pytest.mark.parametrize("hw,out", [((480, 854), (160, 224)), ((64, 80), (160, 224)),
                                    ((97, 131), (40, 57))])
def test_resize_u8_bilinear_aa_matches_pil(hw, out):
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    frames[0, hw[0] // 3:, : hw[1] // 2] = 255  # a hard edge
    got = resize_u8_bilinear_aa(torch.from_numpy(frames), out).numpy()
    for f, g in zip(frames, got):
        want = np.asarray(Image.fromarray(f).resize((out[1], out[0]), Image.BILINEAR))
        assert g.shape == want.shape and np.array_equal(g, want)


# -- STOM against the JAX package's --------------------------------------------


class StubTracker:
    """Fixed tracks for both packages: the grid points in the query mask,
    moved by a per-frame offset and a seeded jitter; `hidden_key` hides
    every point at the key frame and three quarters elsewhere. Records the
    masks it was given."""

    def __init__(self, seed=0, hidden_key=False):
        self.seed, self.hidden_key, self.masks = seed, hidden_key, []

    def track(self, frames, query_mask, query_frame_idx, grid_size=100):
        from rga3_tpu_torch.models.stom.tracker import sample_grid_points_in_mask

        self.masks.append(np.array(query_mask))
        pts = sample_grid_points_in_mask(query_mask, grid_size)
        rng = np.random.default_rng(self.seed + len(pts))
        t = len(frames)
        offs = np.stack([np.arange(t) * 3.3 - 4.1, np.arange(t) * -2.2 + 1.3], -1)
        tracks = pts[None] + offs[:, None] + rng.normal(0, 0.7, (t, len(pts), 2))
        tracks[:, :3] += 40.0  # outliers for the MAD filter
        # a miscalibrated head hides the key frame and most points elsewhere
        vis = rng.uniform(size=(t, len(pts))) > (0.75 if self.hidden_key else 0.2)
        vis[query_frame_idx] = not self.hidden_key
        return tracks.astype(np.float32), vis


def _clip(seed, t=5, h=96, w=128):
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(t):
        f = rng.integers(0, 80, (h, w, 3), dtype=np.uint8)
        f[30 + 2 * i:60 + 2 * i, 20 + 4 * i:70 + 4 * i] = (200, 180, 60)
        frames.append(f)
    return frames


def _overlay(h, w, shape, seed=0):
    vip = np.zeros((h, w, 4), np.uint8)
    if shape == "rectangle":
        cv2.rectangle(vip, (22, 28), (74, 63), (255, 0, 0, 255), 3)
    else:
        yy, xx = np.mgrid[:h, :w]
        blob = ((yy - 45) / 14.0) ** 2 + ((xx - 48) / 22.0) ** 2 < 1
        vip[blob] = (30, 220, 90, 128)
    return vip


@pytest.mark.parametrize("shape", ["rectangle", "mask"])
@pytest.mark.parametrize("key", [0, 2])
def test_propagate_stub_tracker_matches_jax(shape, key):
    frames = _clip(10 + key)
    vip = _overlay(96, 128, shape)
    jt, tt = StubTracker(3), StubTracker(3)
    want = jstom.STOM(tracker=jt).propagate_in_video(frames, vip, key, shape=shape)
    got = tstom.STOM(tracker=tt).propagate_in_video(frames, vip, key, shape=shape)
    assert np.array_equal(jt.masks[0], tt.masks[0]) and tt.masks[0].sum() > 0
    assert len(got) == len(want) == len(frames)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and np.array_equal(g, w)
    assert sum(not np.array_equal(g, f) for g, f in zip(got, frames)) >= 2
    # PIL frames in, PIL frames out, the same bytes
    pil = [Image.fromarray(f) for f in frames]
    got_pil = tstom.STOM(tracker=StubTracker(3)).propagate_in_video(pil, vip, key, shape=shape)
    assert all(isinstance(g, Image.Image) for g in got_pil)
    assert all(np.array_equal(np.asarray(g), w) for g, w in zip(got_pil, want))


def test_propagate_batch_stub_tracker_matches_jax():
    batch = [{"frames": _clip(20), "vip": _overlay(96, 128, "rectangle"), "key_idx": 1,
              "shape": "rectangle"},
             {"frames": _clip(21), "vip": _overlay(96, 128, "mask"), "key_idx": 3,
              "shape": "mask"},
             {"frames": _clip(22), "vip": np.zeros((96, 128, 4), np.uint8), "key_idx": 0,
              "shape": "rectangle"}]
    want = jstom.STOM(tracker=StubTracker(5)).propagate_in_video_batch(batch)
    got = tstom.STOM(tracker=StubTracker(5)).propagate_in_video_batch(batch)
    for gs, ws in zip(got, want):
        assert all(np.array_equal(g, w) for g, w in zip(gs, ws))


def test_keyframe_visibility_fallback_single_path_only():
    """track_in_video marks every point visible when the head hides most at
    the key frame; propagate_in_video_batch has no such fallback (the
    reference's edge, mirrored in both packages)."""
    frames, vip = _clip(30), _overlay(96, 128, "rectangle")
    outs = {}
    for name, mod in (("jax", jstom), ("port", tstom)):
        single = mod.STOM(tracker=StubTracker(7, hidden_key=True)).propagate_in_video(
            frames, vip, 1)
        batch = mod.STOM(tracker=StubTracker(7, hidden_key=True)).propagate_in_video_batch(
            [{"frames": frames, "vip": vip, "key_idx": 1, "shape": "rectangle"}])[0]
        outs[name] = (single, batch)
    for a, b in zip(outs["jax"], outs["port"]):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    single, batch = outs["port"]
    assert not all(np.array_equal(x, y) for x, y in zip(single, batch))
    tr, vis = tstom.STOM(tracker=StubTracker(7, hidden_key=True)).track_in_video(
        frames, vip, 1)
    assert vis.all()


@pytest.fixture(scope="module")
def shipped_f32():
    """The trained weights at f32 and one refinement iteration in both
    packages: (JAX predictor, port predictor)."""
    params, cfg = jct.load_cotracker3(SMALL)
    cfg1 = dataclasses.replace(cfg, compute_dtype="float32", iters=1)
    model, _ = tct.load_cotracker3(SMALL, device="cpu")
    port = tct.CoTracker3Offline(tct.config_from_dict(dataclasses.asdict(cfg1)))
    port.load_state_dict(model.state_dict(), strict=True)
    return (jct.CoTracker3Predictor(params, jct.CoTracker3Offline(cfg1)),
            tct.CoTracker3Predictor(port.eval(), device="cpu"))


@pytest.mark.parametrize("shape", ["rectangle", "mask"])
def test_propagate_shipped_weights_matches_jax(shipped_f32, shape):
    jpred, tpred = shipped_f32
    frames, *_ = synth.make_training_clip(np.random.default_rng(5003), n_fg=(1, 2))
    frames = [np.ascontiguousarray((f * 255).round().astype(np.uint8)) for f in frames]
    vip = np.zeros((160, 224, 4), np.uint8)
    if shape == "rectangle":
        cv2.rectangle(vip, (60, 40), (150, 110), (255, 0, 0, 255), 3)
    else:
        cv2.ellipse(vip, (110, 80), (40, 28), 0, 0, 360, (40, 200, 90, 140), -1)
    key = 2
    jt, tt = jstom.STOM(tracker=jpred), tstom.STOM(tracker=tpred)
    tr_j, vis_j = jt.track_in_video(frames, vip, key)
    tr_t, vis_t = tt.track_in_video(frames, vip, key)
    assert tr_t.shape == tr_j.shape and tr_t.shape[1] > 100
    np.testing.assert_allclose(tr_t, tr_j, atol=1e-3)
    assert np.array_equal(vis_t, vis_j)
    want = jt.propagate_in_video(frames, vip, key, shape=shape)
    got = tt.propagate_in_video(frames, vip, key, shape=shape)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_track_batch_matches_track():
    """One batched forward == per-clip track calls: mixed native sizes
    unified by the pre-resize, an empty mask, chunks of 2 (a one-clip
    remainder), and a ragged clip length (the per-clip route)."""
    cfg = tct.tiny_cotracker3_config()
    jm = jct.CoTracker3Offline(cfg)
    params = jax_param_tree(jm, jax.numpy.zeros((4, 48, 64, 3)), jax.numpy.zeros((6, 3)),
                            seed=8, std=0.05)
    model = tct.CoTracker3Offline(cfg)
    model.load_state_dict(torch_state_dict_from_flax(params), strict=True)
    pred = tct.CoTracker3Predictor(model.eval(), device="cpu", max_points=8, max_batch_clips=2)
    rng = np.random.default_rng(9)
    clips, masks = [], []
    for b, (h, w) in enumerate([(48, 64), (40, 56), (48, 64), (64, 96)]):
        frames = []
        for i in range(4):
            f = rng.uniform(0, 60, (h, w, 3))
            f[8 + 2 * i:20 + 2 * i, 6 + 3 * i:20 + 3 * i] = 220.0
            frames.append(f.astype(np.uint8))
        clips.append(frames)
        m = np.zeros((h, w), np.uint8)
        if b != 2:
            m[10:18, 8:18] = 1
        masks.append(m)
    idxs = [0, 1, 0, 3]
    got = pred.track_batch(clips, masks, idxs, grid_size=6)
    for i in range(4):
        tr_s, vis_s = pred.track(clips[i], masks[i], idxs[i], grid_size=6)
        tr_b, vis_b = got[i]
        assert tr_b.shape == tr_s.shape
        np.testing.assert_allclose(tr_b, tr_s, atol=5e-2)
        if vis_s.size:
            assert (vis_b == vis_s).mean() >= 0.95
    assert got[2][0].shape == (4, 0, 2)
    ragged = pred.track_batch([clips[0], clips[1][:3]], masks[:2], [0, 1], grid_size=6)
    for (tr_b, _), clip, m, i in zip(ragged, [clips[0], clips[1][:3]], masks[:2], [0, 1]):
        np.testing.assert_allclose(tr_b, pred.track(clip, m, i, grid_size=6)[0], atol=5e-2)


def test_default_tracker_and_device_guards(monkeypatch):
    monkeypatch.setenv("RGA3_STOM_TRACKER", "lk")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tstom.default_tracker("cpu")
    monkeypatch.setenv("RGA3_STOM_TRACKER", "/nonexistent/weights.npz")
    with pytest.raises(FileNotFoundError):
        tstom.default_tracker("cpu")
    monkeypatch.setenv("RGA3_STOM_TRACKER", SMALL)
    pred = tstom.default_tracker("cpu")
    assert isinstance(pred, tct.CoTracker3Predictor) and pred.model.cfg.latent_dim == 96
    monkeypatch.setenv("RGA3_STOM_TRACKER", "auto")
    monkeypatch.setattr(tct, "_SHIPPED_WEIGHTS", "/nonexistent/cotracker3_small.npz")
    with pytest.raises(FileNotFoundError, match="not ported"):
        tstom.default_tracker("cpu")
    if not torch.cuda.is_available():
        monkeypatch.setenv("RGA3_STOM_TRACKER", SMALL)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tstom.STOM()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tct.CoTracker3Predictor(pred.model)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tvi.run_inference(None, [], "/nonexistent/preds.jsonl")


# -- run_inference ---------------------------------------------------------------


class RecordingChat:
    def __init__(self):
        self.calls = []

    def answer(self, question, video_frames=None):
        self.calls.append((question, [f.copy() for f in video_frames]))
        return f"answer {len(self.calls)}"

    def answer_batch(self, questions, video_frames_list=None):
        return [self.answer(q, video_frames=f) for q, f in zip(questions, video_frames_list)]


def _items():
    out = []
    for i, (shape, key) in enumerate([("rectangle", 0), ("mask", 2), (None, 0),
                                      ("rectangle", 4), ("mask", 1)]):
        frames = _clip(40 + i)
        vip = _overlay(96, 128, shape) if shape else None
        out.append({"id": f"v{i}", "frames": frames, "question": f"What is marked {i}?",
                    "vip_overlay": vip, "key_idx": key, "shape": shape or "rectangle"})
    return out


@pytest.mark.parametrize("use_stom", [True, False])
@pytest.mark.parametrize("batch_size", [1, 2])
def test_run_inference_matches_jax(tmp_path, monkeypatch, batch_size, use_stom):
    monkeypatch.setattr(jstom, "default_tracker", lambda: StubTracker(11))
    monkeypatch.setattr(tstom, "default_tracker", lambda device=None: StubTracker(11))
    items = _items()
    runs = {}
    for name, mod in (("jax", jvi), ("port", tvi)):
        chat, path = RecordingChat(), str(tmp_path / f"{name}.jsonl")
        with open(path, "w") as f:  # the first item is done already
            f.write(json.dumps({"id": "v0", "pred": "earlier"}) + "\n")
        kw = {} if name == "jax" else {"device": "cpu"}
        n = mod.run_inference(chat, items, path, use_stom=use_stom, batch_size=batch_size, **kw)
        with open(path) as f:
            lines = [json.loads(x) for x in f]
        runs[name] = (n, chat.calls, lines)
    (nj, cj, lj), (nt, ct, lt) = runs["jax"], runs["port"]
    assert nj == nt == 4 and lj == lt and [d["id"] for d in lt] == ["v0", "v1", "v2", "v3", "v4"]
    assert [q for q, _ in ct] == [q for q, _ in cj]
    assert ct[0][0] == "Look at the marked region and then answer the question. What is marked 1?"
    for (_, fj), (_, ft) in zip(cj, ct):
        assert len(fj) == len(ft) and all(np.array_equal(a, b) for a, b in zip(fj, ft))
    changed = sum(not np.array_equal(a, b) for a, b in zip(ct[0][1], items[1]["frames"]))
    assert changed == (5 if use_stom else 1)
    # a second run finds every id done
    assert tvi.run_inference(RecordingChat(), items, str(tmp_path / "port.jsonl"),
                             use_stom=use_stom, batch_size=batch_size, device="cpu") == 0

"""The port's synthetic tracking curriculum (`rga3_tpu_torch/models/stom/synth.py`)
against the JAX package's, byte for byte: every generator from the same
`np.random.Generator` seed gives equal arrays (and leaves the generator in
the same state), the two scoring suites give equal reports for one fixed
fake tracker, and the packaged photo is matplotlib's file.
"""
import filecmp
import os
import sys

import numpy as np
import pytest

from rga3_tpu.models.stom import synth as jsynth
from rga3_tpu_torch.models.stom import synth as tsynth


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _both(fn_name, seed, **kw):
    """fn_name of each package from one seed; the generators must end equal."""
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    a = getattr(jsynth, fn_name)(rj, **kw)
    b = getattr(tsynth, fn_name)(rt, **kw)
    assert rj.bit_generator.state == rt.bit_generator.state
    return a, b


def test_packaged_photo_is_matplotlibs():
    import matplotlib

    ref = os.path.join(os.path.dirname(matplotlib.__file__), "mpl-data", "sample_data",
                       "grace_hopper.jpg")
    assert filecmp.cmp(tsynth.PHOTO_PATH, ref, shallow=False)
    np.testing.assert_array_equal(tsynth._photo_bank(), jsynth._photo_bank())


def test_photo_texture_without_matplotlib(monkeypatch):
    """The port reads its own JPEG: importing matplotlib is not needed."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    tsynth._photo_bank.cache_clear()
    try:
        tex = tsynth._photo_texture(np.random.default_rng(0), 40, 56)
    finally:
        tsynth._photo_bank.cache_clear()
    assert tex.shape == (40, 56, 3) and tex.dtype == np.float32


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("size", [(24, 40), (700, 1400)], ids=["crop", "tiled"])
def test_textures(seed, size):
    """Noise and photo textures; the photo crop, and the mirror-tiled photo
    for a request larger than the photo (512 x 600)."""
    for fn in ("_smooth_noise", "_photo_texture"):
        a, b = _both(fn, seed, h=size[0], w=size[1])
        _equal([a], [b])


@pytest.mark.parametrize("seed", [0, 3])
def test_make_synthetic_batch(seed):
    a, b = _both("make_synthetic_batch", seed, t=5, h=48, w=40, n_points=7)
    _equal(a, b)


@pytest.mark.parametrize("case", tsynth.BENCH_CASES)
@pytest.mark.parametrize("seed", [1000, 1001])
def test_make_synthetic_case(case, seed):
    a, b = _both("make_synthetic_case", seed, case=case, t=8, h=64, w=64, n_points=16)
    _equal(a, b)


@pytest.mark.parametrize("texture", ["noise", "photo"])
@pytest.mark.parametrize("seed", [0, 5, 11])
def test_make_training_clip(texture, seed):
    a, b = _both("make_training_clip", seed, t=6, h=48, w=64, n_points=20, texture=texture)
    _equal(a, b)


def test_make_training_clip_serving_size_and_mixed():
    """At 160 x 224 with the CLI's draw of a mixed texture: the JAX script's
    `make_clip` and the port's over the producer's stream (seed 0)."""
    from types import SimpleNamespace

    from rga3_tpu_torch.tools.train_cotracker import make_clip

    args = SimpleNamespace(textures="mixed", frames=8, points=16, max_speed=8.0,
                           occluder_prob=0.7, speed_exponent=1.0)
    rj, rt = np.random.default_rng(0), np.random.default_rng(0)
    kinds = []
    for _ in range(4):
        kind = "photo" if rj.random() < 0.5 else "noise"
        kinds.append(kind)
        f, q, g, v = jsynth.make_training_clip(rj, t=8, h=160, w=224, n_points=16,
                                               max_speed=8.0, occluder_prob=0.7,
                                               speed_exponent=1.0, texture=kind)
        ref = (np.clip(f * 255.0 + 0.5, 0, 255).astype(np.uint8), q, g, v)
        _equal(ref, make_clip(args, rt, 160, 224))
    assert rj.bit_generator.state == rt.bit_generator.state
    assert set(kinds) == {"photo", "noise"}


def _fake_tracker(frames_u8, pts0, qidx):
    """Drifts each point by a step that depends on the frame's mean level,
    so the report depends on the frames."""
    drift = np.asarray([f.mean() / 255.0 for f in frames_u8], np.float32)
    return pts0[None] + np.cumsum(drift)[:, None, None] * np.asarray([1.0, -0.5], np.float32)


def test_benchmark_tracker_reports():
    assert tsynth.benchmark_tracker(_fake_tracker) == jsynth.benchmark_tracker(_fake_tracker)


@pytest.mark.parametrize("texture", ["noise", "photo"])
def test_benchmark_tracker_serving_reports(texture):
    got = tsynth.benchmark_tracker_serving(_fake_tracker, seeds=(0, 1, 2), texture=texture)
    assert got == jsynth.benchmark_tracker_serving(_fake_tracker, seeds=(0, 1, 2),
                                                   texture=texture)
    assert got["resolution"] == "160x224" and np.isfinite(got["stayput_px_err"])

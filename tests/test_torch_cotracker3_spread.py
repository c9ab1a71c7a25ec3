"""The port's whole CoTracker3 on the repo's trained weights
(`cotracker3_small.npz`) at the file's compute dtype (bf16), point by point
against the jitted JAX reference, within the reference's own rounding
spread, on the CPU.

The spread is the distance between the reference's jitted forward and the
same forward op by op (`jax.disable_jit()`) on the same clip: XLA's jit
keeps some bf16 intermediates at f32 and sums in its own order, so the two
programs of one model differ by a bf16 rounding's worth. The port runs its
ops one by one as well, with its own summation order; it has to land no
further from the jitted reference than 1.25 times that spread, and flip
at most twice as many visibility flags plus one:

  * one refinement iteration: the mean and the largest track difference
    and the vis / conf logits;
  * the file's four iterations: the mean track difference and the
    visibility flags. The refinement multiplies a rounding difference many
    times over (the flow embedding runs at up to ~1000 rad a grid pixel),
    so one clip's largest difference and its logits are too noisy there
    to hold a port to; they are printed.

This holds the port inside the reference's rounding spread; it does not
tell a bf16 forward from an f32 one, whose distance is the same (it is
printed beside the others under `-s`). The rounding points themselves are
held one module at a time by `test_torch_cotracker3_bf16.py`.
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
from rga3_tpu_torch.models.stom import cotracker3 as tct

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "rga3_tpu", "models", "stom", "weights", "cotracker3_small.npz")
CLIP_SEEDS = (5000, 5001, 5002)
FACTOR = 1.25  # the port's distance to the jitted reference, over the reference's own


def _visible(out):
    p = 0.5 * (1 + np.tanh(0.5 * out["vis"])) * 0.5 * (1 + np.tanh(0.5 * out["conf"]))
    return p > 0.6


def _distance(a, b):
    """(mean, max) |track difference| of the last iteration in input px,
    max |logit difference| / max |logit|, and the visibility flags that
    differ."""
    d = np.abs(a["tracks"][-1] - b["tracks"][-1])
    logit = max(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max() for k in ("vis", "conf"))
    return float(d.mean()), float(d.max()), float(logit), int((_visible(a) != _visible(b)).sum())


@pytest.mark.parametrize("iters", [1, 4])
def test_shipped_tracker_bf16_within_reference_spread(iters):
    params, cfg = jct.load_cotracker3(WEIGHTS)
    model, _ = tct.load_cotracker3(WEIGHTS, device="cpu")
    assert cfg.compute_dtype == "bfloat16"
    jm = jct.CoTracker3Offline(dataclasses.replace(cfg, iters=iters))
    apply = jax.jit(jm.apply)
    ports = {}
    for name, dtype in (("port", "bfloat16"), ("f32 port", "float32")):
        ports[name] = tct.CoTracker3Offline(model.cfg.replace(iters=iters, compute_dtype=dtype))
        ports[name].load_state_dict(model.state_dict(), strict=True)
        ports[name].eval()
    for seed in CLIP_SEEDS:
        frames, queries, _, _ = synth.make_training_clip(np.random.default_rng(seed))
        video = (frames * 255.0).astype(np.float32)
        q = np.asarray(queries, np.float32)
        jitted = jax.tree.map(np.asarray, apply(params, jnp.asarray(video), jnp.asarray(q)))
        with jax.disable_jit():
            eager = jax.tree.map(np.asarray, jm.apply(params, jnp.asarray(video), jnp.asarray(q)))
        got = {}
        with torch.inference_mode():
            for name, m in ports.items():
                out = m(torch.from_numpy(video), torch.from_numpy(q))
                got[name] = {k: v.float().numpy() for k, v in out.items()}
        spread = _distance(eager, jitted)
        dist = _distance(got["port"], jitted)
        show = "{:.4g} / {:.4g} px, logits {:.3g}, {} flips".format
        print(f"clip {seed}, {iters} iteration(s), to the jitted reference (track mean / max, "
              f"logits / max |logit|, visibility flips of {q.shape[0] * video.shape[0]}): "
              f"op by op {show(*spread)}; port {show(*dist)}; "
              f"f32 port {show(*_distance(got['f32 port'], jitted))}")
        assert got["port"]["tracks"].shape == jitted["tracks"].shape
        assert np.isfinite(got["port"]["tracks"]).all()
        gated = ("track mean", "track max", "logits") if iters == 1 else ("track mean",)
        for k, name in enumerate(gated):
            assert dist[k] <= FACTOR * spread[k], (seed, name, dist, spread)
        assert dist[3] <= 2 * spread[3] + 1, (seed, "visibility", dist, spread)

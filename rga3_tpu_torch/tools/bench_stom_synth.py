"""Score a STOM tracker backend on the synthetic suites of
`models/stom/synth.py` (the port of the JAX package's
`scripts/bench_stom_synth.py`): tracking error in pixels against ground
truth, not device time.

    python -m rga3_tpu_torch.tools.bench_stom_synth --backend lk
    python -m rga3_tpu_torch.tools.bench_stom_synth --backend lite --ckpt ct_lite.npz
    python -m rga3_tpu_torch.tools.bench_stom_synth --backend cotracker3 --tiny --ckpt ct3.npz
    python -m rga3_tpu_torch.tools.bench_stom_synth --weights ct3_official.npz --suite serving

Suites: fixed (smooth / large-motion / occlusion clips at --size^2, fixed
seeds; px error over visible points and the stay-put baseline), serving
(layered parallax clips at 160x224, slow / fast / hidden-point error),
serving-photo (the same geometry with photo textures). Backends: lk (OpenCV
on the host), lite and cotracker3 (random weights from seed 0 unless
--ckpt), shipped (a self-describing CoTracker3 file, --weights or the repo's
trained one; LK, with a note on stderr, when there is none). Prints one
JSON line; `main(argv)` also returns it as a dict. The networks run on the
card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import torch

from ..device import resolve_device
from ..models.stom.synth import benchmark_tracker, benchmark_tracker_serving


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--backend", choices=["lk", "lite", "cotracker3", "shipped"],
                   default="shipped",
                   help="shipped = the repo's trained CoTracker3 weights (STOM's default "
                   "backend), LK if the weight file is absent")
    p.add_argument("--ckpt", default=None,
                   help="trained parameters (a save_params npz); random init without it")
    p.add_argument("--weights", default=None,
                   help="a self-describing CoTracker3 npz for the shipped backend")
    p.add_argument("--tiny", action="store_true", help="tiny net (train_cotracker --tiny's)")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--points", type=int, default=16)
    p.add_argument("--suite", choices=["fixed", "serving", "serving-photo"], default="fixed")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    return p.parse_args(argv)


def build_backend(args):
    """The backend `args` names (`args.backend` becomes "lk" where shipped
    weights are missing)."""
    from ..models.stom.tracker import LKTracker

    if args.backend == "shipped":
        from ..models.stom.cotracker3 import shipped_tracker

        backend = shipped_tracker(path=args.weights, device=args.device,
                                  max_points=args.points)
        if backend is not None:
            return backend
        print("# no shipped weights; falling back to lk", file=sys.stderr)
        args.backend = "lk"
    if args.backend == "lk":
        return LKTracker()
    dev = resolve_device(args.device)
    gen = torch.Generator(dev).manual_seed(0)
    if args.backend == "lite":
        from ..models.stom.cotracker import (
            CoTrackerLite, CoTrackerLitePredictor, load_params, tiny_lite,
        )

        model = (tiny_lite() if args.tiny else CoTrackerLite()).to(dev)
        model.init_weights(gen)
        if args.ckpt:
            load_params(args.ckpt, model)
        return CoTrackerLitePredictor(model.eval(), device=dev)
    from ..models.stom.cotracker import load_params
    from ..models.stom.cotracker3 import (
        CoTracker3Offline, CoTracker3Predictor, cotracker3_offline_config,
        tiny_cotracker3_config,
    )

    cfg = tiny_cotracker3_config() if args.tiny else cotracker3_offline_config()
    model = CoTracker3Offline(cfg.replace(model_resolution=(args.size, args.size))).to(dev)
    model.init_weights(gen)
    if args.ckpt:
        load_params(args.ckpt, model)
    return CoTracker3Predictor(model.eval(), device=dev, max_points=args.points)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    backend = build_backend(args)

    def track_fn(frames_u8, pts0, qidx):
        tracks, _vis = backend.track_points(list(frames_u8), pts0, qidx)
        return tracks

    if args.suite in ("serving", "serving-photo"):
        report = benchmark_tracker_serving(
            track_fn, t=args.frames, n_points=args.points,
            texture="photo" if args.suite == "serving-photo" else "noise")
    else:
        report = benchmark_tracker(track_fn, t=args.frames, size=args.size,
                                   n_points=args.points)
    result = {"backend": args.backend, "ckpt": bool(args.ckpt), "tiny": args.tiny,
              "suite": args.suite, **report}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

"""Train STOM's point tracker on synthetic motion (`models/stom/synth.py`):
the port of the JAX package's `scripts/train_cotracker.py`.

    python -m rga3_tpu_torch.tools.train_cotracker --steps 2000 --out cotracker_lite.npz
    python -m rga3_tpu_torch.tools.train_cotracker --curriculum layered \\
        --arch cotracker3 --preset official --size 160 --width 224 --bf16 \\
        --train-iters 4 --batch 8 --textures mixed --out ct3_official.npz

Two curricula:

  * flat (default): one similarity-warped noise texture a clip, always
    visible, one clip a step; CoTrackerLite (`--arch lite`, `save_params`
    file) or CoTracker3 (`--arch cotracker3`, at the clip's resolution);
    AdamW without clipping; a held-out error against the stay-put baseline
    at the end;
  * layered (`--arch cotracker3` only): background, independently moving
    sprites and an occluder with exact visibility (`make_training_clip`),
    `--batch` clips a step sampled from a replay pool that a producer thread
    fills; per-iteration Huber weighted gamma^(I-1-i) on every point, BCE on
    the visibility logits, and CoTracker's confidence target (the last
    iteration within `conf_thr` px, without gradient) on the confidence
    logits; clipping by global norm 1. It scores the fixed suite at the end
    and writes a self-describing `save_cotracker3` file (`--resume` reads
    one, or a `save_params` file, into the preset's model).

The optimizer is optax's `adamw(warmup_cosine_decay_schedule(0, lr, warmup,
steps), weight_decay=1e-5)` (`train.optimizer.MaskedAdamW`): the first
update uses count 0, so its learning rate is 0. The layered run's batches
depend on thread timing, as the JAX script's do: the producer's clip stream
(seed 0) is fixed, which clips the pool holds at each draw is not; the
first batch waits until the pool holds `pool_size // 2` clips.

Runs on the card unless `--device cpu`. `main(argv)` returns a summary: the
model, the per-step losses, aux errors, seconds, waits on the pool and fresh
clips, and the final report.
"""
from __future__ import annotations

import argparse
import json
import math
import queue as queue_mod
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import TrainConfig
from ..device import resolve_device
from ..models.stom.cotracker import CoTrackerLite, load_params, save_params, tiny_lite
from ..models.stom.cotracker3 import (
    CoTracker3Config, CoTracker3Offline, CoTracker3Predictor, cotracker3_offline_config,
    cotracker3_small_config, save_cotracker3, tiny_cotracker3_config,
)
from ..models.stom.synth import benchmark_tracker, make_synthetic_batch, make_training_clip
from ..train.optimizer import MaskedAdamW, warmup_cosine_schedule

PRESETS = {"tiny": tiny_cotracker3_config, "small": cotracker3_small_config,
           "official": cotracker3_offline_config}


def _bce_ones(logits: torch.Tensor) -> torch.Tensor:
    """Mean BCE of logits against target 1, numerically stable."""
    return (logits.clamp_min(0) - logits + torch.log1p(torch.exp(-logits.abs()))).mean()


def _huber(err: torch.Tensor) -> torch.Tensor:
    return torch.where(err.abs() < 4.0, 0.5 * err ** 2, 4.0 * (err.abs() - 2.0))


def _bce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean BCE of logits against {0, 1} targets, numerically stable."""
    return (logits.clamp_min(0) - logits * target + torch.log1p(torch.exp(-logits.abs()))).mean()


def _iteration_weights(iters: int, gamma: float, device) -> torch.Tensor:
    """gamma^(I-1-i), i = 0..I-1: later refinement iterations weigh more."""
    return gamma ** torch.arange(iters - 1, -1, -1, dtype=torch.float32, device=device)


def make_optimizer(model: torch.nn.Module, lr: float, steps: int, warmup: int,
                   clip: Optional[float]) -> MaskedAdamW:
    """optax's `adamw(warmup_cosine_decay_schedule(0, lr, warmup, steps),
    weight_decay=1e-5)` over every parameter, after
    `clip_by_global_norm(clip)` when `clip` is given."""
    cfg = TrainConfig(lr=lr, beta1=0.9, beta2=0.999, weight_decay=1e-5,
                      grad_clip=math.inf if clip is None else clip, adam_mu_dtype="float32")
    return MaskedAdamW(cfg, model, schedule=warmup_cosine_schedule(lr, warmup, steps - warmup))


def flat_loss(model: torch.nn.Module, arch: str, frames, queries, gt, gamma: float = 0.8):
    """(loss, position loss of the last iteration) on one clip: frames (T,
    H, W, 3) in [0, 1]. CoTracker3 (fed [0, 255]) is supervised at every
    refinement iteration, weighted gamma^(I-1-i), its vis and conf logits
    against 1; Lite's tracks and vis logits likewise at its output."""
    if arch == "cotracker3":
        out = model(frames * 255.0, queries)
        tracks = out["tracks"]  # (I, T, N, 2)
        w = _iteration_weights(tracks.shape[0], gamma, tracks.device)
        per_iter = _huber(tracks - gt[None]).mean(dim=(1, 2, 3))
        pos_loss = (w * per_iter).sum() / w.sum()
        vis_loss = _bce_ones(out["vis"]) + _bce_ones(out["conf"])
        return pos_loss + 0.1 * vis_loss, per_iter[-1].detach()
    tracks, vis = model(frames, queries)
    pos_loss = _huber(tracks - gt).mean()
    return pos_loss + 0.1 * _bce_ones(vis), pos_loss.detach()


def occl_loss(model: CoTracker3Offline, frames, queries, gt, vis_gt, gamma: float = 0.8,
              conf_thr: float = 6.0):
    """(loss, (visible px error, hidden px error)) on a batch of layered
    clips: frames (B, T, H, W, 3) uint8, queries (B, N, 3), gt (B, T, N, 2),
    vis_gt (B, T, N) bool. Huber on every point at every iteration
    (hidden points too: supervising them through occlusion teaches the
    whole-clip attention to re-acquire them), BCE of the vis logits against
    the true visibility, of the conf logits against the last iteration
    lying within `conf_thr` px. The aux errors are the last iteration's."""
    out = model(frames, queries)
    tracks = out["tracks"]  # (B, I, T, N, 2)
    w = _iteration_weights(tracks.shape[1], gamma, tracks.device)
    per_iter = _huber(tracks - gt[:, None]).mean(dim=(0, 2, 3, 4))
    pos_loss = (w * per_iter).sum() / w.sum()
    visf = vis_gt.float()
    vis_loss = _bce(out["vis"], visf)
    dist = torch.linalg.norm(tracks[:, -1] - gt, dim=-1)  # (B, T, N)
    close = (dist < conf_thr).float().detach()
    conf_loss = _bce(out["conf"], close)
    with torch.no_grad():
        vis_px = (dist * visf).sum() / visf.sum().clamp_min(1)
        hidf = 1.0 - visf
        hid_px = (dist * hidf).sum() / hidf.sum().clamp_min(1)
    return pos_loss + 0.1 * (vis_loss + conf_loss), (vis_px, hid_px)


def _train_step(loss_fn: Callable, opt: MaskedAdamW) -> Callable:
    def step(*batch):
        loss, aux = loss_fn(*batch)
        loss.backward()
        opt.step()
        opt.zero_grad()
        return loss.detach(), aux

    return step


def build_train_step(model, opt: MaskedAdamW, arch: str = "lite", gamma: float = 0.8):
    """step(frames, queries, gt) -> (loss, position loss): one update of the
    flat curriculum's objective (`flat_loss`)."""
    return _train_step(lambda f, q, g: flat_loss(model, arch, f, q, g, gamma), opt)


def build_train_step_occl(model, opt: MaskedAdamW, gamma: float = 0.8, conf_thr: float = 6.0):
    """step(frames, queries, gt, vis) -> (loss, (vis_px, hid_px)): one update
    of the layered curriculum's objective (`occl_loss`)."""
    return _train_step(lambda f, q, g, v: occl_loss(model, f, q, g, v, gamma, conf_thr), opt)


def layered_config(args) -> CoTracker3Config:
    """The preset's CoTracker3 (`--tiny` the tiny one) at the clips' size
    (`--size` x `--width`, else the preset's model resolution), with
    `--train-iters` refinement iterations and bf16 compute under `--bf16`."""
    cfg = tiny_cotracker3_config() if args.tiny else PRESETS[args.preset]()
    h, w = cfg.model_resolution
    if args.size:
        h, w = args.size, args.width or args.size
    return cfg.replace(model_resolution=(h, w), iters=args.train_iters or cfg.iters,
                       compute_dtype="bfloat16" if args.bf16 else cfg.compute_dtype)


def make_clip(args, rng: np.random.Generator, h: int, w: int):
    """One layered clip of `--textures` (mixed: photo or noise, 50/50 a
    clip), its frames as uint8."""
    tex = args.textures
    if tex == "mixed":
        tex = "photo" if rng.random() < 0.5 else "noise"
    f, q, g, v = make_training_clip(
        rng, t=args.frames, h=h, w=w, n_points=args.points, max_speed=args.max_speed,
        occluder_prob=args.occluder_prob, speed_exponent=args.speed_exponent, texture=tex)
    return np.clip(f * 255.0 + 0.5, 0, 255).astype(np.uint8), q, g, v


class ClipPool:
    """A replay pool of clips that a producer thread fills from
    `make(rng)`: each `next_batch` takes every clip the producer has ready
    (blocking only while the pool holds fewer than `pool_size // 2`), then
    samples `batch` of the pool. `fresh` counts the clips taken in;
    `close` stops and joins the producer."""

    def __init__(self, make: Callable, rng: np.random.Generator, pool_size: int, batch: int):
        self.pool: List = []
        self.pool_size, self.batch = pool_size, batch
        self.fresh = 0
        self._q: "queue_mod.Queue" = queue_mod.Queue(maxsize=8)
        self._stop = threading.Event()
        self._error: List[BaseException] = []
        self._thread = threading.Thread(target=self._produce, args=(make, rng), daemon=True)
        self._thread.start()

    def _produce(self, make, rng):
        try:
            while not self._stop.is_set():
                clip = make(rng)
                while not self._stop.is_set():
                    try:
                        self._q.put(clip, timeout=1.0)
                        break
                    except queue_mod.Full:
                        continue
        except Exception as e:  # handed to the consumer, which raises it
            self._error.append(e)

    def next_batch(self, rng: np.random.Generator):
        """(frames, queries, gt, vis), each stacked over the batch."""
        while True:
            if self._error:
                raise RuntimeError("the clip producer failed") from self._error[0]
            try:
                clip = self._q.get(block=len(self.pool) < self.pool_size // 2, timeout=1.0)
            except queue_mod.Empty:
                if len(self.pool) < self.pool_size // 2:
                    continue
                break
            self.fresh += 1
            if len(self.pool) < self.pool_size:
                self.pool.append(clip)
            else:
                self.pool[int(rng.integers(len(self.pool)))] = clip
        idx = rng.choice(len(self.pool), size=self.batch, replace=len(self.pool) < self.batch)
        return tuple(np.stack(x) for x in zip(*(self.pool[i] for i in idx)))

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=60)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def to_device(dev, *arrays) -> Sequence[torch.Tensor]:
    """Numpy arrays (a batch) as tensors on `dev`."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def build_layered(args, device=None):
    """(model, cfg, optimizer, step) of the layered curriculum: the
    CoTracker3 of `layered_config(args)` on the device, from seed 0 at
    flax's initialiser scales or `--resume`d, and its train step."""
    dev = resolve_device(args.device if device is None else device)
    cfg = layered_config(args)
    model = CoTracker3Offline(cfg).to(dev)
    model.init_weights(torch.Generator(dev).manual_seed(0))
    if args.resume:
        load_params(args.resume, model)
        print(f"resumed from {args.resume}", flush=True)
    opt = make_optimizer(model, args.lr, args.steps, min(200, args.steps // 10 + 1), clip=1.0)
    # conf target: within 12 px at CoTracker's 384-row training resolution, scaled
    h = cfg.model_resolution[0]
    step = build_train_step_occl(model, opt, conf_thr=max(12.0 * h / 384.0, 3.0))
    return model, cfg, opt, step


def train_layered(args) -> Dict:
    """CoTracker3 on the layered occlusion curriculum (see the module
    docstring). Returns the summary."""
    if args.arch != "cotracker3":
        raise ValueError("--curriculum layered needs --arch cotracker3")
    dev = resolve_device(args.device)
    model, cfg, opt, step = build_layered(args, dev)
    h, w = cfg.model_resolution
    n_params = sum(p.numel() for p in model.parameters())
    print(f"cotracker3 {n_params / 1e6:.1f}M params, res ({h},{w}), iters {cfg.iters}, "
          f"batch {args.batch}", flush=True)

    out = {"model": model, "cfg": cfg, "step": step, "losses": [], "aux": [], "step_s": [],
           "wait_s": [], "fresh": []}
    sample_rng = np.random.default_rng(7)
    t0 = time.time()
    with ClipPool(lambda rng: make_clip(args, rng, h, w), np.random.default_rng(0),
                  max(args.pool_size, 2 * args.batch), args.batch) as pool:
        for i in range(args.steps):
            t1 = time.perf_counter()
            fresh = pool.fresh
            batch = pool.next_batch(sample_rng)
            t2 = time.perf_counter()
            loss, (vis_px, hid_px) = step(*to_device(dev, *batch))
            loss, vis_px, hid_px = float(loss), float(vis_px), float(hid_px)
            out["step_s"].append(time.perf_counter() - t2)
            out["wait_s"].append(t2 - t1)
            out["fresh"].append(pool.fresh - fresh)
            out["losses"].append(loss)
            out["aux"].append((vis_px, hid_px))
            out["batch"] = batch
            if i % 25 == 0 or i == args.steps - 1:
                print(f"step {i}: loss {loss:.4f} vis_px {vis_px:.2f} hid_px {hid_px:.2f} "
                      f"pool {len(pool.pool)} fresh {pool.fresh} ({time.time() - t0:.0f}s)",
                      flush=True)
            if args.save_every and ((i + 1) % args.save_every == 0 or i == args.steps - 1):
                save_cotracker3(args.out, model, cfg)
                print(f"saved {args.out} @ step {i}", flush=True)

    # the fixed suite (bench_stom_synth's default)
    pred = CoTracker3Predictor(model, device=dev)
    out["report"] = benchmark_tracker(lambda f, p, i: pred.track_points(f, p, i)[0])
    print("bench_stom_synth:", json.dumps(out["report"]), flush=True)
    save_cotracker3(args.out, model, cfg)
    print(f"saved {args.out}", flush=True)
    return out


def train_flat(args) -> Dict:
    """The flat curriculum (see the module docstring). Returns the summary."""
    dev = resolve_device(args.device)
    size = args.size or 64
    if args.arch == "cotracker3":
        cfg = tiny_cotracker3_config() if args.tiny else cotracker3_offline_config()
        # track at the clip's own resolution (no resize blur)
        model = CoTracker3Offline(cfg.replace(model_resolution=(size, size)))
    else:
        model = tiny_lite() if args.tiny else CoTrackerLite()
    model = model.to(dev)
    model.init_weights(torch.Generator(dev).manual_seed(0))
    rng = np.random.default_rng(0)
    # the JAX script initialises its parameters from a first clip of this stream
    make_synthetic_batch(rng, t=args.frames, h=size, w=size, n_points=args.points)
    opt = make_optimizer(model, args.lr, args.steps, min(100, args.steps // 10 + 1), clip=None)
    step = build_train_step(model, opt, arch=args.arch)

    out = {"model": model, "losses": [], "pos": [], "step_s": []}
    t0 = time.time()
    for i in range(args.steps):
        batch = make_synthetic_batch(rng, t=args.frames, h=size, w=size, n_points=args.points)
        t1 = time.perf_counter()
        loss, pos = step(*to_device(dev, *batch))
        loss, pos = float(loss), float(pos)
        out["step_s"].append(time.perf_counter() - t1)
        out["losses"].append(loss)
        out["pos"].append(pos)
        if i % 50 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {loss:.4f} pos {pos:.4f} ({time.time() - t0:.0f}s)",
                  flush=True)

    # held-out tracking error (fresh motions, fresh textures) vs stay-put
    eval_rng = np.random.default_rng(12345)
    errs, base = [], []
    for _ in range(8):
        frames, queries, gt = make_synthetic_batch(eval_rng, t=args.frames, h=size, w=size,
                                                   n_points=args.points)
        f, q = to_device(dev, frames, queries)
        with torch.inference_mode():
            if args.arch == "cotracker3":
                tracks = model(f * 255.0, q)["tracks"][-1]
            else:
                tracks = model(f, q)[0]
        errs.append(np.linalg.norm(tracks.cpu().numpy() - gt, axis=-1).mean())
        base.append(np.linalg.norm(gt - gt[0][None], axis=-1).mean())
    out["held_out_px"], out["stayput_px"] = float(np.mean(errs)), float(np.mean(base))
    print(f"held-out error {np.mean(errs):.2f} px (stay-put baseline {np.mean(base):.2f} px)")
    save_params(args.out, model)
    print(f"saved {args.out} ({sum(p.numel() for p in model.parameters())} params)")
    return out


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--size", type=int, default=0,
                   help="clip height (layered: 0 = the preset's model_resolution; flat: 0 = 64)")
    p.add_argument("--width", type=int, default=0, help="clip width (0 = square --size clips)")
    p.add_argument("--points", type=int, default=16)
    p.add_argument("--out", default="cotracker_lite.npz")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--arch", choices=["lite", "cotracker3"], default="lite")
    p.add_argument("--curriculum", choices=["flat", "layered"], default="flat",
                   help="flat = one similarity-warped texture (always visible); layered = "
                   "background + independently moving sprites + occluders with true visibility "
                   "labels (synth.make_training_clip)")
    p.add_argument("--preset", choices=["tiny", "small", "official"], default="small",
                   help="cotracker3 dims for the layered curriculum: tiny, small (the shipped "
                   "weights' config, res 160x224), official (scaled_offline.pth dims, res 384x512)")
    p.add_argument("--pool-size", type=int, default=512,
                   help="clip replay pool (layered): the producer thread streams fresh clips in, "
                   "each step samples its batch from the pool")
    p.add_argument("--batch", type=int, default=1, help="clips a step (layered only)")
    p.add_argument("--train-iters", type=int, default=0,
                   help="refinement iterations in training (0 = the config's)")
    p.add_argument("--bf16", action="store_true", help="compute_dtype bfloat16 (params stay f32)")
    p.add_argument("--occluder-prob", type=float, default=0.7)
    p.add_argument("--max-speed", type=float, default=8.0)
    p.add_argument("--speed-exponent", type=float, default=1.0,
                   help="<1 biases clip speeds toward --max-speed")
    p.add_argument("--textures", choices=["noise", "photo", "mixed"], default="noise",
                   help="layer textures (layered): band-limited noise, photo crops, or a 50/50 "
                   "mix a clip")
    p.add_argument("--save-every", type=int, default=500, help="checkpoint cadence (layered)")
    p.add_argument("--resume", default="",
                   help="start from the parameters of an npz (layered)")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    return p.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    if args.curriculum == "layered":
        return train_layered(args)
    return train_flat(args)


if __name__ == "__main__":
    main()

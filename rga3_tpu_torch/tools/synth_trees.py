"""Synthetic benchmark trees in the published layouts, made from a seed,
for driving the benchmark drivers without the datasets (the tests and
`chip_smoke.py`).

`write_vos_tree` writes one referring-VOS tree: videos of moving filled
ellipses over noise as JPEG frames, the ellipses' masks as the ground truth
(COCO RLEs by `utils.rle`) and expressions that name one or two of them, in
the MeViS, ReVOS, ReasonVOS or Ref-YTVOS layout. `write_reason_seg_tree`
writes ReasonSeg images with labelme polygon annotations (a target and an
"ignore" shape each).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from ..utils import rle

LAYOUTS = ("mevis", "revos", "reasonvos", "ytvos")
COLOURS = ("red", "green", "blue", "yellow", "white", "purple")


def ellipse_mask(h: int, w: int, cy: float, cx: float, ry: float, rx: float) -> np.ndarray:
    y, x = np.ogrid[:h, :w]
    return ((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2 <= 1.0


def synth_video(rng: np.random.Generator, n_frames: int, h: int, w: int, n_objects: int):
    """(uint8 (T, H, W, 3) frames, bool (O, T, H, W) masks): ellipses of
    fixed colours moving on straight paths over noise, later ones on top."""
    frames = rng.integers(0, 96, (n_frames, h, w, 3), dtype=np.uint8)
    masks = np.zeros((n_objects, n_frames, h, w), bool)
    rgb = np.array([[220, 40, 40], [40, 200, 60], [50, 70, 230], [230, 220, 40],
                    [240, 240, 240], [160, 50, 200]], np.uint8)
    for o in range(n_objects):
        ry, rx = rng.uniform(0.08, 0.2) * h, rng.uniform(0.08, 0.2) * w
        start = rng.uniform([ry, rx], [h - ry, w - rx])
        end = rng.uniform([ry, rx], [h - ry, w - rx])
        for t in range(n_frames):
            cy, cx = start + (end - start) * t / max(n_frames - 1, 1)
            masks[o, t] = ellipse_mask(h, w, cy, cx, ry, rx)
            frames[t][masks[o, t]] = rgb[o % len(rgb)]
    return frames, masks


def _save_jpegs(frames: np.ndarray, names: List[str], d: str) -> None:
    from PIL import Image

    os.makedirs(d, exist_ok=True)
    for name, f in zip(names, frames):
        Image.fromarray(f).save(os.path.join(d, f"{name}.jpg"))


def write_vos_tree(root: str, layout: str = "mevis", split: str = "valid_u", seed: int = 0,
                   n_videos: int = 1, n_frames: int = 4, size=(48, 64), n_objects: int = 3,
                   n_expressions: int = 4) -> Dict[str, str]:
    """Write a referring-VOS tree under `root` in `layout` (one of LAYOUTS);
    returns {"data_root", "split", "frames_root"}. Expression e names object
    e % n_objects, and every third expression also the next object."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} is not one of {LAYOUTS}")
    rng = np.random.default_rng(seed)
    h, w = size
    if layout in ("revos", "reasonvos"):
        frames_root, ann_dir = os.path.join(root, "JPEGImages"), root
    else:
        frames_root = os.path.join(root, split, "JPEGImages")
        ann_dir = (os.path.join(root, "meta_expressions", split) if layout == "ytvos"
                   else os.path.join(root, split))
    mask_dict, fore_dict, videos = {}, {}, {}
    names = [f"{i:05d}" for i in range(n_frames)]
    for v in range(n_videos):
        vid = f"vid{v:03d}"
        frames, masks = synth_video(rng, n_frames, h, w, n_objects)
        _save_jpegs(frames, names, os.path.join(frames_root, vid))
        for o in range(n_objects):
            mask_dict[f"{v}{o}"] = [rle.encode(m.astype(np.uint8)) for m in masks[o]]
        fore_dict[vid] = {"masks_rle": [rle.encode(m.astype(np.uint8)) for m in masks.any(0)]}
        exps = {}
        for e in range(n_expressions):
            objs = [e % n_objects] + ([(e + 1) % n_objects] if e % 3 == 2 else [])
            text = " and ".join(f"the {COLOURS[o % len(COLOURS)]} ellipse" for o in objs)
            if layout == "revos" and e % 2:
                text = f"which one moves like {text}?"
            exps[str(e)] = {"exp": text, "anno_id": [f"{v}{o}" for o in objs],
                            "type_id": e % 2}
        if layout == "reasonvos":
            exps = [{"obj_id": f"{v}{e % n_objects}", "exp_id": e,
                     "exp_text": exps[str(e)]["exp"], "is_sent": bool(e % 2)}
                    for e in range(n_expressions)]
            videos[vid] = {"source": "synth", "frames": names, "expressions": exps}
        else:
            videos[vid] = {"frames": names, "expressions": exps}
    os.makedirs(ann_dir, exist_ok=True)
    meta = {"revos": f"meta_expressions_{split}_.json"}.get(layout, "meta_expressions.json")
    with open(os.path.join(ann_dir, meta), "w") as f:
        json.dump({"videos": videos}, f)
    gt_dir = root if layout == "revos" else os.path.join(root, split)
    os.makedirs(gt_dir, exist_ok=True)
    with open(os.path.join(gt_dir, "mask_dict.json"), "w") as f:
        json.dump(mask_dict, f)
    if layout == "revos":
        with open(os.path.join(gt_dir, "mask_dict_foreground.json"), "w") as f:
            json.dump(fore_dict, f)
    return {"data_root": root, "split": split, "frames_root": frames_root}


def write_reason_seg_tree(root: str, split: str = "val", seed: int = 0, n_images: int = 4,
                          size=(48, 64)) -> str:
    """ReasonSeg layout: <root>/reason_seg/ReasonSeg/<split>/<name>.jpg and
    <name>.json (labelme: a target polygon around an ellipse, an "ignore"
    polygon, float points); returns the image directory."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = size
    d = os.path.join(root, "reason_seg", "ReasonSeg", split)
    os.makedirs(d, exist_ok=True)
    for i in range(n_images):
        frames, masks = synth_video(rng, 1, h, w, 2)
        Image.fromarray(frames[0]).save(os.path.join(d, f"{split}{i:03d}.jpg"))
        shapes = []
        for o, label in ((0, "target"), (1, "ignore")):
            ys, xs = np.nonzero(masks[o, 0])
            cy, cx = ys.mean(), xs.mean()
            ry, rx = (ys.max() - ys.min()) / 2 + 0.7, (xs.max() - xs.min()) / 2 + 0.7
            ang = np.sort(rng.uniform(0, 2 * np.pi, 12))
            shapes.append({"label": label, "points": np.stack(
                [cx + rx * np.cos(ang), cy + ry * np.sin(ang)], 1).tolist()})
        anno = {"shapes": shapes, "text": [f"the {COLOURS[0]} ellipse"], "is_sentence": False}
        with open(os.path.join(d, f"{split}{i:03d}.json"), "w") as f:
            json.dump(anno, f)
    return d

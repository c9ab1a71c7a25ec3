"""Synthetic benchmark and training trees in the published layouts, made
from a seed, for driving the benchmark drivers and the training entry point
without the datasets (the tests and `chip_smoke.py`).

`write_vos_tree` writes one referring-VOS tree: videos of moving filled
ellipses over noise as JPEG frames, the ellipses' masks as the ground truth
(COCO RLEs by `utils.rle`) and expressions that name one or two of them, in
the MeViS, ReVOS, ReasonVOS or Ref-YTVOS layout. `write_reason_seg_tree`
writes ReasonSeg images with labelme polygon annotations (a target and an
"ignore" shape each). `write_train_tree` writes the layout every training
dataset of `data.datasets.DATASET_REGISTRY` reads (and a ReasonSeg val
split), at the sizes it is given. `write_videoinfer_tree`,
`write_videorefer_tree` and `write_vipbench_tree` write the region-QA
benchmarks' layouts: VideoInfer's QA tree with RGBA prompt overlays,
VideoRefer-Bench-Q's question list with key-frame RLEs, and ViP-Bench's
question file with prompts drawn on the images.
"""
from __future__ import annotations

import json
import os
import pickle
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
            # the ellipse lies within its bounding box: test only that
            y0, y1 = max(int(np.floor(cy - ry)), 0), min(int(np.ceil(cy + ry)) + 1, h)
            x0, x1 = max(int(np.floor(cx - rx)), 0), min(int(np.ceil(cx + rx)) + 1, w)
            y, x = np.ogrid[y0:y1, x0:x1]
            inside = ((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2 <= 1.0
            masks[o, t, y0:y1, x0:x1] = inside
            frames[t, y0:y1, x0:x1][inside] = rgb[o % len(rgb)]
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
                          size=(48, 64), sentences: bool = False) -> str:
    """ReasonSeg layout: <root>/reason_seg/ReasonSeg/<split>/<name>.jpg and
    <name>.json (labelme: a target polygon around an ellipse, an "ignore"
    polygon, float points); with `sentences` every other image's text is a
    sentence (`is_sentence`). Returns the image directory."""
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
        sentence = sentences and i % 2 == 1
        text = (f"Which thing here is {COLOURS[0]} and round?" if sentence
                else f"the {COLOURS[0]} ellipse")
        anno = {"shapes": shapes, "text": [text], "is_sentence": sentence}
        with open(os.path.join(d, f"{split}{i:03d}.json"), "w") as f:
            json.dump(anno, f)
    return d


# ---------------------------------------------------------------------------
# region-QA benchmarks

# overlay colours of the region-QA writers (names and values of
# `data.visual_prompts.COLOR_POOL`)
PROMPT_COLOURS = {"red": (255, 0, 0), "lime": (0, 255, 0), "blue": (0, 0, 255),
                  "yellow": (255, 255, 0), "fuchsia": (255, 0, 255), "aqua": (0, 255, 255)}
VIDEOREFER_TYPES = ("Basic Questions", "Sequential Questions", "Relationship Questions",
                    "Reasoning Questions", "Future Predictions")


def _motion(mask_t: np.ndarray) -> str:
    """'left' / 'right' / 'up' / 'down': the larger move of an object's
    centroid from its first to its last frame."""
    ys0, xs0 = np.nonzero(mask_t[0])
    ys1, xs1 = np.nonzero(mask_t[-1])
    dy, dx = ys1.mean() - ys0.mean(), xs1.mean() - xs0.mean()
    if abs(dx) >= abs(dy):
        return "right" if dx > 0 else "left"
    return "down" if dy > 0 else "up"


def smooth_texture(rng: np.random.Generator, h: int, w: int, cell: int = 6) -> np.ndarray:
    """(h, w, 3) uint8: noise on a `cell`-pixel lattice, linearly
    interpolated (gradients for optical flow at every pixel)."""
    gh, gw = h // cell + 2, w // cell + 2
    grid = rng.uniform(0, 255, (gh, gw, 3))
    ys, xs = np.arange(h) / cell, np.arange(w) / cell
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    top = grid[y0][:, x0] * (1 - fx) + grid[y0][:, x0 + 1] * fx
    bot = grid[y0 + 1][:, x0] * (1 - fx) + grid[y0 + 1][:, x0 + 1] * fx
    return np.round(top * (1 - fy) + bot * fy).astype(np.uint8)


def shifted_patch_clip(rng: np.random.Generator, n_frames: int, size, patch, step, origin):
    """A textured `patch` (h, w) moved by `step` (dx, dy), whole pixels, a
    frame from `origin` (x, y) over a static textured background of `size`:
    (frames, boxes), boxes[t] = (y0, y1, x0, x1) of the patch in frame t."""
    h, w = size
    ph, pw = patch
    dx, dy = int(step[0]), int(step[1])
    back = smooth_texture(rng, h, w, 8)
    tex = smooth_texture(rng, ph, pw, 4)
    frames, boxes = [], []
    for t in range(n_frames):
        x0, y0 = int(origin[0]) + dx * t, int(origin[1]) + dy * t
        if not (0 <= x0 and x0 + pw <= w and 0 <= y0 and y0 + ph <= h):
            raise ValueError(f"the patch leaves the frame at frame {t}")
        f = back.copy()
        f[y0:y0 + ph, x0:x0 + pw] = tex
        frames.append(f)
        boxes.append((y0, y0 + ph, x0, x0 + pw))
    return frames, boxes


def _rect_outline(h: int, w: int, mask: np.ndarray, rgb, alpha: int, width: int) -> np.ndarray:
    """An RGBA overlay: a rectangle outline `width` px wide around the
    mask's bounding box."""
    ys, xs = np.nonzero(mask)
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    vip = np.zeros((h, w, 4), np.uint8)
    vip[max(y0 - width, 0):min(y1 + width, h), max(x0 - width, 0):min(x1 + width, w)] = (
        *rgb, alpha)
    vip[y0:y1, x0:x1] = 0
    return vip


def write_videoinfer_tree(root: str, split: str = "test", seed: int = 0, n_videos: int = 2,
                          n_frames: int = 24, size=(48, 64), n_expressions: int = 2,
                          n_qa: int = 2) -> Dict[str, object]:
    """VideoInfer's layout under `root`:

      <split>.json  {vid: {"expressions": {exp: {"QA": {qa: {"Q", "A"}},
          "overlayed_frame_idx", "color", "shape", "anno_id"}}}}
      frames/<vid>/<%05d>.jpg
      visual_prompts/<vid>/<exp>/<shape>.npz  the RGBA overlay as "arr_0"
      mask_dict.json  {str(anno_id): [RLE or None] * T}

    Expression e of a video marks object e on a random key frame, with a
    rectangle outline for even e and a half-transparent mask for odd e; its
    QA ask for the object's colour and motion. Returns {"data_root",
    "split", "ids"} (the item ids in `load_items`' order)."""
    rng = np.random.default_rng(seed)
    h, w = size
    names = [f"{i:05d}" for i in range(n_frames)]
    colour_names = list(PROMPT_COLOURS)
    qa_data, mask_dict, ids = {}, {}, []
    for v in range(n_videos):
        vid = f"video{v:04d}"
        frames, masks = synth_video(rng, n_frames, h, w, n_expressions)
        _save_jpegs(frames, names, os.path.join(root, "frames", vid))
        exps = {}
        for e in range(n_expressions):
            anno_id = v * n_expressions + e
            mask_dict[str(anno_id)] = [rle.encode(m.astype(np.uint8)) if m.any() else None
                                       for m in masks[e]]
            key = int(rng.integers(n_frames))
            shape = "rectangle" if e % 2 == 0 else "mask"
            colour = colour_names[(v + e) % len(colour_names)]
            if shape == "rectangle":
                vip = _rect_outline(h, w, masks[e, key], PROMPT_COLOURS[colour], 255,
                                    max(2, min(h, w) // 120))
            else:
                vip = np.zeros((h, w, 4), np.uint8)
                vip[masks[e, key]] = (*PROMPT_COLOURS[colour], 128)
            d = os.path.join(root, "visual_prompts", vid, str(e))
            os.makedirs(d, exist_ok=True)
            np.savez(os.path.join(d, f"{shape}.npz"), vip)
            name = COLOURS[e % len(COLOURS)]
            answers = [f"It is a {name} ellipse.",
                       f"The {name} ellipse moves to the {_motion(masks[e])}."]
            questions = ["What color is the marked object?", "Where does the marked object move?"]
            qas = {f"q{q}": {"Q": questions[q % 2], "A": answers[q % 2]} for q in range(n_qa)}
            exps[str(e)] = {"QA": qas, "overlayed_frame_idx": key, "color": colour,
                            "shape": shape, "anno_id": anno_id}
            ids += [f"{vid}____{e}____{q}" for q in qas]
        qa_data[vid] = {"expressions": exps}
    _dump(qa_data, os.path.join(root, f"{split}.json"))
    _dump(mask_dict, os.path.join(root, "mask_dict.json"))
    return {"data_root": root, "split": split, "ids": ids}


def write_videorefer_tree(root: str, seed: int = 0, n_items: int = 5, n_frames: int = 32,
                          size=(48, 64)) -> Dict[str, str]:
    """VideoRefer-Bench-Q's layout under `root`: `videos/<video>/<%05d>.jpg`
    and `VideoRefer-Bench-Q.json`, a list of {"video", "frame_idx",
    "annotation" (one {str(frame_idx): {"segmentation": COCO RLE}} an object,
    the key frame's), "Question" with `<objectN><region>` markers, "options",
    "Answer", "type"}. Item i asks about one object (even i) or two (odd i),
    its type the i-th of VIDEOREFER_TYPES in turn. Returns {"question_file",
    "video_folder"}."""
    rng = np.random.default_rng(seed)
    h, w = size
    names = [f"{i:05d}" for i in range(n_frames)]
    data = []
    for i in range(n_items):
        video = f"vr{i:04d}"
        n_obj = 1 + i % 2
        frames, masks = synth_video(rng, n_frames, h, w, n_obj)
        _save_jpegs(frames, names, os.path.join(root, "videos", video))
        key = int(rng.integers(n_frames))
        anno = [{str(key): {"segmentation": rle.encode(masks[o, key].astype(np.uint8))}}
                for o in range(n_obj)]
        moves = [_motion(masks[o]) for o in range(n_obj)]
        if n_obj == 1:
            question = "Which way does <object0><region> move?"
            options = [f"({c}) <object0> moves {d}." for c, d in zip("ABCD", (
                "left", "right", "up", "down"))]
            answer = "ABCD"[("left", "right", "up", "down").index(moves[0])]
        else:
            question = "Do <object0><region> and <object1><region> move the same way?"
            options = ["(A) Yes, both move " + moves[0] + ".", "(B) No, <object1> moves "
                       + moves[1] + "."]
            answer = "A" if moves[0] == moves[1] else "B"
        data.append({"video": video, "frame_idx": key, "annotation": anno,
                     "Question": question, "options": options,
                     "Answer": f"({answer})",
                     "type": VIDEOREFER_TYPES[i % len(VIDEOREFER_TYPES)]})
    question_file = os.path.join(root, "VideoRefer-Bench-Q.json")
    _dump(data, question_file)
    return {"question_file": question_file, "video_folder": os.path.join(root, "videos")}


def write_vipbench_tree(root: str, seed: int = 0, n_images: int = 4,
                        size=(48, 64)) -> Dict[str, str]:
    """ViP-Bench's layout under `root`: `images/<id>.jpg` with a coloured
    rectangle drawn around one object (the benchmark's prompts are drawn on
    its images), `questions.jsonl` rows {"question_id", "image", "text"} and
    `vip-bench-meta-data.json` {"v1_<id>": {"image", "question", "answer",
    "capability"}} (the GPT judge's ground truth). Returns
    {"question_file", "image_folder", "meta_file"}."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = size
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rows, meta = [], {}
    caps = (["rec"], ["ocr", "rec"], ["know"], ["math", "rec"])
    for i in range(n_images):
        frames, masks = synth_video(rng, 1, h, w, 2)
        colour = list(PROMPT_COLOURS)[i % len(PROMPT_COLOURS)]
        vip = _rect_outline(h, w, masks[0, 0], PROMPT_COLOURS[colour], 255,
                            max(2, min(h, w) // 120))
        img = frames[0].copy()
        on = vip[..., 3] > 0
        img[on] = vip[on, :3]
        name = f"{i}.jpg"
        Image.fromarray(img).save(os.path.join(root, "images", name))
        text = f"What is the color of the object within the {colour} rectangle?"
        rows.append({"question_id": i, "image": name, "text": text})
        meta[f"v1_{i}"] = {"image": name, "question": text,
                           "answer": f"{COLOURS[0]} <OR> {COLOURS[0]} ellipse",
                           "capability": caps[i % len(caps)]}
    question_file = os.path.join(root, "questions.jsonl")
    with open(question_file, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    meta_file = os.path.join(root, "vip-bench-meta-data.json")
    _dump(meta, meta_file)
    return {"question_file": question_file, "image_folder": os.path.join(root, "images"),
            "meta_file": meta_file}


# ---------------------------------------------------------------------------
# training trees

TRAIN_DATASETS = ("sem_seg", "refer_seg", "vqa", "reason_seg", "refer_vos", "vos", "mevis",
                  "videoqa", "refer_vqa", "refer_videoqa", "revos", "ref_davis")
# tiny sizes for the CPU tests: still images, video frames and their count,
# the mp4's frame size, frames and rate, items a dataset, ReasonSeg val
TINY_SIZES = dict(image=(40, 52), video=(48, 64), frames=5, mp4=(48, 64), mp4_frames=12,
                  mp4_fps=6, items=2, val=(48, 64), val_images=2)


def _save_jpeg(img: np.ndarray, path: str) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(img).save(path)


def _save_png(lab: np.ndarray, path: str) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(lab.astype(np.uint8)).save(path)


def _dump(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def _polygon(mask: np.ndarray, rng: np.random.Generator, n: int = 10) -> List[float]:
    """A flat [x0, y0, ...] polygon around a mask's blob."""
    ys, xs = np.nonzero(mask)
    cy, cx = ys.mean(), xs.mean()
    ry, rx = (ys.max() - ys.min()) / 2 + 0.5, (xs.max() - xs.min()) / 2 + 0.5
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    return np.stack([cx + rx * np.cos(ang), cy + ry * np.sin(ang)], 1).round(2).reshape(-1).tolist()


def _bbox(mask: np.ndarray) -> List[int]:
    ys, xs = np.nonzero(mask)
    return [int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1]


def _still(rng, size, n_objects=2):
    """(uint8 image, bool (O, H, W) masks) of ellipses over noise."""
    frames, masks = synth_video(rng, 1, size[0], size[1], n_objects)
    return frames[0], masks[:, 0]


def _expression_videos(root: str, rng, sz, splits=("train",), palette=False) -> None:
    """MeViS / ReVOS / Ref-DAVIS training layout (<root>/<split>/
    meta_expressions.json, mask_dict.json of RLEs, JPEGImages), or with
    `palette` the Refer-YouTube-VOS one (object ids in palette PNGs under
    Annotations, no mask_dict)."""
    names = [f"{i:05d}" for i in range(sz["frames"])]
    for split in splits:
        d = os.path.join(root, split)
        videos, mask_dict = {}, {}
        for v in range(sz["items"]):
            vid = f"{split}_vid{v:02d}"
            frames, masks = synth_video(rng, sz["frames"], *sz["video"], 3)
            _save_jpegs(frames, names, os.path.join(d, "JPEGImages", vid))
            if palette:
                lab = np.zeros(frames.shape[:3], np.uint8)
                for o in range(len(masks)):
                    lab[masks[o]] = o + 1
                for t, name in enumerate(names):
                    _save_png(lab[t], os.path.join(d, "Annotations", vid, f"{name}.png"))
            else:
                for o in range(len(masks)):
                    mask_dict[f"{v}{o}"] = [rle.encode(m.astype(np.uint8)) for m in masks[o]]
            exps = {}
            for e in range(3):
                objs = [e % 3] + ([(e + 1) % 3] if e == 2 else [])
                text = " and ".join(f"the {COLOURS[o]}  ellipse moving" for o in objs)
                exps[str(e)] = ({"exp": text, "obj_id": [o + 1 for o in objs]} if palette else
                                {"exp": text, "anno_id": [f"{v}{o}" for o in objs],
                                 "obj_id": objs})
            videos[vid] = {"frames": names[::-1], "expressions": exps}
        _dump({"videos": videos}, os.path.join(d, "meta_expressions.json"))
        if not palette:
            _dump(mask_dict, os.path.join(d, "mask_dict.json"))


def _ytvos(root: str, rng, sz) -> None:
    """YouTube-VOS train layout: train/meta.json (objects with categories
    and frames), JPEGImages, palette PNG Annotations."""
    d = os.path.join(root, "train")
    names = [f"{5 * i:05d}" for i in range(sz["frames"])]
    videos = {}
    for v in range(sz["items"]):
        vid = f"yt{v:03d}"
        frames, masks = synth_video(rng, sz["frames"], *sz["video"], 2)
        _save_jpegs(frames, names, os.path.join(d, "JPEGImages", vid))
        lab = np.zeros(frames.shape[:3], np.uint8)
        for o in range(len(masks)):
            lab[masks[o]] = o + 1
        for t, name in enumerate(names):
            _save_png(lab[t], os.path.join(d, "Annotations", vid, f"{name}.png"))
        videos[vid] = {"objects": {str(o + 1): {"category": ("person", "dog")[o], "frames": names}
                                   for o in range(len(masks))}}
    _dump({"videos": videos}, os.path.join(d, "meta.json"))


def _refer_seg(base: str, rng, sz) -> None:
    """RefCOCO (refs(unc).p pickle + instances.json) and gRefCOCO
    (grefs(unc).json, multi- and no-target refs) over COCO train2014 images."""
    rs = os.path.join(base, "refer_seg")
    images, anns = [], []
    for i in range(sz["items"]):
        img, masks = _still(rng, sz["image"])
        name = f"COCO_train2014_{i:012d}.jpg"
        _save_jpeg(img, os.path.join(rs, "images", "mscoco", "images", "train2014", name))
        images.append({"id": i + 1, "file_name": name, "height": img.shape[0],
                       "width": img.shape[1]})
        for o in range(len(masks)):
            seg = ([_polygon(masks[o], rng)] if o == 0
                   else rle.encode(masks[o].astype(np.uint8)))
            anns.append({"id": 10 * (i + 1) + o, "image_id": i + 1, "category_id": o + 1,
                         "segmentation": seg, "bbox": _bbox(masks[o])})
    instances = {"images": images, "annotations": anns,
                 "categories": [{"id": 1, "name": "ball"}, {"id": 2, "name": "plate"}]}
    refs, grefs = [], []
    for a in anns:
        refs.append({"ref_id": len(refs), "ann_id": a["id"], "image_id": a["image_id"],
                     "split": "train" if len(refs) % 4 else "val", "category_id": a["category_id"],
                     "sentences": [{"sent": f"the {COLOURS[a['id'] % 10]} one"},
                                   {"sent": f"object number {a['id'] % 10}"}]})
    for im in images:
        ids = [a["id"] for a in anns if a["image_id"] == im["id"]]
        grefs.append({"ref_id": len(grefs), "ann_id": ids, "image_id": im["id"], "split": "train",
                      "sentences": [{"sent": "both round things"}]})
        grefs.append({"ref_id": len(grefs), "ann_id": -1, "image_id": im["id"], "split": "train",
                      "sentences": [{"sent": "the dragon"}]})
    _dump(instances, os.path.join(rs, "refcoco", "instances.json"))
    with open(os.path.join(rs, "refcoco", "refs(unc).p"), "wb") as f:
        pickle.dump(refs, f)  # the release's format
    _dump(instances, os.path.join(rs, "grefcoco", "instances.json"))
    _dump(grefs, os.path.join(rs, "grefcoco", "grefs(unc).json"))


def _sem_seg(base: str, rng, sz) -> None:
    """The five semantic-segmentation sources: ADE20K, COCO-Stuff and
    Mapillary label PNGs; PACO-LVIS and PASCAL-Part COCO annotations."""
    for i in range(sz["items"]):
        # ADE20K: 0 is "other" (ignored), classes start at 1
        img, m = _still(rng, sz["image"])
        lab = np.zeros(m.shape[1:], np.uint8)
        lab[m[0]], lab[m[1]] = 2, 3
        _save_jpeg(img, os.path.join(base, "ade20k", "images", "training", f"ADE_train_{i:08d}.jpg"))
        _save_png(lab, os.path.join(base, "ade20k", "annotations", "training",
                                    f"ADE_train_{i:08d}.png"))
        # COCO-Stuff and Mapillary: 255 is unlabelled
        img, m = _still(rng, sz["image"])
        lab = np.full(m.shape[1:], 255, np.uint8)
        lab[m[0]], lab[m[1]] = 0, 1 + i % 2
        _save_jpeg(img, os.path.join(base, "coco", "train2017", f"{i:012d}.jpg"))
        _save_png(lab, os.path.join(base, "cocostuff", "train2017", f"{i:012d}.png"))
        img, m = _still(rng, sz["image"])
        lab = np.full(m.shape[1:], 255, np.uint8)
        lab[m[0]], lab[m[1]] = 0, 1
        _save_jpeg(img, os.path.join(base, "mapillary", "training", "images", f"map{i:04d}.jpg"))
        _save_png(lab, os.path.join(base, "mapillary", "training", "v2.0", "labels",
                                    f"map{i:04d}.png"))
    _dump(["wall", "building", "sky"], os.path.join(base, "ade20k", "ade20k_classes.json"))
    os.makedirs(os.path.join(base, "cocostuff"), exist_ok=True)
    with open(os.path.join(base, "cocostuff", "cocostuff_classes.txt"), "w") as f:
        f.write("0: unlabeled\n0: person\n1: grass-merged\n2: tree\n")
    _dump({"labels": [{"readable": "Road"}, {"readable": "Car"}]},
          os.path.join(base, "mapillary", "config_v2.0.json"))
    for name, cats, img_dir, ann in (
            ("paco", [{"id": 1, "name": "car_(vehicle):wheel"}, {"id": 2, "name": "dog"}],
             os.path.join(base, "coco"),
             os.path.join(base, "vlpart", "paco", "annotations", "paco_lvis_v1_train.json")),
            ("pascal", [{"id": 1, "name": "dog:head"}, {"id": 2, "name": "cat:tail"}],
             os.path.join(base, "vlpart", "pascal_part", "VOCdevkit", "VOC2010", "JPEGImages"),
             os.path.join(base, "vlpart", "pascal_part", "train.json"))):
        images, anns = [], []
        for i in range(sz["items"]):
            img, masks = _still(rng, sz["image"])
            fname = f"{name}{i:04d}.jpg"
            _save_jpeg(img, os.path.join(img_dir, fname))
            images.append({"id": i + 1, "file_name": fname, "height": img.shape[0],
                           "width": img.shape[1]})
            for o in range(len(masks)):
                seg = ([_polygon(masks[o], rng)] if o == 0
                       else rle.encode(masks[o].astype(np.uint8)))
                anns.append({"id": 10 * (i + 1) + o, "image_id": i + 1, "category_id": o + 1,
                             "segmentation": seg})
        images.append({"id": 99, "file_name": f"{name}_empty.jpg", "height": 8, "width": 8})
        _dump({"categories": cats, "images": images, "annotations": anns}, ann)


def _vqa(base: str, rng, sz) -> None:
    """LLaVA-Instruct-150k: llava_dataset/llava_instruct_150k.json over COCO
    train2017 images."""
    items = []
    for i in range(sz["items"]):
        img, _ = _still(rng, sz["image"])
        name = f"{100 + i:012d}.jpg"
        _save_jpeg(img, os.path.join(base, "coco", "train2017", name))
        items.append({"id": f"{100 + i:012d}", "image": name, "conversations": [
            {"from": "human", "value": "<image>\nWhat colours are the round things?"},
            {"from": "gpt", "value": f"They are {COLOURS[0]} and {COLOURS[1]}."},
            {"from": "human", "value": "How many are there?"},
            {"from": "gpt", "value": "There are two."}]})
    _dump(items, os.path.join(base, "llava_dataset", "llava_instruct_150k.json"))


def _videoqa(base: str, rng, sz) -> None:
    """LLaVA-Video-178K: llava_video/llava_video_178k.json over mp4 files
    (written with OpenCV's mp4v codec)."""
    import cv2

    d = os.path.join(base, "llava_video", "videos")
    os.makedirs(d, exist_ok=True)
    items = []
    h, w = sz["mp4"]
    n = sz["mp4_frames"]
    for i in range(sz["items"]):
        # a new picture every 8th frame (the motion of a clip at an eighth
        # of its rate), to keep the writing short
        frames, _ = synth_video(rng, -(-n // 8), h, w, 2)
        bgr = frames[:, :, :, ::-1].copy()
        name = f"clip{i:03d}.mp4"
        out = cv2.VideoWriter(os.path.join(d, name), cv2.VideoWriter_fourcc(*"mp4v"),
                              sz["mp4_fps"], (w, h))
        if not out.isOpened():
            raise RuntimeError("OpenCV cannot write mp4v video")
        for t in range(n):
            out.write(bgr[t // 8])
        out.release()
        items.append({"id": f"v{i}", "video": name, "conversations": [
            {"from": "human", "value": "<video>\nWhat moves in this video?"},
            {"from": "gpt", "value": "Two ellipses drift across the frame."}]})
    _dump(items, os.path.join(base, "llava_video", "llava_video_178k.json"))


def _refer_videoqa(base: str, rng, sz) -> None:
    """VideoInfer train split: videoinfer/videoinfer_train.json (RLE object
    masks by frame name) over videoinfer/frames/<video>/*.jpg."""
    names = [f"{i:05d}" for i in range(sz["frames"])]
    items = []
    for v in range(sz["items"]):
        vid = f"vi{v:03d}"
        frames, masks = synth_video(rng, sz["frames"], *sz["video"], 2)
        _save_jpegs(frames, names, os.path.join(base, "videoinfer", "frames", vid))
        items.append({"id": f"vi-{v}", "video": vid,
                      "masks": {n: rle.encode(masks[0, t].astype(np.uint8))
                                for t, n in enumerate(names)},
                      "conversations": [
                          {"from": "human", "value": "<video>\nWhat does the marked thing do?"},
                          {"from": "gpt", "value": "It moves to the right."}]})
    _dump(items, os.path.join(base, "videoinfer", "videoinfer_train.json"))


def _refer_vqa(base: str, rng, sz) -> None:
    """ViP-LLaVA stage-2 / stage-3 instruct rows (ViP-LLaVA-Instruct/
    vip-llava_stage{2,3}_mix.json: pre-built conversations with region
    markers, and vg_rel / refcocog / v7w / pointQA_twice / flickr30k / vcr
    rows the organizer builds from raw fields) over vg/ and gqa/ images;
    Osprey-724K conversations over COCO train2014 images."""
    root = os.path.join(base, "ViP-LLaVA-Instruct")
    rows = {"2": [], "3": []}
    for i in range(sz["items"]):
        img, masks = _still(rng, sz["image"], 3)
        name = f"vg/VG_100K/{i}.jpg" if i % 2 == 0 else f"gqa/images/{i}.jpg"
        _save_jpeg(img, os.path.join(root, name))
        boxes = [_bbox(m) for m in masks]
        polys = [[_polygon(m, rng)] for m in masks]
        rows["2"] += [
            {"id": f"vip-{i}", "image": name, "bboxes": boxes[:2], "segmentations": [polys[0], None],
             "conversations": [{"from": "human", "value": "<image>\nWhat is <bbox0> next to?"},
                               {"from": "gpt", "value": "It is next to <bbox1>."}]},
            {"id": f"vg_rel-{i}", "image": name, "bboxes": boxes[:2],
             "answer": "(ball, next to, plate)"},
            {"id": f"refcocog-{i}", "image": name, "bboxes": boxes[:1], "answer": "a red ball"},
            {"id": f"v7w-{i}", "image": name, "question": "Which region shows the ball?",
             "bboxes": boxes + [[0, 0, 6, 6]], "answer": boxes[0]},
            {"id": f"pointQA_twice-{i}", "image": name, "bboxes": boxes[:1],
             "general_question": "How many balls are there?", "answer": "one"},
            {"id": f"flickr30k-{i}", "image": name, "bbox": [[boxes[0]], [boxes[1], boxes[2]]],
             "grounding": "A ball <bbox0> lies beside plates <bbox1> on the table"},
        ]
        meta = {"boxes": [b + [0.9] for b in boxes],
                "segms": [[np.asarray(p[0]).reshape(-1, 2).tolist()] for p in polys]}
        meta_name = f"vcr_meta/{i}.json"
        _dump(meta, os.path.join(root, meta_name))
        rows["3"].append({
            "id": f"vcr-{i}", "image": name, "meta_dir": f"./dataset/{meta_name}",
            "question": ["Why is", [0], "near", [1], "?"],
            "answer_choices": [[[0], "rolled there", "."], ["nobody knows", "."],
                               [[1], "is a magnet", "."], ["it fell", "."]],
            "answer_label": 0,
            "rationale_choices": [[[0], "is round", "."], ["gravity", "."],
                                  [[2], "pushed it", "."], ["chance", "."]],
            "rationale_label": 0, "class_names": ["ball", "plate", "cup"]})
    rows["3"].append({"id": "skipped-0", "image": "other/img.jpg", "conversations": []})
    for stage, items in rows.items():
        _dump(items, os.path.join(root, f"vip-llava_stage{stage}_mix.json"))
    items = []
    for i in range(sz["items"]):
        img, masks = _still(rng, sz["image"])
        name = f"COCO_train2014_{500 + i:012d}.jpg"
        _save_jpeg(img, os.path.join(base, "coco", "train2014", name))
        regions = []
        for m in masks:
            x0, y0, x1, y1 = _bbox(m)
            regions.append({"bbox": [x0, y0, x1 - x0, y1 - y0], "segmentation": [_polygon(m, rng)]})
        items.append({"file_name": name, "annotation": regions, "conversations": [
            {"from": "human", "value": "<image>\nWhat is <region1> beside <region2>?"},
            {"from": "gpt", "value": "A ball beside a plate."}]})
    _dump(items, os.path.join(base, "Osprey-724K", "osprey_conversation.json"))


def write_train_tree(root: str, datasets=TRAIN_DATASETS, seed: int = 0,
                     sizes: Dict = None) -> str:
    """Write under `root` the layout each of `datasets` (names of
    `data.datasets.DATASET_REGISTRY`) reads, with a ReasonSeg val split:
    ellipses over noise as images and video frames, their masks as the
    annotations (polygons, RLEs or palette PNGs, as each layout stores
    them), questions and answers that name them. `sizes` overrides
    TINY_SIZES: `image` (COCO-style stills), `video` and `frames` (frame
    folders), `mp4`, `mp4_frames` and `mp4_fps` (the videoqa clips),
    `items` (videos or images a dataset), `val` and `val_images`. Returns
    `root`."""
    sz = {**TINY_SIZES, **(sizes or {})}
    unknown = set(datasets) - set(TRAIN_DATASETS)
    if unknown:
        raise ValueError(f"unknown datasets {sorted(unknown)}")
    rng = np.random.default_rng(seed)
    writers = {
        "sem_seg": _sem_seg, "refer_seg": _refer_seg, "vqa": _vqa, "videoqa": _videoqa,
        "refer_videoqa": _refer_videoqa, "refer_vqa": _refer_vqa,
        "vos": _ytvos,
        "mevis": lambda b, r, s: _expression_videos(os.path.join(b, "mevis"), r, s,
                                                     ("train", "valid_u")),
        "revos": lambda b, r, s: _expression_videos(os.path.join(b, "revos"), r, s),
        "ref_davis": lambda b, r, s: _expression_videos(os.path.join(b, "ref_davis"), r, s),
        "refer_vos": lambda b, r, s: _expression_videos(os.path.join(b, "refer_youtube_vos"),
                                                         r, s, palette=True),
    }
    for name in datasets:
        if name == "reason_seg":
            write_reason_seg_tree(root, "train", int(rng.integers(1 << 30)), sz["items"],
                                  sz["image"], sentences=True)
        else:
            writers[name](root, rng, sz)
    if sz["val_images"]:
        write_reason_seg_tree(root, "val", int(rng.integers(1 << 30)), sz["val_images"], sz["val"])
    return root


def _learnable_sample(rng: np.random.Generator, h: int, w: int):
    """A dark noisy image with one bright uniform rectangle, and the
    rectangle's corners as the target polygon: a visible target, so a model
    that learns it must be reading the image."""
    img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
    bh = int(rng.integers(h // 4, h // 2))
    bw = int(rng.integers(w // 4, w // 2))
    y0 = int(rng.integers(2, h - bh - 2))
    x0 = int(rng.integers(2, w - bw - 2))
    img[y0:y0 + bh, x0:x0 + bw] = (230, 40, 40)
    pts = [[x0, y0], [x0 + bw - 1, y0], [x0 + bw - 1, y0 + bh - 1], [x0, y0 + bh - 1]]
    return img, pts


def build_learn_root(root: str, n_train: int = 24, n_val: int = 8, size=(64, 88),
                     seed: int = 0) -> str:
    """The learning-proof run's ReasonSeg-layout tree (`tests/synth_data.py`'s
    `build_learn_root`, file for file): bright-box localization, with train
    and val positions drawn apart, "the bright red box" as every
    expression. `runs/learning_proof_tiny/params_f16.npz` was trained on
    such a tree; `tools/verify_checkpoints.py` scores it on one of a fresh
    seed. Returns `root`."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = size
    for split, n in (("train", n_train), ("val", n_val)):
        d = os.path.join(root, "reason_seg", "ReasonSeg", split)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            img, pts = _learnable_sample(rng, h, w)
            Image.fromarray(img).save(os.path.join(d, f"{split}{i:03d}.jpg"))
            anno = {"shapes": [{"label": "target", "points": pts}],
                    "text": ["the bright red box"], "is_sentence": False}
            with open(os.path.join(d, f"{split}{i:03d}.json"), "w") as f:
                json.dump(anno, f)
    return root

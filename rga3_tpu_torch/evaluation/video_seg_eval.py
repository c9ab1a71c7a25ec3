"""Referring-VOS benchmark drivers (MeViS / ReVOS / ReasonVOS / Ref-DAVIS /
Ref-YTVOS), counterpart of `rga3_tpu/evaluation/video_seg_eval.py`.

`run_inference` shards the expression list by `i % subset_num`, encodes each
video once for all its expressions (`segment_video_multi`), writes 0/255
PNG masks under `<out_dir>/<video>/<exp_id>/<frame>.png` and skips an
expression whose directory already holds a mask per frame. `run_eval` and
`run_eval_revos` score such a tree against the benchmark's RLE ground
truth in worker processes (started with `spawn`: the caller may hold a CUDA
context and threads, which a forked worker would inherit; a spawned worker
imports the caller's main module, so that must be a file).
"""
from __future__ import annotations

import json
import multiprocessing as mp
import os
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from .jf_metrics import db_eval_boundary, db_eval_iou, r2vos_accuracy, r2vos_robustness


def load_meta_expressions(ann_file: str) -> List[Dict]:
    """One job per expression of a meta_expressions.json, with the optional
    ReVOS `type_id` (0 referring, 1 reason) and ReasonVOS `is_sent`.

    Two published layouts:
      * dict expressions (MeViS, ReVOS, Ref-YTVOS, Ref-DAVIS): {exp_id:
        {"exp", "anno_id", ...}};
      * list expressions (ReasonVOS): [{"obj_id", "exp_id", "exp_text",
        "is_sent"}] and a per-video "source"; masks go under
        "{source}_{video}_{obj_id}" while frames stay under the video's
        own name ("frames_dir").
    """
    with open(ann_file) as f:
        videos = json.load(f)["videos"]
    jobs = []
    for vid, vd in videos.items():
        frames = sorted(vd.get("frames", []))
        exps = vd["expressions"]
        if isinstance(exps, list):  # ReasonVOS
            src = vd.get("source")
            for sample in exps:
                obj_id = sample.get("obj_id", 0)
                jobs.append({
                    "video": f"{src}_{vid}_{obj_id}" if src is not None else vid,
                    "frames_dir": vid,
                    "exp_id": str(sample["exp_id"]),
                    "exp": sample["exp_text"],
                    "anno_id": [str(obj_id)],
                    "frames": frames,
                    "type_id": None,
                    "is_sent": bool(sample.get("is_sent", False)),
                })
            continue
        for exp_id, ed in exps.items():
            jobs.append({
                "video": vid,
                "frames_dir": vid,
                "exp_id": exp_id,
                "exp": ed["exp"],
                "anno_id": [str(a) for a in ed.get("anno_id", [])],
                "frames": frames,
                "type_id": ed.get("type_id"),
                "is_sent": bool(ed.get("is_sent", False)),
            })
    return jobs


def resolve_layout(data_root: str, split: str, benchmark: str) -> Tuple[str, str]:
    """(meta_expressions.json, JPEGImages directory) of a benchmark root.

    MeViS keeps both under <root>/<split>/; Ref-YTVOS nests the expressions
    under <root>/meta_expressions/<split>/; ReVOS puts
    `meta_expressions_<split>_.json` and `JPEGImages/` at the root, and
    ReasonVOS a plain `meta_expressions.json`. The benchmark decides which
    layout is tried first; the first that exists is taken.
    """
    candidates = [
        (os.path.join(data_root, split, "meta_expressions.json"),
         os.path.join(data_root, split, "JPEGImages")),
        (os.path.join(data_root, "meta_expressions", split, "meta_expressions.json"),
         os.path.join(data_root, split, "JPEGImages")),
        (os.path.join(data_root, f"meta_expressions_{split}_.json"),
         os.path.join(data_root, "JPEGImages")),
        (os.path.join(data_root, "meta_expressions.json"),
         os.path.join(data_root, "JPEGImages")),
    ]
    if benchmark == "ytvos":
        candidates[0], candidates[1] = candidates[1], candidates[0]
    elif benchmark in ("revos", "reasonvos"):
        candidates = candidates[2:] + candidates[:2]
    for ann, frames in candidates:
        if os.path.exists(ann):
            return ann, frames
    return candidates[0]


def run_inference(segmentor, data_root: str, split: str, out_dir: str, subset_idx: int = 0,
                  subset_num: int = 1, max_jobs: Optional[int] = None,
                  benchmark: str = "mevis",
                  seconds: Optional[Dict[str, float]] = None) -> int:
    """Write per-frame PNG masks under out_dir/<video>/<exp_id>/ and return
    the number of expressions written. `benchmark` selects the question
    template and the layout; for `ytvos` the tree is the submission layout.
    `seconds`, if given, accumulates the host seconds of frame loading
    ("load_frames"), `segment_video_multi` ("segment") and PNG writing
    ("write_png")."""
    from PIL import Image

    from ..data.video import load_frames_from_dir
    from .segmentor import eval_seg_question

    clock = {} if seconds is None else seconds
    for key in ("load_frames", "segment", "write_png"):
        clock.setdefault(key, 0.0)
    ann, frames_root = resolve_layout(data_root, split, benchmark)
    jobs = load_meta_expressions(ann)
    done = 0
    by_video: Dict[str, List[Dict]] = {}
    for i, job in enumerate(jobs):
        if i % subset_num == subset_idx:
            by_video.setdefault(job["video"], []).append(job)

    for video, vjobs in by_video.items():
        if max_jobs is not None and done >= max_jobs:
            break
        pending = []
        for job in vjobs:
            dst = os.path.join(out_dir, job["video"], job["exp_id"])
            if os.path.isdir(dst) and len(os.listdir(dst)) == len(job["frames"]):
                continue  # written by an earlier run
            pending.append(job)
        if max_jobs is not None:
            pending = pending[:max_jobs - done]
        if not pending:
            continue
        t0 = time.perf_counter()
        frames = load_frames_from_dir(
            os.path.join(frames_root, vjobs[0].get("frames_dir", video)))
        t1 = time.perf_counter()
        all_masks = segmentor.segment_video_multi(
            frames, [job["exp"] for job in pending],
            questions=[eval_seg_question(job["exp"], benchmark, is_sent=job["is_sent"])
                       for job in pending])
        t2 = time.perf_counter()
        for job, masks in zip(pending, all_masks):
            dst = os.path.join(out_dir, job["video"], job["exp_id"])
            os.makedirs(dst, exist_ok=True)
            for name, m in zip(job["frames"], masks):
                Image.fromarray((m * 255).astype(np.uint8)).save(os.path.join(dst, f"{name}.png"))
            done += 1
        clock["load_frames"] += t1 - t0
        clock["segment"] += t2 - t1
        clock["write_png"] += time.perf_counter() - t2
    return done


def _load_preds(job: Dict, mask_root: str, shape) -> np.ndarray:
    """(T, H, W) predictions of one expression; a missing PNG is empty and
    any nonzero value is foreground (drivers write 0/255 or 0/100)."""
    from PIL import Image

    preds = np.zeros(shape, bool)
    for i, name in enumerate(job["frames"]):
        p = os.path.join(mask_root, job["video"], job["exp_id"], f"{name}.png")
        if os.path.exists(p):
            preds[i] = np.asarray(Image.open(p)) > 0
    return preds


def _eval_one(args) -> Tuple[str, str, float, float]:
    job, mask_root, gt_masks = args
    preds = _load_preds(job, mask_root, (len(job["frames"]),) + gt_masks.shape[-2:])
    j = float(np.mean(db_eval_iou(gt_masks, preds)))
    f = float(np.mean(db_eval_boundary(gt_masks, preds)))
    return job["video"], job["exp_id"], j, f


def _map(fn, work, num_workers: int):
    """`fn` over `work` in order, in `num_workers` spawned processes (an
    executor: it raises if a worker dies, where a Pool would wait)."""
    if num_workers > 1 and len(work) > 1:
        with ProcessPoolExecutor(num_workers, mp_context=mp.get_context("spawn")) as ex:
            return list(ex.map(fn, work))
    return [fn(w) for w in work]


def run_eval(data_root: str, split: str, mask_root: str,
             mask_dict_name: str = "mask_dict.json", num_workers: int = 8) -> Dict[str, float]:
    """J, F and J&F means over every expression with ground truth."""
    from ..utils import rle as rle_codec

    ann, _ = resolve_layout(data_root, split, "mevis")
    jobs = load_meta_expressions(ann)
    with open(os.path.join(data_root, split, mask_dict_name)) as f:
        mask_dict = json.load(f)
    work = []
    for job in jobs:
        gt = _load_gt_stack(job, mask_dict, rle_codec)
        if gt is not None:
            work.append((job, mask_root, gt))
    results = _map(_eval_one, work, num_workers)
    js = np.asarray([r[2] for r in results])
    fs = np.asarray([r[3] for r in results])
    return {
        "J": float(js.mean()) if len(js) else 0.0,
        "F": float(fs.mean()) if len(fs) else 0.0,
        "J&F": float((js.mean() + fs.mean()) / 2) if len(js) else 0.0,
        "n": len(results),
    }


def _load_gt_stack(job: Dict, mask_dict: Dict, rle_codec) -> Optional[np.ndarray]:
    """(T, H, W) bool ground truth of one expression (the union of its
    anno_ids), or None if no frame of any anno_id has a mask."""
    t = len(job["frames"])
    first = None
    for aid in job["anno_id"]:
        for a in mask_dict.get(aid) or []:
            if a is not None:
                first = a
                break
        if first:
            break
    if first is None:
        return None
    h, w = first["size"]
    gt = np.zeros((t, h, w), bool)
    for aid in job["anno_id"]:
        for i, a in enumerate((mask_dict.get(aid) or [])[:t]):
            if a is not None:
                gt[i] |= rle_codec.decode(a).astype(bool)
    return gt


def _eval_one_revos(args) -> Tuple[Dict, float, float, float, float]:
    job, mask_root, gt, fore = args
    preds = _load_preds(job, mask_root, gt.shape)
    j = float(np.mean(db_eval_iou(gt, preds)))
    f = float(np.mean(db_eval_boundary(gt, preds)))
    a = float(np.mean(r2vos_accuracy(gt, preds)))
    r = float(np.mean(r2vos_robustness(gt, preds, fore)))
    return job, j, f, a, r


def run_eval_revos(data_root: str, split: str, mask_root: str,
                   mask_dict_name: str = "mask_dict.json",
                   foreground_name: str = "mask_dict_foreground.json",
                   num_workers: int = 8) -> Dict[str, Dict[str, float]]:
    """ReVOS: J, F, pixel accuracy A and hallucination robustness R by
    expression type (0 referring, 1 reason), `overall` the mean of the two.
    Each expression's scores are scaled by 100 and rounded to 2 decimals
    before the means, as the benchmark's own evaluator does. Predictions and
    ground truth are both binary before A and R (the benchmark's evaluator
    compares its 0/100 PNG values against 0/1 masks)."""
    from ..utils import rle as rle_codec

    ann, _ = resolve_layout(data_root, split, "revos")
    jobs = load_meta_expressions(ann)
    md_path = os.path.join(data_root, split, mask_dict_name)
    if not os.path.exists(md_path):
        md_path = os.path.join(data_root, mask_dict_name)
    fg_path = os.path.join(data_root, split, foreground_name)
    if not os.path.exists(fg_path):
        fg_path = os.path.join(data_root, foreground_name)
    with open(md_path) as f:
        mask_dict = json.load(f)
    with open(fg_path) as f:
        fg_dict = json.load(f)

    work = []
    for job in jobs:
        gt = _load_gt_stack(job, mask_dict, rle_codec)
        if gt is None:
            continue
        t, h, w = gt.shape
        fore = np.zeros((t, h, w), bool)
        for i, rle in enumerate(fg_dict.get(job["video"], {}).get("masks_rle", [])[:t]):
            if rle is None:
                continue
            m = rle_codec.decode(rle)
            if m.ndim == 3:  # a channel per object
                m = m.sum(axis=2)
            fore[i] = m.astype(bool)
        work.append((job, mask_root, gt, fore))
    results = _map(_eval_one_revos, work, num_workers)

    rows = [{"type_id": job["type_id"], "J": round(100 * j, 2), "F": round(100 * f, 2),
             "A": round(100 * a, 2), "R": round(100 * r, 2)}
            for job, j, f, a, r in results]

    def split_mean(tid: int) -> Dict[str, float]:
        sel = [d for d in rows if d["type_id"] == tid]
        if not sel:
            return {k: 0.0 for k in ("J", "F", "A", "R", "JF")}
        out = {k: float(np.mean([d[k] for d in sel])) for k in ("J", "F", "A", "R")}
        out["JF"] = (out["J"] + out["F"]) / 2
        return out

    referring = split_mean(0)
    reason = split_mean(1)
    overall = {k: (referring[k] + reason[k]) / 2 for k in ("J", "F", "A", "R", "JF")}
    return {"referring": referring, "reason": reason, "overall": overall, "n": len(rows)}

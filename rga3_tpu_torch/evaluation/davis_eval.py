"""Ref-DAVIS17 evaluation, counterpart of `rga3_tpu/evaluation/davis_eval.py`:
per-expression masks merged into per-annotator palette PNGs, then the
official DAVIS protocol (J and F statistics per object, averaged over the
annotators)."""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .jf_metrics import db_eval_boundary, db_eval_iou, db_statistics


def _palette() -> np.ndarray:
    """The VOC / DAVIS palette: the index's bits 0, 1 and 2 of each 3-bit
    group go to r, g and b, from the most significant bit down."""
    pal = np.zeros((256, 3), np.uint8)
    for i in range(256):
        c, r, g, b = i, 0, 0, 0
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        pal[i] = [r, g, b]
    return pal


DAVIS_PALETTE = _palette()


def merge_objects_to_palette(per_object_masks: Sequence[np.ndarray]) -> np.ndarray:
    """Per-object (T, H, W) masks -> (T, H, W) uint8 id maps: scores below
    0.5 become 0, a constant 0.1 background plane goes first, and the argmax
    picks the object, so on an exact tie the lower object id wins."""
    masks = np.stack([m.astype(np.float32) for m in per_object_masks])  # (O, T, H, W)
    masks[masks < 0.5] = 0.0
    bg = np.full((1,) + masks.shape[1:], 0.1, np.float32)
    return np.argmax(np.concatenate([bg, masks], axis=0), axis=0).astype(np.uint8)


def save_palette_pngs(id_maps: np.ndarray, names: Sequence[str], out_dir: str) -> None:
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    for name, frame in zip(names, id_maps):
        img = Image.fromarray(frame, mode="P")
        img.putpalette(DAVIS_PALETTE.reshape(-1).tolist())
        img.save(os.path.join(out_dir, f"{name}.png"))


def evaluate_davis_sequence(gt_id_maps: np.ndarray, pred_id_maps: np.ndarray,
                            object_ids: Optional[Sequence[int]] = None) -> Dict[str, float]:
    """J and F means over the objects of one sequence, its first and last
    frames left out (the semi-supervised protocol)."""
    if object_ids is None:
        object_ids = sorted(set(np.unique(gt_id_maps)) - {0})
    js, fs = [], []
    sl = slice(1, -1) if gt_id_maps.shape[0] > 2 else slice(None)
    for oid in object_ids:
        gt = gt_id_maps[sl] == oid
        pred = pred_id_maps[sl] == oid
        js.append(float(np.mean(db_eval_iou(gt, pred))))
        fs.append(float(np.mean(db_eval_boundary(gt, pred))))
    j = float(np.mean(js)) if js else 0.0
    f = float(np.mean(fs)) if fs else 0.0
    return {"J": j, "F": f, "J&F": (j + f) / 2}


def evaluate_davis(results: Dict[str, Dict[str, np.ndarray]]) -> Dict[str, float]:
    """Means of `evaluate_davis_sequence` over {seq: {"gt", "pred"}}."""
    per_seq = [evaluate_davis_sequence(v["gt"], v["pred"]) for v in results.values()]
    if not per_seq:
        return {"J": 0.0, "F": 0.0, "J&F": 0.0, "n": 0}
    return {
        "J": float(np.mean([s["J"] for s in per_seq])),
        "F": float(np.mean([s["F"] for s in per_seq])),
        "J&F": float(np.mean([s["J&F"] for s in per_seq])),
        "n": len(per_seq),
    }


def _object_stats(jf, ff, j_stats, f_stats, per_sequence, key) -> None:
    jst = db_statistics(np.atleast_1d(jf))
    fst = db_statistics(np.atleast_1d(ff))
    j_stats.append(jst)
    f_stats.append(fst)
    per_sequence[key] = {"J-Mean": jst[0], "F-Mean": fst[0]}


def evaluate_davis_official(results: Dict[str, Dict[str, np.ndarray]],
                            task: str = "unsupervised",
                            max_n_proposals: int = 20) -> Dict[str, object]:
    """The official DAVIS evaluator's tables over {seq: {"gt", "pred"}} id
    maps: [mean, recall, decay] of the per-frame J and F of each (sequence,
    object), and the global [J&F-Mean, J-Mean, J-Recall, J-Decay, F-Mean,
    F-Recall, F-Decay].

    task="unsupervised" (Ref-DAVIS's setting) scores every frame and
    matches the predicted ids to the ground-truth objects by the Hungarian
    assignment on mean (J + F) / 2; a ground-truth object left without a
    proposal scores an empty mask. task="semi-supervised" leaves out the
    first and last frames and matches objects by id."""
    from scipy.optimize import linear_sum_assignment

    j_stats: List = []
    f_stats: List = []
    per_sequence: Dict[str, Dict[str, float]] = {}
    for seq, v in results.items():
        gt_ids, pred_ids = v["gt"], v["pred"]
        if task == "semi-supervised":
            sl = slice(1, -1) if gt_ids.shape[0] > 2 else slice(None)
            gt_ids, pred_ids = gt_ids[sl], pred_ids[sl]
        gt_objs = sorted(set(np.unique(gt_ids)) - {0})
        if task == "unsupervised":
            props = sorted(set(np.unique(pred_ids)) - {0})[:max_n_proposals]
            if not props:
                props = [255]  # no proposal: score an empty mask
            jm = np.zeros((len(props), len(gt_objs), gt_ids.shape[0]))
            fm = np.zeros_like(jm)
            for gi, goid in enumerate(gt_objs):
                for pi, poid in enumerate(props):
                    jm[pi, gi] = db_eval_iou(gt_ids == goid, pred_ids == poid)
                    fm[pi, gi] = db_eval_boundary(gt_ids == goid, pred_ids == poid)
            score = (jm.mean(axis=2) + fm.mean(axis=2)) / 2
            row, col = linear_sum_assignment(-score)
            j_per_obj = {c: jm[r, c] for r, c in zip(row, col)}
            f_per_obj = {c: fm[r, c] for r, c in zip(row, col)}
            empty = np.zeros_like(pred_ids, bool)
            for gi, goid in enumerate(gt_objs):
                jf = j_per_obj.get(gi, db_eval_iou(gt_ids == goid, empty))
                ff = f_per_obj.get(gi, db_eval_boundary(gt_ids == goid, empty))
                _object_stats(jf, ff, j_stats, f_stats, per_sequence, f"{seq}_{goid}")
            continue
        for oid in gt_objs:
            jf = db_eval_iou(gt_ids == oid, pred_ids == oid)
            ff = db_eval_boundary(gt_ids == oid, pred_ids == oid)
            _object_stats(jf, ff, j_stats, f_stats, per_sequence, f"{seq}_{oid}")
    if not j_stats:
        return {"global": {}, "per_sequence": {}}
    j = np.asarray(j_stats)
    f = np.asarray(f_stats)
    glob = {
        "J&F-Mean": float((j[:, 0].mean() + f[:, 0].mean()) / 2),
        "J-Mean": float(j[:, 0].mean()),
        "J-Recall": float(j[:, 1].mean()),
        "J-Decay": float(j[:, 2].mean()),
        "F-Mean": float(f[:, 0].mean()),
        "F-Recall": float(f[:, 1].mean()),
        "F-Decay": float(f[:, 2].mean()),
    }
    return {"global": glob, "per_sequence": per_sequence}


def average_annotators(annotator_globals: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """Ref-DAVIS reports the mean of the global tables of its 4 annotators'
    result trees."""
    if not annotator_globals:
        return {}
    keys = annotator_globals[0].keys()
    return {k: float(np.mean([g[k] for g in annotator_globals])) for k in keys}


def postprocess_davis(src_dir: str, ann_file: str, dst_dir: str,
                      num_annotators: int = 4) -> List[str]:
    """Per-expression mask PNGs -> one palette tree per annotator. Ref-DAVIS
    interleaves each object's annotator expressions (expression index =
    obj_id * 4 + annotator); per annotator the objects merge by
    `merge_objects_to_palette` into <dst>/anno_<k>/<video>/{frame:05d}.png."""
    from PIL import Image

    with open(ann_file) as f:
        videos = json.load(f)["videos"]
    out_dirs = [os.path.join(dst_dir, f"anno_{k}") for k in range(num_annotators)]
    for video, vd in videos.items():
        exp_ids = list(vd["expressions"].keys())
        num_obj = len(exp_ids) // num_annotators
        for anno_id in range(num_annotators):
            objs = []
            for obj_id in range(num_obj):
                mdir = os.path.join(src_dir, video, exp_ids[obj_id * num_annotators + anno_id])
                objs.append(np.stack([
                    np.asarray(Image.open(os.path.join(mdir, f)).convert("L"),
                               dtype=np.float32) / 255.0
                    for f in sorted(os.listdir(mdir))
                ]))
            if not objs:
                continue
            id_maps = merge_objects_to_palette(objs)
            adir = os.path.join(out_dirs[anno_id], video)
            os.makedirs(adir, exist_ok=True)
            save_palette_pngs(id_maps, [f"{i:05d}" for i in range(len(id_maps))], adir)
    return out_dirs


def _load_palette_stack(d: str) -> np.ndarray:
    from PIL import Image

    files = sorted(f for f in os.listdir(d) if f.endswith(".png"))
    return np.stack([np.asarray(Image.open(os.path.join(d, f)), dtype=np.uint8) for f in files])


def eval_davis_annotators(dst_dir: str, gt_dir: str, num_annotators: int = 4,
                          task: str = "unsupervised") -> Dict[str, object]:
    """The official evaluation of each annotator tree against the DAVIS
    palette ground truth (<gt_dir>/<video>/*.png), and their mean."""
    per_annotator = []
    for k in range(num_annotators):
        adir = os.path.join(dst_dir, f"anno_{k}")
        if not os.path.isdir(adir):
            continue
        results = {}
        for video in sorted(os.listdir(adir)):
            gdir = os.path.join(gt_dir, video)
            if not os.path.isdir(gdir):
                continue
            pred = _load_palette_stack(os.path.join(adir, video))
            results[video] = {"gt": _load_palette_stack(gdir)[:len(pred)], "pred": pred}
        per_annotator.append(evaluate_davis_official(results, task=task)["global"])
    return {"per_annotator": per_annotator, "mean": average_annotators(per_annotator)}

"""ReasonSeg annotations, counterpart of `get_mask_from_json` in
`rga3_tpu/data/datasets/image_seg.py` (the training datasets of that file
are not ported)."""
from __future__ import annotations

import json

import numpy as np

from ..polygon import fill_poly, polylines


def get_mask_from_json(json_path: str, height: int, width: int):
    """A ReasonSeg labelme JSON -> (mask, comments, is_sentence): the mask
    holds 1 on targets and 255 on "ignore" shapes ("flag" shapes are
    skipped), painted largest first, each shape as its closed outline and
    its fill. A file that is not UTF-8 is read as cp1252."""
    try:
        with open(json_path, "r") as f:
            anno = json.load(f)
    except UnicodeDecodeError:
        with open(json_path, "r", encoding="cp1252") as f:
            anno = json.load(f)
    shapes = anno["shapes"]
    comments = anno["text"]
    is_sentence = anno["is_sentence"]

    valid, areas = [], []
    for s in shapes:
        if s["label"].lower() == "flag":
            continue
        tmp = np.zeros((height, width), np.uint8)
        pts = np.asarray([s["points"]], np.int32)
        polylines(tmp, pts, 1)
        fill_poly(tmp, pts, 1)
        areas.append(tmp.sum())
        valid.append(s)
    mask = np.zeros((height, width), np.uint8)
    for idx in np.argsort(areas)[::-1]:
        s = valid[idx]
        value = 255 if "ignore" in s["label"].lower() else 1
        pts = np.asarray([s["points"]], np.int32)
        polylines(mask, pts, value)
        fill_poly(mask, pts, value)
    return mask, comments, is_sentence

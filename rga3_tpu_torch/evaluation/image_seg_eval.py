"""Image referring-segmentation validation (gIoU / cIoU over ReasonSeg and
the RefCOCO family), counterpart of `rga3_tpu/evaluation/image_seg_eval.py`.
An image goes through `segment_video` as a video of one frame."""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.meters import intersection_and_union


def evaluate_image_masks(preds: Sequence[np.ndarray], gts: Sequence[np.ndarray]) -> Dict[str, float]:
    """gIoU (the mean per-sample IoU of the foreground) and cIoU (cumulative
    intersection over cumulative union) of (H, W) bool predictions against
    {0, 1, 255} ground truth, 255 ignored."""
    inter_sum = np.zeros(2)
    union_sum = np.zeros(2)
    accs = []
    for pred, gt in zip(preds, gts):
        i, u, _ = intersection_and_union(pred.astype(np.int64), gt.astype(np.int64), 2, 255)
        inter_sum += i
        union_sum += u
        accs.append(i / np.maximum(u, 1e-5))
    acc_iou = np.mean(np.stack(accs), axis=0)
    ciou = inter_sum / np.maximum(union_sum, 1e-5)
    return {"gIoU": float(acc_iou[1]), "cIoU": float(ciou[1]), "n": len(accs)}


def run_refer_seg_val(segmentor, base_dir: str, dataset: str = "refcoco", split: str = "val",
                      max_samples: Optional[int] = None) -> Dict[str, float]:
    """A RefCOCO-family split (<base_dir>/refer_seg/<dataset>/), the first
    sentence of each ref as the expression."""
    from PIL import Image

    from ..data.refer import REFER

    split_by = "umd" if dataset == "refcocog" else "unc"
    api = REFER(os.path.join(base_dir, "refer_seg"), dataset, split_by)
    ref_ids = api.getRefIds(split=split)
    if max_samples:
        ref_ids = ref_ids[:max_samples]
    img_dir = "images/saiapr_tc-12" if dataset == "refclef" else "images/mscoco/images/train2014"
    preds, gts = [], []
    for rid in ref_ids:
        ref = api.loadRefs(rid)[0]
        path = os.path.join(api.data_root, img_dir, api.Imgs[ref["image_id"]]["file_name"])
        img = np.asarray(Image.open(path).convert("RGB"))
        preds.append(segmentor.segment_video([img], ref["sentences"][0]["sent"])[0])
        gts.append(api.get_mask(ref))
    return evaluate_image_masks(preds, gts)


VAL_SPLITS = [
    ("refcoco", "val"), ("refcoco", "testA"), ("refcoco", "testB"),
    ("refcoco+", "val"), ("refcoco+", "testA"), ("refcoco+", "testB"),
    ("refcocog", "val"), ("refcocog", "test"),
]


def run_all_image_seg_vals(segmentor, base_dir: str,
                           max_samples: Optional[int] = None) -> Dict[str, Dict[str, float]]:
    """ReasonSeg val and test and the RefCOCO-family splits of VAL_SPLITS;
    a RefCOCO dataset missing from disk is left out, and a split that fails
    is reported by its error."""
    out: Dict[str, Dict[str, float]] = {}
    for split in ["val", "test"]:
        try:
            out[f"ReasonSeg|{split}"] = run_reason_seg_val(segmentor, base_dir, split, max_samples)
        except Exception as e:  # one split's failure is reported, the others still run
            out[f"ReasonSeg|{split}"] = {"error": str(e)}
    for ds, split in VAL_SPLITS:
        try:
            out[f"{ds}|{split}"] = run_refer_seg_val(segmentor, base_dir, ds, split, max_samples)
        except FileNotFoundError:
            continue
        except Exception as e:  # as above
            out[f"{ds}|{split}"] = {"error": str(e)}
    return out


def reason_seg_images(base_dir: str, split: str = "val") -> List[str]:
    """The sorted images of a ReasonSeg split; empty when it is not on disk."""
    return sorted(glob.glob(os.path.join(base_dir, "reason_seg", "ReasonSeg", split, "*.jpg")))


def run_reason_seg_val(segmentor, base_dir: str, split: str = "val",
                       max_samples: Optional[int] = None) -> Dict[str, float]:
    """ReasonSeg (<base_dir>/reason_seg/ReasonSeg/<split>/*.jpg with a
    labelme .json beside each), the first text of each image."""
    from PIL import Image

    from ..data.datasets.image_seg import get_mask_from_json

    images = reason_seg_images(base_dir, split)
    if not images:
        raise FileNotFoundError(f"no ReasonSeg {split} images under {base_dir}")
    if max_samples:
        images = images[:max_samples]
    preds, gts = [], []
    for path in images:
        img = np.asarray(Image.open(path).convert("RGB"))
        gt, comments, _ = get_mask_from_json(path.replace(".jpg", ".json"), *img.shape[:2])
        text = comments[0] if isinstance(comments, list) else comments
        preds.append(segmentor.segment_video([img], text)[0])
        gts.append(gt)
    return evaluate_image_masks(preds, gts)

"""J&F video-segmentation metrics in numpy, counterpart of
`rga3_tpu/evaluation/jf_metrics.py` (the DAVIS-style region J and boundary
F: 1-pixel boundaries from `seg2bmap`, matched within a disk of radius
ceil(0.008 * ||(H, W)||)).

The boundary dilation is the numpy decomposition of the JAX package's
no-OpenCV route: each row of an L2 disk is a contiguous run centred on the
middle column, so the dilation is the OR over the disk's rows of a
prefix-sum horizontal dilation shifted vertically. It equals `cv2.dilate`
on 0/1 masks (out-of-canvas pixels count as background).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def db_eval_iou(annotation: np.ndarray, segmentation: np.ndarray,
                void_pixels: Optional[np.ndarray] = None) -> np.ndarray:
    """Jaccard index over trailing (H, W) axes; empty against empty is 1."""
    annotation = annotation.astype(bool)
    segmentation = segmentation.astype(bool)
    if void_pixels is None:
        void = np.zeros_like(segmentation)
    else:
        void = void_pixels.astype(bool)
    inters = np.sum((segmentation & annotation) & ~void, axis=(-2, -1))
    union = np.sum((segmentation | annotation) & ~void, axis=(-2, -1))
    j = inters / np.maximum(union, 1)
    close_zero = np.isclose(union, 0)
    if j.ndim == 0:
        return np.asarray(1.0) if close_zero else j
    return np.where(close_zero, 1.0, j)


def disk(radius: int) -> np.ndarray:
    """skimage.morphology.disk: the L2 ball of an integer radius."""
    r = int(radius)
    y, x = np.ogrid[-r:r + 1, -r:r + 1]
    return (x * x + y * y <= r * r).astype(np.uint8)


def _hdilate(c: np.ndarray, k: int) -> np.ndarray:
    """Horizontal binary dilation with window [x - k, x + k] of the mask
    whose row prefix sums are `c`."""
    w = c.shape[1]
    tot = np.empty_like(c)
    tot[:, :max(w - k, 0)] = c[:, k:]
    tot[:, max(w - k, 0):] = c[:, -1:]
    if k + 1 < w:
        tot[:, k + 1:] -= c[:, :w - k - 1]
    return tot > 0


def binary_dilate(mask: np.ndarray, selem: np.ndarray) -> np.ndarray:
    """Binary dilation (max filter) of a 2-D mask by a structuring element
    whose rows are each empty or one run centred on the middle column (an
    L2 disk); raises ValueError for any other element."""
    mask = mask.astype(bool)
    h = mask.shape[0]
    r = selem.shape[0] // 2
    rows = []
    for dy in range(-r, r + 1):
        xs = np.nonzero(selem[dy + r])[0]
        if xs.size == 0:
            rows.append(None)
            continue
        k = int(xs.max() - r)
        if k != r - int(xs.min()) or xs.size != 2 * k + 1:
            raise ValueError("binary_dilate: each row of the element must be one centred run")
        rows.append(k)
    out = np.zeros_like(mask)
    c = np.cumsum(mask, axis=1, dtype=np.int64)
    cache: dict = {}
    for dy in range(-r, r + 1):
        k = rows[dy + r]
        if k is None:
            continue
        if k not in cache:
            cache[k] = _hdilate(c, k)
        hd = cache[k]
        if dy >= 0:
            out[dy:] |= hd[:h - dy]
        else:
            out[:h + dy] |= hd[-dy:]
    return out


def seg2bmap(seg: np.ndarray) -> np.ndarray:
    """1-pixel-wide boundary map."""
    seg = seg.astype(bool)
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]
    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = False
    return b


def f_measure(foreground_mask: np.ndarray, gt_mask: np.ndarray,
              void_pixels: Optional[np.ndarray] = None, bound_th: float = 0.008) -> float:
    """Boundary F of one (H, W) prediction against its ground truth."""
    if void_pixels is None:
        void = np.zeros_like(foreground_mask, dtype=bool)
    else:
        void = void_pixels.astype(bool)
    bound_pix = (bound_th if bound_th >= 1
                 else int(np.ceil(bound_th * np.linalg.norm(foreground_mask.shape))))
    fg_boundary = seg2bmap(foreground_mask.astype(bool) & ~void)
    gt_boundary = seg2bmap(gt_mask.astype(bool) & ~void)
    selem = disk(bound_pix)
    fg_dil = binary_dilate(fg_boundary, selem)
    gt_dil = binary_dilate(gt_boundary, selem)

    gt_match = gt_boundary & fg_dil
    fg_match = fg_boundary & gt_dil
    n_fg = fg_boundary.sum()
    n_gt = gt_boundary.sum()
    if n_fg == 0 and n_gt > 0:
        precision, recall = 1.0, 0.0
    elif n_fg > 0 and n_gt == 0:
        precision, recall = 0.0, 1.0
    elif n_fg == 0 and n_gt == 0:
        precision, recall = 1.0, 1.0
    else:
        precision = fg_match.sum() / float(n_fg)
        recall = gt_match.sum() / float(n_gt)
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def db_eval_boundary(annotation: np.ndarray, segmentation: np.ndarray,
                     void_pixels: Optional[np.ndarray] = None, bound_th: float = 0.008):
    """Boundary F per frame of (T, H, W) stacks, or of one (H, W) pair."""
    if annotation.ndim == 3:
        return np.asarray([
            f_measure(segmentation[i], annotation[i],
                      None if void_pixels is None else void_pixels[i], bound_th)
            for i in range(annotation.shape[0])
        ])
    return f_measure(segmentation, annotation, void_pixels, bound_th)


def db_statistics(per_frame_values: np.ndarray):
    """(mean, recall, decay) of a per-frame measure, the DAVIS protocol's
    statistics: recall is the share of frames above 0.5, decay the mean of
    the first quarter of frames minus that of the last quarter."""
    v = np.asarray(per_frame_values, np.float64)
    mean = float(np.nanmean(v))
    recall = float(np.nanmean(v > 0.5))
    ids = np.round(np.linspace(1, len(v), 5) + 1e-10) - 1
    ids = ids.astype(int)
    bins = [v[ids[i]:ids[i + 1] + 1] for i in range(4)]
    decay = float(np.nanmean(bins[0]) - np.nanmean(bins[3]))
    return mean, recall, decay


def r2vos_accuracy(gt_masks: np.ndarray, pred_masks: np.ndarray) -> np.ndarray:
    """Per-frame pixel accuracy mean(gt == pred) (ReVOS's A)."""
    gt_masks = np.asarray(gt_masks)
    pred_masks = np.asarray(pred_masks)
    if gt_masks.shape != pred_masks.shape:
        raise ValueError(f"r2vos_accuracy: shapes {gt_masks.shape} and {pred_masks.shape}")
    flat = gt_masks.astype(np.uint8) == pred_masks.astype(np.uint8)
    return flat.reshape(flat.shape[0], -1).mean(axis=1).astype(np.float64)


def r2vos_robustness(gt_masks: np.ndarray, pred_masks: np.ndarray,
                     foreground_masks: np.ndarray) -> np.ndarray:
    """Per-frame hallucination robustness (ReVOS's R): max(1 - FP / (fg +
    1e-6), 0), FP the predicted pixels outside the ground truth and fg the
    area of the video's foreground mask."""
    gt_masks = np.asarray(gt_masks)
    pred_masks = np.asarray(pred_masks)
    foreground_masks = np.asarray(foreground_masks)
    if not gt_masks.shape == pred_masks.shape == foreground_masks.shape:
        raise ValueError(f"r2vos_robustness: shapes {gt_masks.shape}, {pred_masks.shape}, "
                         f"{foreground_masks.shape}")
    out = []
    for gt, pred, fore in zip(gt_masks, pred_masks, foreground_masks):
        neg = ((1 - gt.astype(np.int64)) * pred.astype(np.int64)).sum()
        pos = fore.astype(np.int64).sum()
        out.append(max(1.0 - neg / (pos + 1e-6), 0.0))
    return np.asarray(out, np.float64)


def jf_score(annotations: np.ndarray, segmentations: np.ndarray) -> dict:
    """Per-video J, F and J&F means over (T, H, W) binary masks."""
    j = db_eval_iou(annotations, segmentations)
    f = db_eval_boundary(annotations, segmentations)
    return {
        "J": float(np.mean(j)),
        "F": float(np.mean(f)),
        "J&F": float((np.mean(j) + np.mean(f)) / 2),
    }

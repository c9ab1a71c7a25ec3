"""The OpenCV rasterization STOM uses, in numpy, byte for byte.

The JAX package's STOM draws its query disc with `cv2.circle(...,
cv2.FILLED)`, rebuilds a point mask with `cv2.morphologyEx(MORPH_CLOSE)` over
`cv2.getStructuringElement(MORPH_ELLIPSE)` and takes its centroid from
`cv2.moments`. The port imports no cv2; these functions give the same bytes
(the tests hold them to cv2):

  * `fill_circle`: OpenCV's integer midpoint `Circle` fill, the route
    `cv2.circle` takes for a filled circle at LINE_8 with shift 0 (not the
    ellipse polygon of its other routes): horizontal spans, clipped to the
    image;
  * `ellipse_kernel`: `getStructuringElement(MORPH_ELLIPSE, (k, k))`;
  * `morph_close`: dilation then erosion with the kernel's centre as anchor
    and cv2's default border (pixels outside the image take no part);
  * `moments`: m00, m10 and m01 of a uint8 image (pixel values as weights).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def fill_circle(img: np.ndarray, center: Tuple[int, int], radius: int, color) -> None:
    """`cv2.circle(img, center, radius, color, cv2.FILLED)`, in place; center
    is (x, y)."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    half: Dict[int, int] = {}  # row offset from the centre -> half width
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        half[dy] = max(half.get(dy, -1), dx)
        half[dx] = max(half.get(dx, -1), dy)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    for off, hw in half.items():
        x0, x1 = max(cx - hw, 0), min(cx + hw, w - 1)
        if x0 > x1:
            continue
        for y in {cy - off, cy + off}:
            if 0 <= y < h:
                img[y, x0:x1 + 1] = color


def ellipse_kernel(k: int) -> np.ndarray:
    """`cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k))`: (k, k) uint8."""
    if k == 1:
        return np.ones((1, 1), np.uint8)
    r = c = k // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    out = np.zeros((k, k), np.uint8)
    for i in range(k):
        dy = i - r
        if abs(dy) <= r:
            # saturate_cast<int>(double) rounds half to even, as round() does
            dx = round(c * np.sqrt((r * r - dy * dy) * inv_r2))
            out[i, max(c - dx, 0):min(c + dx + 1, k)] = 1
    return out


def _row_runs(kernel: np.ndarray):
    """[(row, j1, j2)]: the kernel's nonzero runs [j1, j2) per row."""
    runs = []
    for i, row in enumerate(kernel != 0):
        edges = np.flatnonzero(np.diff(np.concatenate([[0], row.astype(np.int8), [0]])))
        runs += [(i, int(a), int(b)) for a, b in zip(edges[::2], edges[1::2])]
    return runs


def _morph(src: np.ndarray, runs, anchor: Tuple[int, int], erode: bool) -> np.ndarray:
    """Binary dilation (any) or erosion (all) of bool `src` over the kernel
    runs: dst(y, x) over src(y + i - ay, x + j - ax); pixels outside the
    image are skipped."""
    h, w = src.shape
    ay, ax = anchor
    hit = ~src if erode else src
    cs = np.zeros((h, w + 1), np.int32)
    np.cumsum(hit, axis=1, out=cs[:, 1:])
    cols = np.arange(w)
    out = np.zeros((h, w), bool)
    for i, j1, j2 in runs:
        lo = np.clip(cols + j1 - ax, 0, w)
        hi = np.clip(cols + j2 - ax, 0, w)
        dy = i - ay
        y0, y1 = max(0, -dy), min(h, h - dy)
        if y0 >= y1:
            continue
        rows = cs[y0 + dy:y1 + dy]
        out[y0:y1] |= (rows[:, hi] - rows[:, lo]) > 0
    return ~out if erode else out


def morph_close(mask: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """`cv2.morphologyEx(mask, cv2.MORPH_CLOSE, kernel)` for a 0/v uint8
    mask: dilation then erosion, anchor at the kernel's centre. Computed
    over the set pixels' bounding box widened by twice the kernel, which
    holds every pixel the closing can set (the kernel holds its anchor, so
    the erosion of a pixel the dilation left 0 is 0)."""
    kh, kw = kernel.shape
    anchor = (kh // 2, kw // 2)
    out = np.zeros_like(mask)
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return out
    value = mask[ys[0], xs[0]]
    h, w = mask.shape
    y0, y1 = max(0, ys.min() - 2 * kh), min(h, ys.max() + 2 * kh + 1)
    x0, x1 = max(0, xs.min() - 2 * kw), min(w, xs.max() + 2 * kw + 1)
    runs = _row_runs(kernel)
    win = mask[y0:y1, x0:x1] != 0
    closed = _morph(_morph(win, runs, anchor, erode=False), runs, anchor, erode=True)
    out[y0:y1, x0:x1][closed] = value
    return out


def moments(img: np.ndarray) -> Dict[str, float]:
    """m00, m10 and m01 of `cv2.moments(img)` for a uint8 image: sums of
    the pixel values, weighted by x and by y (exact integers in float64)."""
    v = img.astype(np.int64)
    return {"m00": float(v.sum()),
            "m10": float((v.sum(0) * np.arange(img.shape[1])).sum()),
            "m01": float((v.sum(1) * np.arange(img.shape[0])).sum())}

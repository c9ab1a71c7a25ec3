"""Polygon rasterisation on single-channel uint8 canvases, in numpy: the
pixels of OpenCV's `cv2.fillPoly(img, pts, color)` and
`cv2.polylines(img, pts, True, color, 1)` (8-connected lines, no sub-pixel
shift), which the JAX package calls for ReasonSeg and COCO polygons. The
card has OpenCV, the port does not use it.

* A line is OpenCV's 8-connected Bresenham line: its end points clipped to
  the canvas as `cv2.clipLine` clips them, then walked from the left end
  (`LineIterator(..., leftToRight=True)`), both end pixels included.
* The fill is OpenCV's scan-line fill over a polygon's edges, each edge
  drawn as a line first. An edge that is not horizontal covers rows
  [y_top, y_bottom) and carries its x in 16.16 fixed point from its upper
  end, stepping by the quotient dx / dy truncated toward zero. An edge
  with an end off the canvas takes its x (and its slope) from the end
  points `clip_line` leaves, and its rows from them too unless they lie
  on one row: a segment that only grazes the canvas becomes a vertical
  edge at the clipped x. On each row the active edges, sorted by x, pair
  up (even-odd), and a pair fills the pixel centres in [x_left, x_right]:
  [ceil(x_left), floor(x_right)]. All contours of one call share one edge
  list.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_NO_EDGE = np.iinfo(np.int64).max // 2  # sorts after every edge, no overflow

Point = Tuple[int, int]


def _cdiv(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def clip_line(width: int, height: int, p1: Point, p2: Point) -> Tuple[bool, Point, Point]:
    """`cv2.clipLine` on a width x height canvas: (whether any of the
    segment is on the canvas, the end points as OpenCV leaves them; it
    moves them even for a segment it then finds outside)."""
    (x1, y1), (x2, y2) = p1, p2
    if width <= 0 or height <= 0:
        return False, p1, p2
    right, bottom = width - 1, height - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        # OpenCV's arithmetic: a double product and quotient cast toward
        # zero, the second end point moved along the already moved first
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def line_pixels(width: int, height: int, p1: Point, p2: Point) -> Tuple[np.ndarray, np.ndarray]:
    """(ys, xs) of OpenCV's 8-connected line from p1 to p2 on the canvas."""
    visible, (x1, y1), (x2, y2) = clip_line(width, height, p1, p2)
    if not visible:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:  # walked from the left end
        dx, dy, x1, y1 = -dx, -dy, x2, y2
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vertical = dy > dx
    major, minor = (dy, dx) if vertical else (dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    # steps along the minor axis after k steps: the count of negative
    # error terms err_j = major - 2 minor (j + 1) + 2 major m_j, j < k
    m = (np.maximum(0, -((major - 2 * minor * k) // (2 * major))) if major
         else np.zeros_like(k))
    if vertical:
        return y1 + sy * k, x1 + m
    return y1 + sy * m, x1 + k


def _draw_line(img: np.ndarray, p1: Point, p2: Point, color: int) -> None:
    ys, xs = line_pixels(img.shape[1], img.shape[0], p1, p2)
    img[ys, xs] = color


def _contours(pts) -> List[List[Point]]:
    """cv2's point argument (a sequence of (N, 2) integer contours) as lists
    of Python int points."""
    return [[(int(x), int(y)) for x, y in np.asarray(c).reshape(-1, 2)] for c in pts]


def polylines(img: np.ndarray, pts: Sequence[np.ndarray], color: int) -> None:
    """`cv2.polylines(img, pts, True, color, 1)`: each contour's closed
    outline, in place."""
    for contour in _contours(pts):
        if not contour:
            continue
        p0 = contour[-1]
        for p in contour:
            _draw_line(img, p0, p, color)
            p0 = p


def fill_poly(img: np.ndarray, pts: Sequence[np.ndarray], color: int) -> None:
    """`cv2.fillPoly(img, pts, color)`, in place."""
    h, w = img.shape[:2]
    edges = []  # (y_top, y_bottom, x at y_top in 16.16, dx a row in 16.16)
    for contour in _contours(pts):
        if not contour:
            continue
        pt0 = contour[-1]
        for pt1 in contour:
            _draw_line(img, pt0, pt1, color)
            (x0, y0), (x1, y1) = pt0, pt1
            c0, c1 = [x0, y0], [x1, y1]
            if not (0 <= x0 < w and 0 <= x1 < w and 0 <= y0 < h and 0 <= y1 < h):
                _, t0, t1 = clip_line(w, h, pt0, pt1)
                c0[0], c1[0] = t0[0], t1[0]
                if t0[1] != t1[1]:
                    c0[1], c1[1] = t0[1], t1[1]
            c0[0] <<= XY_SHIFT
            c1[0] <<= XY_SHIFT
            pt0 = pt1
            if y0 == y1:
                continue
            dx = _cdiv(c1[0] - c0[0], c1[1] - c0[1])
            if y0 < y1:
                edges.append((y0, y1, c0[0] + (y0 - c0[1]) * dx, dx))
            else:
                edges.append((y1, y0, c1[0] + (y1 - c1[1]) * dx, dx))
    if len(edges) < 2:
        return
    e = np.asarray(edges, np.int64)
    lo, hi = max(int(e[:, 0].min()), 0), min(int(e[:, 1].max()), h)
    if lo >= hi:
        return
    ys = np.arange(lo, hi, dtype=np.int64)[:, None]
    active = (ys >= e[None, :, 0]) & (ys < e[None, :, 1])
    xs = np.where(active, e[None, :, 2] + (ys - e[None, :, 0]) * e[None, :, 3], _NO_EDGE)
    xs.sort(axis=1)
    n_active = active.sum(axis=1)
    pairs = xs.shape[1] // 2
    left = (xs[:, 0:2 * pairs:2] + XY_ONE - 1) >> XY_SHIFT
    right = xs[:, 1:2 * pairs:2] >> XY_SHIFT
    drawn = ((2 * np.arange(pairs) + 1)[None, :] < n_active[:, None]) & (left < w) & (right >= 0)
    rows, cols = np.nonzero(drawn)
    x_a = np.maximum(left[rows, cols], 0)
    x_b = np.minimum(right[rows, cols], w - 1)
    cover = np.zeros((hi - lo, w + 1), np.int32)
    np.add.at(cover, (rows, x_a), 1)
    np.add.at(cover, (rows, x_b + 1), -1)
    img[lo:hi][np.cumsum(cover[:, :w], axis=1) > 0] = color

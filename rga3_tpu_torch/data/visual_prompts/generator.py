"""Visual-prompt rasterizer, counterpart of
`rga3_tpu/data/visual_prompts/generator.py`: draws one overlay shape
(rectangle, ellipse, arrow, triangle, point, scribble, mask, mask contour)
in a colour of `COLOR_POOL` or a given RGB onto a PIL image with
`ImageDraw`, at a random width and alpha, and alpha-composites it. Shapes
that need points inside the region sample them from the binary mask; mask
outlines come from OpenCV's `findContours` (imported when called). The
random draws are the JAX package's, in its order.
"""
from __future__ import annotations

import math
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

COLOR_POOL = {
    "red": (255, 0, 0),
    "lime": (0, 255, 0),
    "blue": (0, 0, 255),
    "yellow": (255, 255, 0),
    "fuchsia": (255, 0, 255),
    "aqua": (0, 255, 255),
    "orange": (255, 165, 0),
    "purple": (128, 0, 128),
    "gold": (255, 215, 0),
}


def get_bbox_from_mask(mask: np.ndarray) -> Tuple[int, int, int, int]:
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    top, bottom = np.where(rows)[0][[0, -1]]
    left, right = np.where(cols)[0][[0, -1]]
    return (int(left), int(top), int(right) + 1, int(bottom) + 1)


def mask_to_segmentation_coords(mask: np.ndarray) -> List[List[int]]:
    """Binary mask -> list of flattened [x0,y0,x1,y1,...] contours."""
    import cv2

    contours, _ = cv2.findContours(
        mask.astype(np.uint8), cv2.RETR_LIST, cv2.CHAIN_APPROX_SIMPLE
    )
    out = []
    for c in contours:
        pts = c.reshape(-1, 2)
        if len(pts) < 3:
            continue
        out.append([int(v) for p in pts for v in p])
    return out


def _sample_point_in_mask(
    mask: Optional[np.ndarray], bbox: Tuple[float, float, float, float]
) -> Tuple[float, float]:
    if mask is not None and mask.sum() > 0:
        ys, xs = np.nonzero(mask)
        i = random.randrange(len(ys))
        return float(xs[i]), float(ys[i])
    left, top, right, bottom = bbox
    return random.uniform(left, right), random.uniform(top, bottom)


def _bezier(p0, p1, p2, p3, n: int):
    t = np.linspace(0, 1, n)[:, None]
    pts = (
        (1 - t) ** 3 * np.asarray(p0)
        + 3 * (1 - t) ** 2 * t * np.asarray(p1)
        + 3 * (1 - t) * t**2 * np.asarray(p2)
        + t**3 * np.asarray(p3)
    )
    return [tuple(p) for p in pts]


def draw_arrow(
    draw, bbox, color, line_width: int,
    max_arrow_length: float = 100, max_image_size: int = 336,
    image_size_anchor: int = 336,
):
    left, top, right, bottom = bbox
    cx = (left + right) / 2 + random.uniform(-0.1, 0.1) * (right - left)
    cy = (top + bottom) / 2 + random.uniform(-0.1, 0.1) * (bottom - top)
    side = min(right - left, bottom - top)
    length = random.uniform(0.8 * side, max(max_arrow_length, 0.8 * side))
    angle = random.uniform(0, 2 * math.pi)
    head = max(
        random.uniform(0.1, 0.3) * length,
        int(4 * max_image_size / image_size_anchor),
    )
    sx = cx + length * math.cos(angle)
    sy = cy + length * math.sin(angle)
    c1 = (sx + 0.5 * random.uniform(-10, 10), sy + 0.5 * random.uniform(-10, 10))
    c2 = (cx + 0.5 * random.uniform(-10, 10), cy + 0.5 * random.uniform(-10, 10))
    path = _bezier((sx, sy), c1, c2, (cx, cy), 20)
    for a, b in zip(path[:-1], path[1:]):
        draw.line([a, b], fill=color, width=line_width)
    draw.polygon(
        [
            (cx + head * math.cos(angle + math.pi / 3),
             cy + head * math.sin(angle + math.pi / 3)),
            (cx, cy),
            (cx + head * math.cos(angle - math.pi / 3),
             cy + head * math.sin(angle - math.pi / 3)),
        ],
        fill=color,
    )


def draw_rounded_triangle(draw, bbox, mask, color, width):
    def max_angle_ok(points):
        for i in range(3):
            p1 = np.asarray(points[i])
            p2 = np.asarray(points[(i + 1) % 3])
            p3 = np.asarray(points[(i + 2) % 3])
            a = np.linalg.norm(p3 - p2)
            b = np.linalg.norm(p1 - p3)
            c = np.linalg.norm(p1 - p2)
            cosv = np.clip((a**2 + c**2 - b**2) / (2 * a * c + 1e-8), -1, 1)
            if np.degrees(np.arccos(cosv)) > 150:
                return False
        return True

    for _ in range(50):
        pts = [_sample_point_in_mask(mask, bbox) for _ in range(3)]
        if max_angle_ok(pts):
            break
    draw.line(
        [pts[0], pts[1], pts[2], pts[0]], fill=color, width=width,
        joint="curve",
    )


def draw_scribble(draw, bbox, mask, color, width, n_points: int = 1000):
    pts = [_sample_point_in_mask(mask, bbox) for _ in range(4)]
    path = _bezier(*pts, n=n_points)
    for a, b in zip(path[:-1], path[1:]):
        draw.line([a, b], fill=color, width=width)


def draw_point(draw, bbox, mask, color, radius, aspect_ratio=1.0):
    left, top, right, bottom = bbox
    mean = ((left + right) / 2, (top + bottom) / 2)
    sx = max((right - left) / 8, 1e-3)
    sy = max((bottom - top) / 8, 1e-3)
    cx, cy = mean
    for _ in range(10):
        cx = np.random.normal(mean[0], math.sqrt(sx))
        cy = np.random.normal(mean[1], math.sqrt(sy))
        if mask is None:
            break
        xi, yi = int(round(cx)), int(round(cy))
        if (
            0 <= yi < mask.shape[0] and 0 <= xi < mask.shape[1]
            and mask[yi, xi]
        ):
            break
    else:
        if mask is not None and mask.sum() > 0:
            cx, cy = _sample_point_in_mask(mask, bbox)
    rx, ry = radius * aspect_ratio, radius / aspect_ratio
    draw.ellipse([cx - rx, cy - ry, cx + rx, cy + ry], outline=color, fill=color)


def image_blending(
    image: Image.Image,
    shape: str = "rectangle",
    bbox_coord: Optional[Tuple[float, float, float, float]] = None,
    segmentation: Optional[Sequence[Sequence[float]]] = None,
    mask: Optional[np.ndarray] = None,
    image_size_anchor: int = 336,
    rgb_value: Optional[Tuple[int, int, int]] = None,
    visual_prompt_style: str = "",
    alpha: Optional[int] = None,
    width: Optional[float] = None,
    return_vip_img: bool = False,
):
    """Rasterize one overlay onto `image` (PIL RGB). Returns
    (blended RGB image, RGBA overlay or None)."""
    from PIL import Image, ImageDraw

    img_w, img_h = image.size
    max_size = max(img_w, img_h)
    overlay = Image.new("RGBA", (img_w, img_h), (0, 0, 0, 0))
    canvas = ImageDraw.Draw(overlay)

    if mask is None and segmentation:
        # rasterize polygon coords to a mask for point sampling
        m = Image.new("L", (img_w, img_h), 0)
        md = ImageDraw.Draw(m)
        for seg in segmentation:
            pts = [(seg[i], seg[i + 1]) for i in range(0, len(seg), 2)]
            if len(pts) >= 3:
                md.polygon(pts, fill=1)
        mask = np.asarray(m)
    if bbox_coord is None and mask is not None and mask.sum() > 0:
        bbox_coord = get_bbox_from_mask(mask)
    # only the mask shapes read the outline (no random draw in between)
    if shape in ("mask", "mask contour"):
        if segmentation is None and mask is not None:
            segmentation = mask_to_segmentation_coords(mask)
        if segmentation is None and bbox_coord is not None:
            l, t, r, b = bbox_coord
            segmentation = [[l, t, l, b, r, b, r, t]]

    if rgb_value is None:
        _, rgb_value = random.choice(list(COLOR_POOL.items()))
    if alpha is None:
        alpha = (
            random.randint(188, 224) if shape != "mask"
            else random.randint(72, 128)
        )
    color = tuple(rgb_value) + (alpha,)

    def scaled(base_lo, base_hi):
        if width is not None:
            return max(int(width * max_size / image_size_anchor), 1)
        return max(
            random.randint(
                int(base_lo * max_size / image_size_anchor),
                int(base_hi * max_size / image_size_anchor),
            ),
            1,
        )

    if shape == "rectangle":
        lw = (
            max(int(3 * max_size / image_size_anchor), 1)
            if visual_prompt_style == "constant" and width is None
            else scaled(2, 8)
        )
        canvas.rectangle(
            [bbox_coord[:2], bbox_coord[2:]], outline=color, width=lw
        )
    elif shape == "ellipse":
        lw = scaled(2, 8)
        l, t, r, b = bbox_coord
        cx, cy = (l + r) / 2, (t + b) / 2
        w2 = (r - l) * 1.2 / 2
        h2 = (b - t) * 1.2 / 2
        canvas.ellipse(
            [cx - w2, cy - h2, cx + w2, cy + h2], outline=color, width=lw
        )
    elif shape == "arrow":
        lw = scaled(1, 6)
        draw_arrow(
            canvas, bbox_coord, color, lw,
            max_arrow_length=max(int(50 * max_size / image_size_anchor), 1),
            max_image_size=max_size, image_size_anchor=image_size_anchor,
        )
    elif shape == "triangle":
        draw_rounded_triangle(canvas, bbox_coord, mask, color, scaled(2, 8))
    elif shape == "point":
        if visual_prompt_style == "constant" and width is None:
            radius = max(int(8 * max_size / image_size_anchor), 1)
            aspect = 1.0
        else:
            radius = scaled(10, 15)
            aspect = (
                1.0 if random.random() < 0.5 else random.uniform(0.5, 2.0)
            )
        draw_point(canvas, bbox_coord, mask, color, radius, aspect)
    elif shape == "scribble":
        lw = scaled(12, 15)
        draw_scribble(
            canvas, bbox_coord, mask, color, lw,
            n_points=int(1000 * max_size / image_size_anchor),
        )
    elif shape == "mask":
        for seg in segmentation:
            pts = [(seg[i], seg[i + 1]) for i in range(0, len(seg), 2)]
            if len(pts) >= 3:
                canvas.polygon(pts, fill=color)
    elif shape == "mask contour":
        lw = scaled(1, 2)
        for seg in segmentation:
            pts = [(seg[i], seg[i + 1]) for i in range(0, len(seg), 2)]
            if len(pts) >= 3:
                for dx in range(-lw, lw + 1):
                    for dy in range(-lw, lw + 1):
                        canvas.polygon(
                            [(x + dx, y + dy) for x, y in pts], outline=color
                        )
    else:
        raise ValueError(f"unknown shape {shape!r}")

    blended = Image.alpha_composite(image.convert("RGBA"), overlay).convert(
        "RGB"
    )
    return blended, (overlay if return_vip_img else None)


def blend_image_from_mask(
    frame: Image.Image, mask: np.ndarray, color: str, shape: str
) -> Image.Image:
    """Constant-style blend used by eval pipelines."""
    if mask.sum() == 0:
        return frame
    blended, _ = image_blending(
        frame,
        shape=shape,
        mask=mask,
        rgb_value=COLOR_POOL[color],
        image_size_anchor=448,
        visual_prompt_style="constant",
    )
    return blended


def video_blending_keyframes(
    frames: Sequence[Image.Image],
    masks: Sequence[np.ndarray],
    is_key_frame: Sequence[bool],
    color: str,
    shape: str,
    return_vip_img: bool = False,
):
    """Overlay only key frames."""
    blended = []
    vip_img = None
    for frame, mask, flag in zip(frames, masks, is_key_frame):
        if mask.sum() == 0 or not flag:
            blended.append(frame)
            continue
        out, vip = image_blending(
            frame, shape=shape, mask=mask,
            rgb_value=COLOR_POOL[color], image_size_anchor=448,
            return_vip_img=return_vip_img,
        )
        blended.append(out)
        if vip is not None:
            vip_img = vip
    if return_vip_img:
        return blended, vip_img
    return blended

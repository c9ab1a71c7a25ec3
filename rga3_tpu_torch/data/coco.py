"""COCO segmentation rasterisation, counterpart of `segmentation_to_mask`
in `rga3_tpu/data/coco.py`: polygons through the port's OpenCV-exact fill
(`data.polygon`), RLEs through the port's codec."""
from __future__ import annotations

from typing import Any

import numpy as np

from ..utils import rle as rle_codec
from .polygon import fill_poly


def segmentation_to_mask(seg: Any, height: int, width: int) -> np.ndarray:
    """A COCO segmentation (a list of flat [x0, y0, x1, y1, ...] polygons,
    an uncompressed RLE or a compressed RLE) -> (H, W) uint8 mask. Polygon
    points are truncated toward zero to integers, each polygon filled on
    its own."""
    if isinstance(seg, dict):
        return rle_codec.decode(seg).astype(np.uint8)
    mask = np.zeros((height, width), np.uint8)
    for poly in seg:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        fill_poly(mask, [pts.astype(np.int32)], 1)
    return mask

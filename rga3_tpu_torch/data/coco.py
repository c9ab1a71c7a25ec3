"""A COCO annotation index and segmentation rasterisation, counterpart of
`rga3_tpu/data/coco.py`: `CocoIndex` covers what the data layer needs of
`pycocotools.coco.COCO` (categories, images, annotations by image,
`annToMask`); polygons go through the port's OpenCV-exact fill
(`data.polygon`), RLEs through the port's codec."""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Dict, List, Sequence, Union

import numpy as np

from ..utils import rle as rle_codec
from .polygon import fill_poly


class CocoIndex:
    """A COCO annotation file indexed by id, with pycocotools' method names."""

    def __init__(self, annotation_file: str):
        with open(annotation_file) as f:
            data = json.load(f)
        self.cats: Dict[int, Dict] = {c["id"]: c for c in data.get("categories", [])}
        self.imgs: Dict[int, Dict] = {i["id"]: i for i in data.get("images", [])}
        self.anns: Dict[int, Dict] = {a["id"]: a for a in data.get("annotations", [])}
        self.img_to_anns: Dict[int, List[int]] = defaultdict(list)
        for a in data.get("annotations", []):
            self.img_to_anns[a["image_id"]].append(a["id"])

    def getCatIds(self) -> List[int]:
        return sorted(self.cats.keys())

    def loadCats(self, ids: Sequence[int]) -> List[Dict]:
        return [self.cats[i] for i in ids]

    def getImgIds(self) -> List[int]:
        return sorted(self.imgs.keys())

    def loadImgs(self, ids: Sequence[int]) -> List[Dict]:
        return [self.imgs[i] for i in ids]

    def getAnnIds(self, imgIds: Union[int, Sequence[int]]) -> List[int]:
        if isinstance(imgIds, int):
            imgIds = [imgIds]
        out: List[int] = []
        for i in imgIds:
            out.extend(self.img_to_anns.get(i, []))
        return out

    def loadAnns(self, ids: Sequence[int]) -> List[Dict]:
        return [self.anns[i] for i in ids]

    def annToMask(self, ann: Dict[str, Any]) -> np.ndarray:
        img = self.imgs[ann["image_id"]]
        return segmentation_to_mask(ann["segmentation"], img["height"], img["width"])


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

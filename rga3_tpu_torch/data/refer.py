"""The REFER annotation index (RefCOCO / RefCOCO+ / RefCOCOg / RefCLEF),
counterpart of `rga3_tpu/data/refer.py`: `refs(<split_by>).p` and
`instances.json` under <data_root>/<dataset>/, with masks from the
annotations' polygons or RLEs."""
from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Sequence, Union

import numpy as np

from .coco import segmentation_to_mask


class REFER:
    def __init__(self, data_root: str, dataset: str = "refcoco", split_by: str = "unc"):
        self.data_root = data_root
        self.dataset = dataset
        ref_file = os.path.join(data_root, dataset, f"refs({split_by}).p")
        if not os.path.exists(ref_file):
            raise FileNotFoundError(ref_file)
        # the benchmark's own pickle, as the dataset release ships it
        with open(ref_file, "rb") as f:
            self.refs_data: List[Dict] = pickle.load(f)
        with open(os.path.join(data_root, dataset, "instances.json")) as f:
            instances = json.load(f)
        self.Imgs = {im["id"]: im for im in instances["images"]}
        self.Anns = {a["id"]: a for a in instances["annotations"]}
        self.Cats = {c["id"]: c["name"] for c in instances["categories"]}
        self.Refs = {r["ref_id"]: r for r in self.refs_data}
        self.imgToRefs: Dict[int, List] = {}
        for r in self.refs_data:
            self.imgToRefs.setdefault(r["image_id"], []).append(r)

    def getRefIds(self, image_ids=None, split: str = "") -> List[int]:
        refs = self.refs_data
        if image_ids:
            wanted = set(image_ids if isinstance(image_ids, (list, tuple)) else [image_ids])
            refs = [r for r in refs if r["image_id"] in wanted]
        if split:
            refs = [r for r in refs if r["split"] == split]
        return [r["ref_id"] for r in refs]

    def loadRefs(self, ref_ids: Union[int, Sequence[int]]) -> List[Dict]:
        if isinstance(ref_ids, int):
            ref_ids = [ref_ids]
        return [self.Refs[i] for i in ref_ids]

    def loadAnns(self, ann_ids: Union[int, Sequence[int]]) -> List[Dict]:
        if isinstance(ann_ids, int):
            ann_ids = [ann_ids]
        return [self.Anns[i] for i in ann_ids]

    def get_mask(self, ref: Dict) -> np.ndarray:
        """(H, W) uint8 mask of a ref's annotation."""
        ann = self.Anns[ref["ann_id"]]
        img = self.Imgs[ref["image_id"]]
        return segmentation_to_mask(ann["segmentation"], img["height"], img["width"])

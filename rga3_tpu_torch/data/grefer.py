"""The gRefCOCO annotation index, counterpart of `rga3_tpu/data/grefer.py`:
`grefs(<split_by>).json` and `instances.json` under <data_root>/<dataset>/;
an expression may name several targets (`ann_id` a list) or none (-1), and
its mask is the union of its targets' masks."""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Union

import numpy as np

from .coco import segmentation_to_mask


class G_REFER:
    def __init__(self, data_root: str, dataset: str = "grefcoco", split_by: str = "unc"):
        self.data_root = data_root
        self.dataset = dataset
        ref_file = os.path.join(data_root, dataset, f"grefs({split_by}).json")
        if not os.path.exists(ref_file):
            raise FileNotFoundError(ref_file)
        with open(ref_file) as f:
            self.refs_data: List[Dict] = json.load(f)
        with open(os.path.join(data_root, dataset, "instances.json")) as f:
            instances = json.load(f)
        self.Imgs = {im["id"]: im for im in instances["images"]}
        self.Anns = {a["id"]: a for a in instances["annotations"]}
        self.Refs = {r["ref_id"]: r for r in self.refs_data}

    def getRefIds(self, split: str = "") -> List[int]:
        refs = self.refs_data
        if split:
            refs = [r for r in refs if r["split"] == split]
        return [r["ref_id"] for r in refs]

    def loadRefs(self, ref_ids: Union[int, Sequence[int]]) -> List[Dict]:
        if isinstance(ref_ids, int):
            ref_ids = [ref_ids]
        return [self.Refs[i] for i in ref_ids]

    @staticmethod
    def _ann_ids(ref: Dict) -> List[int]:
        aid = ref["ann_id"]
        if isinstance(aid, list):
            return [a for a in aid if a not in (-1, None)]
        return [] if aid in (-1, None) else [aid]

    def is_no_target(self, ref: Dict) -> bool:
        return len(self._ann_ids(ref)) == 0

    def get_mask(self, ref: Dict) -> np.ndarray:
        """(H, W) uint8 union of the targets' masks; zero for no target."""
        img = self.Imgs[ref["image_id"]]
        h, w = img["height"], img["width"]
        mask = np.zeros((h, w), np.uint8)
        for aid in self._ann_ids(ref):
            mask |= segmentation_to_mask(self.Anns[aid]["segmentation"], h, w)
        return mask

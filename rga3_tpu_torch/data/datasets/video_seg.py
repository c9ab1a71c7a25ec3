"""Video referring-segmentation datasets, counterpart of
`rga3_tpu/data/datasets/video_seg.py`: MeViS, ReVOS, Ref-DAVIS and
Refer-YouTube-VOS (`VideoExpressionDataset`) and plain VOS (`YTVOSDataset`).
A sample takes num_frames_mllm frames (a random anchor kept, the rest drawn
from the whole video), decodes the RLE or palette-PNG masks, and gives SAM a
random num_frames_sam subset of those frames, with a [SEG] answer.
"""
from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Sequence

import numpy as np

from ...utils import rle as rle_codec
from ..collate import TrainSample
from .base import (
    TaskDataset,
    make_seg_answer,
    make_seg_question,
    random_dense_subset,
    resize_mask,
    sam_preprocess_frame,
    seg_qa_messages,
)


def sample_frame_indices(vid_len: int, num_frames: int, anchor: int = 0):
    """Reference sparse sampling (mevis_dataset.py:235-263): keep `anchor`,
    fill the rest with random global indices (repeats when short)."""
    idxs = [anchor]
    need = num_frames - 1
    pool = [i for i in range(vid_len) if i != anchor]
    if need <= 0:
        return sorted(idxs)
    if len(pool) >= need:
        idxs += random.sample(pool, need)
    elif vid_len >= need:
        idxs += random.sample(range(vid_len), need)
    else:
        rep = need // vid_len
        idxs += random.sample(range(vid_len), need % vid_len) + list(
            range(vid_len)
        ) * rep
    return sorted(idxs)


class VideoExpressionDataset(TaskDataset):
    """MeViS-style layout: <root>/<split>/meta_expressions.json +
    mask_dict.json + JPEGImages/<video>/*.jpg. Covers MeViS and ReVOS (same
    schema) and Refer-YouTube-VOS (per-object PNG masks)."""

    name = "video_expression"

    def __init__(
        self,
        root: str,
        splits: Sequence[str] = ("train",),
        num_frames_mllm: int = 8,
        num_frames_sam: int = 4,
        mask_res: int = 256,
        sam_size: int = 1024,
    ):
        self.root = root
        self.metas: List[Dict] = []
        self.mask_dicts: Dict[str, Dict] = {}
        for split in splits:
            ann = os.path.join(root, split, "meta_expressions.json")
            if not os.path.exists(ann):
                continue
            with open(ann) as f:
                videos = json.load(f)["videos"]
            mask_json = os.path.join(root, split, "mask_dict.json")
            if os.path.exists(mask_json):
                with open(mask_json) as f:
                    self.mask_dicts[split] = json.load(f)
            for vid, vd in videos.items():
                frames = sorted(vd["frames"])
                for exp_id, ed in vd["expressions"].items():
                    self.metas.append({
                        "split": split,
                        "video": vid,
                        "exp": ed["exp"],
                        "anno_id": [str(x) for x in ed.get("anno_id", [])],
                        "obj_id": ed.get("obj_id", []),
                        "frames": frames,
                    })
        self.num_frames_mllm = num_frames_mllm
        self.num_frames_sam = num_frames_sam
        self.mask_res = mask_res
        self.sam_size = sam_size

    def __len__(self):
        return len(self.metas)

    def _frame_mask(self, meta: Dict, frame_idx: int, hw) -> np.ndarray:
        mask = np.zeros(hw, np.float32)
        md = self.mask_dicts.get(meta["split"])
        if md is not None:
            for aid in meta["anno_id"]:
                anno = md.get(aid)
                if anno is not None and anno[frame_idx] is not None:
                    mask += rle_codec.decode(anno[frame_idx])
        else:
            # Refer-YTVOS layout: Annotations/<video>/<frame>.png palettes
            p = os.path.join(
                self.root, meta["split"], "Annotations", meta["video"],
                meta["frames"][frame_idx] + ".png",
            )
            if os.path.exists(p):
                from PIL import Image

                lab = np.asarray(Image.open(p))
                for oid in meta["obj_id"]:
                    mask += (lab == int(oid)).astype(np.float32)
        return (mask > 0).astype(np.float32)

    def sample(self) -> TrainSample:
        from PIL import Image

        meta = random.choice(self.metas)
        frames_names = meta["frames"]
        vid_len = len(frames_names)
        anchor = random.randrange(vid_len)
        idxs = sample_frame_indices(vid_len, self.num_frames_mllm, anchor)
        imgs = []
        for i in idxs:
            p = os.path.join(
                self.root, meta["split"], "JPEGImages", meta["video"],
                frames_names[i] + ".jpg",
            )
            imgs.append(np.asarray(Image.open(p).convert("RGB")))
        dense = random_dense_subset(self.num_frames_mllm, self.num_frames_sam)
        sam_frames = np.stack(
            [sam_preprocess_frame(imgs[i], self.sam_size)
             for i in dense]
        )
        hw = imgs[0].shape[:2]
        gt = np.stack([
            resize_mask(
                self._frame_mask(meta, idxs[i], hw), self.mask_res
            )
            for i in dense
        ])
        exp = " ".join(meta["exp"].lower().split())
        return TrainSample(
            sample_id=f"{meta['video']}",
            messages=seg_qa_messages(
                imgs, make_seg_question(exp), make_seg_answer()
            ),
            video_frames=imgs,
            sam_frames=sam_frames,
            gt_masks=gt,
            has_masks=True,
        )


class YTVOSDataset(TaskDataset):
    """Plain VOS (YTVOS/MOSE): meta.json with per-video objects; the
    question names the object category."""

    name = "vos"

    def __init__(
        self,
        root: str,
        split: str = "train",
        num_frames_mllm: int = 8,
        num_frames_sam: int = 4,
        mask_res: int = 256,
        sam_size: int = 1024,
    ):
        self.root = os.path.join(root, split)
        meta = os.path.join(self.root, "meta.json")
        self.items: List[Dict] = []
        if os.path.exists(meta):
            with open(meta) as f:
                videos = json.load(f)["videos"]
            for vid, vd in videos.items():
                for oid, od in vd["objects"].items():
                    self.items.append({
                        "video": vid,
                        "obj_id": oid,
                        "category": od.get("category", "object"),
                        "frames": od["frames"],
                    })
        self.num_frames_mllm = num_frames_mllm
        self.num_frames_sam = num_frames_sam
        self.mask_res = mask_res
        self.sam_size = sam_size

    def __len__(self):
        return len(self.items)

    def sample(self) -> TrainSample:
        from PIL import Image

        item = random.choice(self.items)
        names = item["frames"]
        idxs = sample_frame_indices(
            len(names), self.num_frames_mllm, random.randrange(len(names))
        )
        imgs, masks = [], []
        for i in idxs:
            img = np.asarray(Image.open(os.path.join(
                self.root, "JPEGImages", item["video"], names[i] + ".jpg"
            )).convert("RGB"))
            lab = np.asarray(Image.open(os.path.join(
                self.root, "Annotations", item["video"], names[i] + ".png"
            )))
            imgs.append(img)
            masks.append((lab == int(item["obj_id"])).astype(np.float32))
        dense = random_dense_subset(self.num_frames_mllm, self.num_frames_sam)
        sam_frames = np.stack(
            [sam_preprocess_frame(imgs[i], self.sam_size)
             for i in dense]
        )
        gt = np.stack([resize_mask(masks[i], self.mask_res) for i in dense])
        return TrainSample(
            sample_id=item["video"],
            messages=seg_qa_messages(
                imgs, make_seg_question(item["category"]), make_seg_answer()
            ),
            video_frames=imgs,
            sam_frames=sam_frames,
            gt_masks=gt,
            has_masks=True,
        )

"""Image segmentation datasets as pseudo-videos, counterpart of
`rga3_tpu/data/datasets/image_seg.py`: ReasonSeg (labelme polygons,
`get_mask_from_json`), the RefCOCO family (`REFER` / `G_REFER`) and
semantic segmentation over five sources (ADE20K, COCO-Stuff and Mapillary
label PNGs; PACO-LVIS and PASCAL-Part COCO annotations). Each draws from
Python's and numpy's global RNGs in the JAX package's order."""
from __future__ import annotations

import glob
import json
import os
import random
from typing import Dict

import numpy as np

from ..polygon import fill_poly, polylines
from ..templates import EXPLANATORY_QUESTION_LIST
from .base import TaskDataset, build_pseudo_video_sample, make_seg_answer, make_seg_question


def get_mask_from_json(json_path: str, height: int, width: int):
    """A ReasonSeg labelme JSON -> (mask, comments, is_sentence): the mask
    holds 1 on targets and 255 on "ignore" shapes ("flag" shapes are
    skipped), painted largest first, each shape as its closed outline and
    its fill. A file that is not UTF-8 is read as cp1252."""
    try:
        with open(json_path, "r") as f:
            anno = json.load(f)
    except UnicodeDecodeError:
        with open(json_path, "r", encoding="cp1252") as f:
            anno = json.load(f)
    shapes = anno["shapes"]
    comments = anno["text"]
    is_sentence = anno["is_sentence"]

    valid, areas = [], []
    for s in shapes:
        if s["label"].lower() == "flag":
            continue
        tmp = np.zeros((height, width), np.uint8)
        pts = np.asarray([s["points"]], np.int32)
        polylines(tmp, pts, 1)
        fill_poly(tmp, pts, 1)
        areas.append(tmp.sum())
        valid.append(s)
    mask = np.zeros((height, width), np.uint8)
    for idx in np.argsort(areas)[::-1]:
        s = valid[idx]
        value = 255 if "ignore" in s["label"].lower() else 1
        pts = np.asarray([s["points"]], np.int32)
        polylines(mask, pts, value)
        fill_poly(mask, pts, value)
    return mask, comments, is_sentence


class ReasonSegDataset(TaskDataset):
    """ReasonSeg train split: *.jpg + *.json pairs; optional explanatory
    answers with probability `explanatory`."""

    name = "reason_seg"

    def __init__(
        self,
        base_dir: str,
        split: str = "train",
        num_frames_mllm: int = 8,
        num_frames_sam: int = 4,
        explanatory: float = 0.1,
        mask_res: int = 256,
        sam_size: int = 1024,
    ):
        self.images = sorted(
            glob.glob(os.path.join(base_dir, "reason_seg", "ReasonSeg",
                                   split, "*.jpg"))
        )
        self.num_frames_mllm = num_frames_mllm
        self.num_frames_sam = num_frames_sam
        self.explanatory = explanatory
        self.mask_res = mask_res
        self.sam_size = sam_size

    def __len__(self):
        return len(self.images)

    def sample(self):
        from PIL import Image

        path = random.choice(self.images)
        img = np.asarray(Image.open(path).convert("RGB"))
        mask, comments, is_sentence = get_mask_from_json(
            path.replace(".jpg", ".json"), *img.shape[:2]
        )
        text = random.choice(comments) if isinstance(comments, list) else comments
        question = make_seg_question(text, long=is_sentence)
        if random.random() < self.explanatory:
            question = (
                question + " " + random.choice(EXPLANATORY_QUESTION_LIST)
            )
        return build_pseudo_video_sample(
            os.path.basename(path), img, (mask == 1).astype(np.float32),
            question, make_seg_answer(),
            self.num_frames_mllm, self.num_frames_sam,
            sam_size=self.sam_size, mask_res=self.mask_res,
        )


class ReferSegDataset(TaskDataset):
    """RefCOCO-family referring segmentation via the REFER index."""

    name = "refer_seg"

    def __init__(
        self,
        base_dir: str,
        datasets: str = "refcoco||refcoco+||refcocog",
        num_frames_mllm: int = 8,
        num_frames_sam: int = 4,
        mask_res: int = 256,
        sam_size: int = 1024,
    ):
        from ..grefer import G_REFER
        from ..refer import REFER

        self.refs = []
        for ds in datasets.split("||"):
            split_by = "umd" if ds == "refcocog" else "unc"
            try:
                # grefcoco rides the G_REFER API (multi-target / no-target
                # refs)
                api_cls = G_REFER if ds == "grefcoco" else REFER
                api = api_cls(
                    os.path.join(base_dir, "refer_seg"), ds, split_by
                )
                ref_ids = api.getRefIds(split="train")
                self.refs.append((ds, api, ref_ids))
            except FileNotFoundError:
                continue
        self.num_frames_mllm = num_frames_mllm
        self.num_frames_sam = num_frames_sam
        self.mask_res = mask_res
        self.sam_size = sam_size

    def __len__(self):
        return sum(len(r[2]) for r in self.refs)

    def sample(self):
        from PIL import Image

        ds, api, ref_ids = random.choice(self.refs)
        ref = api.loadRefs(random.choice(ref_ids))[0]
        img_info = api.Imgs[ref["image_id"]]
        img_dir = (
            "images/saiapr_tc-12" if ds == "refclef"
            else "images/mscoco/images/train2014"
        )
        path = os.path.join(api.data_root, img_dir, img_info["file_name"])
        img = np.asarray(Image.open(path).convert("RGB"))
        mask = api.get_mask(ref)
        sent = random.choice(ref["sentences"])["sent"]
        return build_pseudo_video_sample(
            f"{ds}_{ref['ref_id']}", img, mask.astype(np.float32),
            make_seg_question(sent), make_seg_answer(),
            self.num_frames_mllm, self.num_frames_sam,
            sam_size=self.sam_size, mask_res=self.mask_res,
        )


class SemSegDataset(TaskDataset):
    """Semantic segmentation as referring over five sources: ADE20K /
    COCO-Stuff / Mapillary (per-pixel label PNGs) and PACO-LVIS /
    Pascal-Part (COCO annotation jsons). Sources with missing data
    directories are skipped."""

    name = "sem_seg"

    def __init__(
        self,
        base_dir: str,
        sem_seg_data: str = "ade20k,cocostuff,mapillary,paco_lvis,pascal_part",
        num_frames_mllm: int = 8,
        num_frames_sam: int = 4,
        mask_res: int = 256,
        sam_size: int = 1024,
    ):
        self.base_dir = base_dir
        # label-PNG sources: name -> (classes, image paths, label paths)
        self.png_sources: Dict[str, tuple] = {}
        # COCO sources: name -> (class_map, img_ids, CocoIndex)
        self.coco_sources: Dict[str, tuple] = {}
        for ds in sem_seg_data.split(","):
            ds = ds.strip()
            init = getattr(self, f"_init_{ds}", None)
            if init is not None:
                init()
        self.sources = list(self.png_sources) + list(self.coco_sources)
        self.num_frames_mllm = num_frames_mllm
        self.num_frames_sam = num_frames_sam
        self.mask_res = mask_res
        self.sam_size = sam_size

    # -- label-PNG sources
    def _init_ade20k(self):
        base = os.path.join(self.base_dir, "ade20k")
        classes_file = os.path.join(base, "ade20k_classes.json")
        if not os.path.exists(classes_file):
            return
        with open(classes_file) as f:
            classes = json.load(f)
        images = sorted(
            glob.glob(os.path.join(base, "images", "training", "*.jpg"))
        )
        # rebuild rather than str.replace on the absolute path (a
        # base_dir containing "images" would be mangled)
        labels = [
            os.path.join(
                base, "annotations", "training",
                os.path.basename(p)[:-4] + ".png",
            )
            for p in images
        ]
        if images:
            self.png_sources["ade20k"] = (classes, images, labels)

    def _init_cocostuff(self):
        classes_file = os.path.join(
            self.base_dir, "cocostuff", "cocostuff_classes.txt"
        )
        if not os.path.exists(classes_file):
            return
        with open(classes_file) as f:
            classes = [
                line.strip().split(": ")[-1] for line in f.readlines()[1:]
            ]
        labels = sorted(
            glob.glob(
                os.path.join(self.base_dir, "cocostuff", "train2017", "*.png")
            )
        )
        # rebuild rather than str.replace the whole path (a base_dir
        # containing "cocostuff" elsewhere would be mangled)
        images = [
            os.path.join(
                self.base_dir, "coco", "train2017",
                os.path.basename(p)[:-4] + ".jpg",
            )
            for p in labels
        ]
        if images:
            self.png_sources["cocostuff"] = (classes, images, labels)

    def _init_mapillary(self):
        root = os.path.join(self.base_dir, "mapillary")
        cfg = os.path.join(root, "config_v2.0.json")
        if not os.path.exists(cfg):
            return
        with open(cfg) as f:
            classes = [x["readable"].lower() for x in json.load(f)["labels"]]
        labels = sorted(
            glob.glob(
                os.path.join(root, "training", "v2.0", "labels", "*.png")
            )
        )
        images = [
            os.path.join(
                root, "training", "images",
                os.path.basename(p)[:-4] + ".jpg",
            )
            for p in labels
        ]
        if images:
            self.png_sources["mapillary"] = (classes, images, labels)

    # -- COCO-annotation sources
    def _init_paco_lvis(self):
        path = os.path.join(
            self.base_dir, "vlpart", "paco", "annotations",
            "paco_lvis_v1_train.json",
        )
        if not os.path.exists(path):
            return
        from ..coco import CocoIndex

        api = CocoIndex(path)
        class_map = {}
        for cat in api.loadCats(api.getCatIds()):
            # "obj_(context):part_(context)" -> ("obj", "part"); plain
            # object names drop the "(context)"
            parts = cat["name"].strip().split(":")
            if len(parts) == 2:
                class_map[cat["id"]] = (
                    parts[0].split("_(")[0], parts[1].split("_(")[0]
                )
            else:
                class_map[cat["id"]] = parts[0].split("_(")[0]
        annotated = [i for i in api.getImgIds() if api.img_to_anns.get(i)]
        self.coco_sources["paco_lvis"] = (class_map, annotated, api)

    def _init_pascal_part(self):
        path = os.path.join(
            self.base_dir, "vlpart", "pascal_part", "train.json"
        )
        if not os.path.exists(path):
            return
        from ..coco import CocoIndex

        api = CocoIndex(path)
        class_map = {
            cat["id"]: tuple(cat["name"].strip().split(":"))
            for cat in api.loadCats(api.getCatIds())
        }
        annotated = [i for i in api.getImgIds() if api.img_to_anns.get(i)]
        self.coco_sources["pascal_part"] = (class_map, annotated, api)

    def __len__(self):
        return sum(len(s[1]) for s in self.png_sources.values()) + sum(
            len(s[1]) for s in self.coco_sources.values()
        )

    def _sample_png(self, ds: str):
        from PIL import Image

        classes, images, labels = self.png_sources[ds]
        ids = np.zeros((0,))
        for _ in range(50):
            i = random.randrange(len(images))
            label = np.asarray(Image.open(labels[i])).copy()
            if ds == "ade20k":
                # 0 -> ignore, shift classes down by one
                label[label == 0] = 255
                label = label.astype(np.int32) - 1
                label[label == 254] = 255
            elif ds == "cocostuff":
                # merged "-" classes are ignored
                for ci, c in enumerate(classes):
                    if "-" in c:
                        label[label == ci] = 255
            ids = np.unique(label)
            ids = ids[ids != 255]
            if len(ids):
                break
        if not len(ids):
            raise RuntimeError(
                f"sem_seg[{ds}]: no labeled pixels in 50 sampled images"
            )
        img = np.asarray(Image.open(images[i]).convert("RGB"))
        cls_id = int(random.choice(ids))
        mask = (label == cls_id).astype(np.float32)
        name = classes[cls_id] if cls_id < len(classes) else str(cls_id)
        return os.path.basename(images[i]), img, mask, name

    def _sample_coco(self, ds: str):
        from PIL import Image

        class_map, img_ids, api = self.coco_sources[ds]
        anns = []
        for _ in range(50):
            info = api.loadImgs([random.choice(img_ids)])[0]
            anns = api.loadAnns(api.getAnnIds(info["id"]))
            if anns:
                break
        if not anns:
            raise RuntimeError(
                f"sem_seg[{ds}]: no annotated images in 50 samples"
            )
        ann = random.choice(anns)
        file_name = info["file_name"]
        if ds == "pascal_part":
            file_name = os.path.join(
                "VOCdevkit", "VOC2010", "JPEGImages", file_name
            )
            path = os.path.join(self.base_dir, "vlpart", ds, file_name)
        else:
            path = os.path.join(self.base_dir, "coco", file_name)
        img = np.asarray(Image.open(path).convert("RGB"))
        mask = api.annToMask(ann).astype(np.float32)
        cls = class_map[ann["category_id"]]
        if isinstance(cls, tuple):  # part phrasing
            obj, part = cls
            name = (
                f"{obj} {part}" if random.random() < 0.5
                else f"the {part} of the {obj}"
            )
        else:
            name = cls
        return os.path.basename(path), img, mask, name

    def sample(self):
        ds = random.choice(self.sources)
        if ds in self.png_sources:
            sid, img, mask, name = self._sample_png(ds)
        else:
            sid, img, mask, name = self._sample_coco(ds)
        return build_pseudo_video_sample(
            sid, img, mask,
            make_seg_question(name), make_seg_answer(),
            self.num_frames_mllm, self.num_frames_sam,
            sam_size=self.sam_size, mask_res=self.mask_res,
        )

"""QA datasets without segmentation supervision, counterpart of
`rga3_tpu/data/datasets/qa.py`: LLaVA-Instruct images (`VQADataset`),
LLaVA-Video clips (`VideoQADataset`, mp4 decoded with OpenCV), VideoInfer
region QA with a drawn overlay on one key frame (`ReferVideoQADataset`),
and Osprey / ViP-LLaVA region QA with visual prompts (`ReferVQADataset`).
Their samples carry `has_masks=False` and all-zero uint8 SAM frames.
"""
from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Sequence

import numpy as np

from ...utils import rle as rle_codec
from ..collate import TrainSample
from ..processor import ChatMessage
from ..templates import VISUAL_PROMPT, WORDS_SHAPE
from ..visual_prompts import COLOR_POOL, image_blending
from .base import TaskDataset


def _qa_messages(content_type: str, turns: Sequence[Dict]) -> List[ChatMessage]:
    """turns: [{"from": "human"/"gpt", "value": ...}] LLaVA style."""
    msgs: List[ChatMessage] = []
    first_user = True
    for t in turns:
        text = t["value"].replace("<image>", "").replace("<video>", "").strip()
        if t["from"] == "human":
            content = []
            if first_user:
                content.append({"type": content_type})
                first_user = False
            content.append({"type": "text", "text": text})
            msgs.append(ChatMessage("user", content))
        else:
            msgs.append(
                ChatMessage("assistant", [{"type": "text", "text": text}])
            )
    return msgs


def _dummy_sam(num_frames_sam: int, sam_size: int, mask_res: int):
    # uint8 like every real dataset's sam_frames (collate stacks across
    # the hybrid batch); these samples carry masks_valid=0 so the SAM
    # branch's output is zero-weighted either way
    frames = np.zeros((num_frames_sam, sam_size, sam_size, 3), np.uint8)
    gt = np.zeros((num_frames_sam, mask_res, mask_res), np.float32)
    return frames, gt


class VQADataset(TaskDataset):
    """LLaVA-Instruct-150k."""

    name = "vqa"

    def __init__(
        self,
        base_dir: str,
        json_name: str = "llava_instruct_150k.json",
        image_dir: str = "coco/train2017",
        num_frames_mllm: int = 8,
        num_frames_sam: int = 4,
        sam_size: int = 1024,
        mask_res: int = 256,
    ):
        path = os.path.join(base_dir, "llava_dataset", json_name)
        self.items = []
        if os.path.exists(path):
            with open(path) as f:
                self.items = json.load(f)
        self.image_dir = os.path.join(base_dir, image_dir)
        self.num_frames_sam = num_frames_sam
        self.sam_size = sam_size
        self.mask_res = mask_res

    def __len__(self):
        return len(self.items)

    def sample(self) -> TrainSample:
        from PIL import Image

        item = random.choice(self.items)
        img = np.asarray(
            Image.open(
                os.path.join(self.image_dir, item["image"])
            ).convert("RGB")
        )
        frames, gt = _dummy_sam(
            self.num_frames_sam, self.sam_size, self.mask_res
        )
        return TrainSample(
            sample_id=str(item.get("id", "vqa")),
            messages=_qa_messages("image", item["conversations"]),
            images=[img],
            sam_frames=frames,
            gt_masks=gt,
            has_masks=False,
        )


class VideoQADataset(TaskDataset):
    """LLaVA-Video-178K style: json items with video paths."""

    name = "videoqa"

    def __init__(
        self,
        base_dir: str,
        json_name: str = "llava_video_178k.json",
        video_dir: str = "videos",
        num_frames_mllm: int = 8,
        num_frames_sam: int = 4,
        sam_size: int = 1024,
        mask_res: int = 256,
    ):
        path = os.path.join(base_dir, "llava_video", json_name)
        self.items = []
        if os.path.exists(path):
            with open(path) as f:
                self.items = json.load(f)
        self.video_dir = os.path.join(base_dir, "llava_video", video_dir)
        self.num_frames_mllm = num_frames_mllm
        self.num_frames_sam = num_frames_sam
        self.sam_size = sam_size
        self.mask_res = mask_res

    def __len__(self):
        return len(self.items)

    def sample(self) -> TrainSample:
        from ..video import load_frames_from_video

        item = random.choice(self.items)
        frames, _, fps = load_frames_from_video(
            os.path.join(self.video_dir, item["video"]),
            num_frames=self.num_frames_mllm,
        )
        sam_frames, gt = _dummy_sam(
            self.num_frames_sam, self.sam_size, self.mask_res
        )
        return TrainSample(
            sample_id=str(item.get("id", "videoqa")),
            messages=_qa_messages("video", item["conversations"]),
            video_frames=frames,
            sam_frames=sam_frames,
            gt_masks=gt,
            has_masks=False,
        )


class ReferVideoQADataset(TaskDataset):
    """VideoInfer train split: RLE object masks; ONE random key frame gets
    a random shape/color overlay; the question is prefixed with the
    VISUAL_PROMPT sentence."""

    name = "refer_videoqa"

    def __init__(
        self,
        base_dir: str,
        json_name: str = "videoinfer_train.json",
        num_frames_mllm: int = 8,
        num_frames_sam: int = 4,
        sam_size: int = 1024,
        mask_res: int = 256,
    ):
        path = os.path.join(base_dir, "videoinfer", json_name)
        self.items = []
        if os.path.exists(path):
            with open(path) as f:
                self.items = json.load(f)
        self.base = os.path.join(base_dir, "videoinfer")
        self.num_frames_mllm = num_frames_mllm
        self.num_frames_sam = num_frames_sam
        self.sam_size = sam_size
        self.mask_res = mask_res

    def __len__(self):
        return len(self.items)

    def sample(self) -> TrainSample:
        from PIL import Image

        item = random.choice(self.items)
        frame_dir = os.path.join(self.base, "frames", item["video"])
        names = sorted(os.listdir(frame_dir))
        idxs = sorted(
            random.sample(
                range(len(names)), min(self.num_frames_mllm, len(names))
            )
        )
        frames = [
            np.asarray(
                Image.open(os.path.join(frame_dir, names[i])).convert("RGB")
            )
            for i in idxs
        ]
        # overlay a random keyframe with the object mask
        key = random.randrange(len(frames))
        masks_rle = item.get("masks", {})
        key_mask = None
        frame_key = os.path.splitext(names[idxs[key]])[0]
        if frame_key in masks_rle and masks_rle[frame_key] is not None:
            key_mask = rle_codec.decode(masks_rle[frame_key])
        shape = random.choice(list(WORDS_SHAPE.keys()))
        color = random.choice(list(COLOR_POOL.keys()))
        if key_mask is not None and key_mask.sum() > 0:
            blended, _ = image_blending(
                Image.fromarray(frames[key]), shape=shape, mask=key_mask,
                rgb_value=COLOR_POOL[color], image_size_anchor=448,
            )
            frames[key] = np.asarray(blended)
        prep, shape_word = WORDS_SHAPE[shape]
        prefix = VISUAL_PROMPT.format(
            prep=prep, color=color, shape=shape_word
        )
        turns = [dict(t) for t in item["conversations"]]
        if turns and turns[0]["from"] == "human":
            turns[0]["value"] = prefix + turns[0]["value"]
        sam_frames, gt = _dummy_sam(
            self.num_frames_sam, self.sam_size, self.mask_res
        )
        return TrainSample(
            sample_id=str(item.get("id", "refer_videoqa")),
            messages=_qa_messages("video", turns),
            video_frames=frames,
            sam_frames=sam_frames,
            gt_masks=gt,
            has_masks=False,
        )


class ReferVQADataset(TaskDataset):
    """Region-level image QA: Osprey-724K conversations and ViP-LLaVA
    stage-2/3 instruct data, with instance visual prompts rasterized by
    `vip_processor`. The first user turn
    is prefixed with REFERRING_VQA_PROMPT; masks are the zero sentinel."""

    name = "refer_vqa"

    def __init__(
        self,
        base_dir: str,
        ref_vqa_dataset: str = "vip_llava_stage2-3",
        num_frames_mllm: int = 8,
        num_frames_sam: int = 4,
        sam_size: int = 1024,
        mask_res: int = 256,
    ):
        self.metas: List[Dict] = []
        if ref_vqa_dataset == "osprey":
            self.img_folder = os.path.join(base_dir, "coco", "train2014")
            path = os.path.join(
                base_dir, "Osprey-724K", "osprey_conversation.json"
            )
            if os.path.exists(path):
                with open(path) as f:
                    items = json.load(f)
                for idx, sample in enumerate(items):
                    # id + bboxes/segmentations from the
                    # region annotations
                    sample = dict(sample)
                    sample["id"] = f"osprey-conv-{idx}"
                    regions = sample.pop("annotation", [])
                    sample["segmentations"] = [
                        r["segmentation"] for r in regions
                    ]
                    sample["bboxes"] = [
                        [
                            r["bbox"][0], r["bbox"][1],
                            r["bbox"][0] + r["bbox"][2],
                            r["bbox"][1] + r["bbox"][3],
                        ]
                        for r in regions
                    ]
                    self.metas.append({
                        "image": sample["file_name"],
                        "line": sample,
                        "visual_prompt": bool(sample["bboxes"]),
                    })
        else:  # vip_llava_stage{2,3,2-3}
            stage = ref_vqa_dataset.split("_")[-1]
            root = os.path.join(base_dir, "ViP-LLaVA-Instruct")
            self.img_folder = root
            for s in ("2", "3"):
                if s not in stage:
                    continue
                path = os.path.join(root, f"vip-llava_stage{s}_mix.json")
                if not os.path.exists(path):
                    continue
                with open(path) as f:
                    samples = json.load(f)
                for sample in samples:  # filtering
                    if "image" not in sample or "conversations" not in sample:
                        continue
                    img = sample["image"]
                    if ("vg" not in img and "ocr_vqa" not in img
                            and "gqa" not in img
                            and "refcoco" not in str(sample.get("id", ""))):
                        continue
                    self.metas.append({
                        "image": img,
                        "line": sample,
                        "visual_prompt": (
                            "bboxes" in sample or "segmentations" in sample
                        ),
                    })
        self.num_frames_sam = num_frames_sam
        self.sam_size = sam_size
        self.mask_res = mask_res

    def __len__(self):
        return len(self.metas)

    def sample(self) -> TrainSample:
        import copy

        from PIL import Image

        from ..templates import REFERRING_VQA_PROMPT
        from ..visual_prompts.organizer import vip_processor

        meta = random.choice(self.metas)
        img = Image.open(
            os.path.join(self.img_folder, meta["image"])
        ).convert("RGB")
        if meta["visual_prompt"]:
            # Route rows by their id prefix: ViP-LLaVA's stage-2 mix
            # includes vcr-/flickr30k-/v7w-/pointQA_twice-/refcocog-/
            # vg_rel- rows that the organizer builds from raw fields; rows
            # without a known prefix carry pre-built conversations and take the
            # marker-substitution path ("vip_llava").
            from ..visual_prompts.organizer import VISUAL_PROMPT_CONFIG

            rid = str(meta["line"].get("id", ""))
            prefix = rid.split("-")[0]
            dtype = (
                prefix if prefix in VISUAL_PROMPT_CONFIG else "vip_llava"
            )
            # malformed rows (IndexError / KeyError) resample instead of
            # killing the run
            for _ in range(10):
                try:
                    img, turns = vip_processor(
                        copy.deepcopy(meta["line"]), img, min(img.size),
                        dataset_type=dtype, image_folder=self.img_folder,
                    )
                    break
                except (IndexError, KeyError):
                    meta = random.choice(self.metas)
                    img = Image.open(
                        os.path.join(self.img_folder, meta["image"])
                    ).convert("RGB")
                    if not meta["visual_prompt"]:
                        turns = meta["line"]["conversations"]
                        break
                    rid = str(meta["line"].get("id", ""))
                    prefix = rid.split("-")[0]
                    dtype = (
                        prefix if prefix in VISUAL_PROMPT_CONFIG
                        else "vip_llava"
                    )
            else:
                raise RuntimeError(
                    "refer_vqa: 10 consecutive malformed rows"
                )
        else:
            turns = meta["line"]["conversations"]
        turns = [dict(t) for t in turns]
        if turns and turns[0]["from"] != "human":
            turns = turns[1:]
        if turns:
            turns[0]["value"] = REFERRING_VQA_PROMPT.format(
                text=turns[0]["value"].replace("<image>", "").strip()
            )
        sam_frames, gt = _dummy_sam(
            self.num_frames_sam, self.sam_size, self.mask_res
        )
        return TrainSample(
            sample_id=str(meta["line"].get("id", "refer_vqa")),
            messages=_qa_messages("image", turns),
            images=[np.asarray(img)],
            sam_frames=sam_frames,
            gt_masks=gt,
            has_masks=False,
        )

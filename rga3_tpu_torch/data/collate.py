"""Batch collation: chat-templated tokenization, assistant-span label
masking, vision patchification, SAM frame stacking, M-RoPE positions. The
port's own copy of `rga3_tpu/data/collate.py`: host numpy code, array for
array the same output.

Labels are input_ids with everything masked to IGNORE_INDEX except the
assistant spans (from <|im_start|>assistant\\n + 1 through <|im_end|>
inclusive) and the pads.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..models.qwen25vl.config import IM_END_TOKEN_ID, IM_START_TOKEN_ID, Qwen25VLConfig
from ..models.qwen25vl.positions import get_rope_index
from .processor import ChatMessage, QwenVLProcessor

IGNORE_INDEX = -100


@dataclass
class TrainSample:
    """One sample produced by a task dataset."""

    sample_id: str
    messages: List[ChatMessage]  # full conversation incl. assistant turns
    # vision inputs for the MLLM (one video OR a list of images)
    video_frames: Optional[List[np.ndarray]] = None  # RGB uint8 frames
    images: List[np.ndarray] = field(default_factory=list)
    video_fps: float = 2.0
    # SAM side: (T, H, W, 3) uint8 resized frames, normalized on the device
    sam_frames: Optional[np.ndarray] = None
    gt_masks: Optional[np.ndarray] = None  # (T, h, w) float 0/1
    has_masks: bool = True  # False = VQA-only sample (zero-mask sentinel)


def mask_labels(input_ids: np.ndarray, tokenizer, pad_token_id: int) -> np.ndarray:
    """Assistant-span label masking; the first (system) block is skipped."""
    assistant_id = tokenizer.convert_tokens_to_ids("assistant")
    labels = np.full_like(input_ids, IGNORE_INDEX)
    for b in range(input_ids.shape[0]):
        ids = input_ids[b]
        starts = np.where(ids == IM_START_TOKEN_ID)[0]
        ends = np.where(ids == IM_END_TOKEN_ID)[0]
        for start, end in zip(starts[1:], ends[1:]):
            if start + 1 >= len(ids):
                continue
            if ids[start + 1] == assistant_id:
                labels[b, start + 3: end + 1] = ids[start + 3: end + 1]
    labels[input_ids == pad_token_id] = IGNORE_INDEX
    return labels


def collate(
    batch: Sequence[TrainSample],
    processor: QwenVLProcessor,
    cfg: Qwen25VLConfig,
    pad_to_multiple: int = 64,
    vision_budget_tokens: Optional[int] = None,
) -> Dict[str, Any]:
    """Collate TrainSamples into the train forward's inputs (numpy).

    Each sample's patches are concatenated, sample-major, in the order its
    vision-pad tokens appear over the flattened batch; with
    `vision_budget_tokens` they are padded to that many patches
    (`pixel_patches`, `vision_layout`, as `vision.pad_vision_inputs`)."""
    per_sample = []
    all_video_patches, video_grids, spg = [], [], []
    all_image_patches, image_grids = [], []
    combined_patches, combined_grids = [], []
    for s in batch:
        videos = [s.video_frames] if s.video_frames is not None else []
        out = processor(s.messages, images=[[im] for im in s.images], videos=videos,
                        video_fps=s.video_fps, add_generation_prompt=False)
        per_sample.append(out)
        if "pixel_values" in out:
            all_image_patches.append(out["pixel_values"])
            image_grids.extend(out["image_grid_thw"])
            combined_patches.append(out["pixel_values"])
            combined_grids.extend(out["image_grid_thw"])
        if "pixel_values_videos" in out:
            all_video_patches.append(out["pixel_values_videos"])
            video_grids.extend(out["video_grid_thw"])
            spg.extend(out["second_per_grid_ts"])
            combined_patches.append(out["pixel_values_videos"])
            combined_grids.extend(out["video_grid_thw"])

    pad_id = processor.tokenizer.pad_token_id or 151643
    max_len = max(o["input_ids"].shape[1] for o in per_sample)
    max_len = -(-max_len // pad_to_multiple) * pad_to_multiple
    b = len(batch)
    input_ids = np.full((b, max_len), pad_id, np.int32)
    attention_mask = np.zeros((b, max_len), np.int64)
    for i, o in enumerate(per_sample):
        n = o["input_ids"].shape[1]
        input_ids[i, :n] = o["input_ids"][0]
        attention_mask[i, :n] = 1

    labels = mask_labels(input_ids, processor.tokenizer, pad_id)
    position_ids, rope_deltas = get_rope_index(
        cfg, input_ids, image_grid_thw=image_grids or None,
        video_grid_thw=video_grids or None, second_per_grid_ts=spg or None,
        attention_mask=attention_mask,
    )
    out: Dict[str, Any] = {
        "input_ids": input_ids,
        "attention_mask": attention_mask,
        "labels": labels,
        "position_ids": position_ids.astype(np.int32),
        "rope_deltas": rope_deltas,
    }
    if all_video_patches:
        out["pixel_values_videos"] = np.concatenate(all_video_patches, 0)
        out["video_grid_thw"] = video_grids
        out["second_per_grid_ts"] = spg
    if all_image_patches:
        out["pixel_values"] = np.concatenate(all_image_patches, 0)
        out["image_grid_thw"] = image_grids

    if vision_budget_tokens is not None and combined_patches:
        from ..models.qwen25vl.vision import compute_vision_layout, pad_vision_inputs

        layout = compute_vision_layout(combined_grids, cfg.vision)
        padded, layout_args = pad_vision_inputs(
            np.concatenate(combined_patches, 0), layout, cfg.vision, vision_budget_tokens)
        out["pixel_patches"] = padded
        out["vision_layout"] = layout_args

    if batch[0].sam_frames is not None:
        out["images_sam"] = np.stack([s.sam_frames for s in batch])
        # gt masks padded to one canvas; masks_valid weights the samples
        hs = max(s.gt_masks.shape[-2] for s in batch)
        ws = max(s.gt_masks.shape[-1] for s in batch)
        t = batch[0].gt_masks.shape[0]
        gt = np.zeros((b, t, hs, ws), np.float32)
        for i, s in enumerate(batch):
            g = s.gt_masks
            gt[i, :, : g.shape[-2], : g.shape[-1]] = g
        out["gt_masks"] = gt
        out["masks_valid"] = np.asarray([1.0 if s.has_masks else 0.0 for s in batch],
                                        np.float32)
    return out

"""Shared machinery of the training datasets, counterpart of
`rga3_tpu/data/datasets/base.py`. Host numpy and PIL, as the JAX package's:
a sample must be the same bytes in both packages.

  * SAM frames: PIL's resize to (size, size), kept uint8 (the model
    normalizes them on the device);
  * an image dataset repeats its still image into num_frames_sam pseudo-video
    frames (and num_frames_mllm for the MLLM);
  * questions and answers from the template lists, drawn from Python's
    global `random`; answers carry [SEG];
  * gt masks are nearest-resized to a fixed (mask_res, mask_res) canvas.
"""
from __future__ import annotations

import random
from typing import List, Sequence

import numpy as np

from ..collate import TrainSample
from ..processor import ChatMessage
from ..templates import ANSWER_LIST, LONG_QUESTION_LIST, SHORT_QUESTION_LIST


def sam_preprocess_frame(frame: np.ndarray, size: int = 1024) -> np.ndarray:
    """HWC uint8 -> (size, size, 3) uint8, PIL's default (bicubic) resize."""
    from PIL import Image

    return np.asarray(Image.fromarray(frame).resize((size, size)))


def resize_mask(mask: np.ndarray, res: int) -> np.ndarray:
    """Nearest-resize a binary mask to (res, res) float32 0/1."""
    from PIL import Image

    return np.asarray(
        Image.fromarray((mask > 0).astype(np.uint8)).resize((res, res), Image.NEAREST),
        np.float32,
    )


def seg_qa_messages(frames: Sequence[np.ndarray], question: str,
                    answer: str) -> List[ChatMessage]:
    return [
        ChatMessage("user", [{"type": "video"}, {"type": "text", "text": question}]),
        ChatMessage("assistant", [{"type": "text", "text": answer}]),
    ]


def make_seg_question(text: str, long: bool = False) -> str:
    if long:
        return random.choice(LONG_QUESTION_LIST).format(sent=text)
    return random.choice(SHORT_QUESTION_LIST).format(class_name=text.lower())


def make_seg_answer() -> str:
    return random.choice(ANSWER_LIST)


def random_dense_subset(num_frames_mllm: int, num_frames_sam: int) -> List[int]:
    """A random sorted subset of the MLLM frames for SAM (numpy's global RNG)."""
    return sorted(np.random.choice(num_frames_mllm, size=num_frames_sam, replace=False).tolist())


class TaskDataset:
    """A dataset of one task: the mixer calls `sample()`, which draws a
    random item from the global RNGs."""

    name = "base"

    def __len__(self) -> int:
        raise NotImplementedError

    def sample(self) -> TrainSample:
        raise NotImplementedError


def build_pseudo_video_sample(sample_id: str, image: np.ndarray, mask: np.ndarray,
                              question: str, answer: str, num_frames_mllm: int,
                              num_frames_sam: int, sam_size: int = 1024,
                              mask_res: int = 256) -> TrainSample:
    """An image (HWC uint8) and its (H, W) binary mask as a pseudo-video
    sample: the image repeated over the frames."""
    sam_frame = sam_preprocess_frame(image, sam_size)
    sam_frames = np.repeat(sam_frame[None], num_frames_sam, axis=0)
    gt = np.repeat(resize_mask(mask, mask_res)[None], num_frames_sam, axis=0)
    frames = [image] * num_frames_mllm
    return TrainSample(
        sample_id=sample_id,
        messages=seg_qa_messages(frames, question, answer),
        video_frames=frames,
        sam_frames=sam_frames,
        gt_masks=gt,
        has_masks=True,
    )

"""Prompt templates and frame-index samplers: the port's own copy of
`rga3_tpu/data/templates.py`. The question and answer lists are the
training data's text, string for string: a sample's messages must match the
JAX package's to the byte."""
from __future__ import annotations

from typing import List

import numpy as np

SHORT_QUESTION_LIST = [
    "Can you segment the {class_name} in this image?",
    "Please segment the {class_name} in this image.",
    "What is {class_name} in this image? Please respond with segmentation mask.",
    "What is {class_name} in this image? Please output segmentation mask.",
]

LONG_QUESTION_LIST = [
    "{sent} Please respond with segmentation mask.",
    "{sent} Please output segmentation mask.",
]

EXPLANATORY_QUESTION_LIST = [
    "Please output segmentation mask and explain why.",
    "Please output segmentation mask and explain the reason.",
    "Please output segmentation mask and give some explanation.",
]

ANSWER_LIST = [
    "It is [SEG].",
    "Sure, [SEG].",
    "Sure, it is [SEG].",
    "Sure, the segmentation result is [SEG].",
    "[SEG].",
]

VISUAL_PROMPT = (
    "Look at the marked region {prep} the {color} {shape} in the video and "
    "then answer the question. "
)
REFERRING_VQA_PROMPT = (
    "Look at the marked region and then answer the question. {text}"
)

WORDS_SHAPE = {
    "rectangle": ["within", "rectangle"],
    "ellipse": ["within", "ellipse"],
    "triangle": ["with", "triangle"],
    "point": ["at", "point"],
    "scribble": ["with", "scribble"],
    "mask contour": ["with", "mask contour"],
    "mask": ["with", "mask"],
    "arrow": ["pointed to by", "arrow"],
}


def uniform_sample(total_len: int, sample_num: int) -> List[int]:
    intervals = np.linspace(0, total_len, sample_num + 1).astype(int)
    return [
        int((intervals[i] + intervals[i + 1] - 1) // 2)
        for i in range(sample_num)
    ]


def get_sparse_indices(total_frame_num: int, num_frames_mllm: int) -> List[int]:
    if total_frame_num > num_frames_mllm:
        return sorted(uniform_sample(total_frame_num, num_frames_mllm))
    num_repeat = num_frames_mllm // total_frame_num
    num_sample = num_frames_mllm % total_frame_num
    idxs = list(range(total_frame_num)) * num_repeat + uniform_sample(
        total_frame_num, num_sample
    )
    return sorted(idxs)

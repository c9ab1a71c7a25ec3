"""Frame-index samplers and prompt templates: the port's own copy of the
parts of `rga3_tpu/data/templates.py` it uses."""
from __future__ import annotations

from typing import List

import numpy as np

REFERRING_VQA_PROMPT = (
    "Look at the marked region and then answer the question. {text}"
)


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

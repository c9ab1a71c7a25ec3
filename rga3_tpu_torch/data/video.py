"""Video frame loading, counterpart of `rga3_tpu/data/video.py`.
`load_frames_from_video` decodes a video file with OpenCV (`cv2`, imported
when called); `load_frames_from_dir` reads a directory of frame images (the
VOS benchmarks' layout) with PIL."""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .templates import get_sparse_indices


def load_frames_from_video(video_path: str, num_frames: Optional[int] = None,
                           sample_fps: Optional[float] = None
                           ) -> Tuple[List[np.ndarray], List[int], float]:
    """(RGB uint8 frames, their indices, the native fps): `num_frames`
    sampled uniformly (`get_sparse_indices`), or every frame at about
    `sample_fps`, or every frame. Frames are grabbed in order and decoded
    only where wanted."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(video_path)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    if num_frames is not None:
        idxs = get_sparse_indices(total, num_frames)
    elif sample_fps is not None:
        idxs = list(range(0, total, max(1, round(fps / sample_fps))))
    else:
        idxs = list(range(total))
    want = sorted(set(idxs))
    got = {}
    pos = 0
    for i in range(total):
        if pos >= len(want) or not cap.grab():
            break
        if i == want[pos]:
            ok, frame = cap.retrieve()
            if not ok:
                break
            got[i] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            pos += 1
    cap.release()
    return [got[i] for i in idxs if i in got], idxs, fps


def load_frames_from_dir(frames_dir: str,
                         indices: Optional[Sequence[int]] = None) -> List[np.ndarray]:
    """RGB uint8 frames of the .jpg / .jpeg / .png files of a directory in
    name order, or of the `indices` among them."""
    from PIL import Image

    names = sorted(f for f in os.listdir(frames_dir)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")))
    if indices is not None:
        names = [names[i] for i in indices]
    return [np.asarray(Image.open(os.path.join(frames_dir, f)).convert("RGB")) for f in names]

"""M-RoPE position ids (host-side numpy): the port's own copy of
`rga3_tpu/models/qwen25vl/positions.py` (HF `get_rope_index` for
Qwen2.5-VL). Text tokens advance all three streams together; vision spans
get (temporal, row, col) positions, video temporal steps scaled by
`second_per_grid_ts * tokens_per_second`."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .config import Qwen25VLConfig


def get_rope_index(
    cfg: Qwen25VLConfig,
    input_ids: np.ndarray,  # (B, L)
    image_grid_thw: Optional[Sequence[Tuple[int, int, int]]] = None,
    video_grid_thw: Optional[Sequence[Tuple[int, int, int]]] = None,
    second_per_grid_ts: Optional[Sequence[float]] = None,
    attention_mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (position_ids (3, B, L), rope_deltas (B,))."""
    b, l = input_ids.shape
    sms = cfg.vision.spatial_merge_size
    tps = cfg.vision.tokens_per_second
    if attention_mask is None:
        attention_mask = np.ones_like(input_ids)
    position_ids = np.zeros((3, b, l), dtype=np.int64)
    rope_deltas = np.zeros((b,), dtype=np.int64)
    img_iter = iter(image_grid_thw or [])
    vid_iter = iter(video_grid_thw or [])
    spg_iter = iter(second_per_grid_ts or [])

    for bi in range(b):
        ids = input_ids[bi][attention_mask[bi] == 1]
        chunks: List[np.ndarray] = []
        st, st_idx, n = 0, 0, len(ids)
        while st < n:
            is_vis = (ids[st:] == cfg.image_token_id) | (
                ids[st:] == cfg.video_token_id
            )
            nxt = int(np.argmax(is_vis)) if is_vis.any() else len(is_vis)
            if nxt > 0:
                chunks.append(np.tile(st_idx + np.arange(nxt), (3, 1)))
                st_idx += nxt
                st += nxt
                if not is_vis.any():
                    break
                continue
            if ids[st] == cfg.image_token_id:
                t, h, w = next(img_iter)
                spg = 0.0
            else:
                t, h, w = next(vid_iter)
                spg = float(next(spg_iter, 1.0))
            lt, lh, lw = int(t), int(h) // sms, int(w) // sms
            # HF casts second_per_grid_t to int64 before multiplying
            t_idx = np.repeat(
                (np.arange(lt) * int(spg) * tps).astype(np.int64), lh * lw
            )
            h_idx = np.tile(np.repeat(np.arange(lh), lw), lt)
            w_idx = np.tile(np.tile(np.arange(lw), lh), lt)
            chunks.append(np.stack([t_idx, h_idx, w_idx]) + st_idx)
            st_idx = int(chunks[-1].max()) + 1
            st += lt * lh * lw
        pos = np.concatenate(chunks, axis=1) if chunks else np.zeros((3, 0), np.int64)
        sel = np.where(attention_mask[bi] == 1)[0]
        position_ids[:, bi, sel] = pos
        rope_deltas[bi] = (pos.max() + 1 if pos.size else 0) - len(ids)
    return position_ids, rope_deltas

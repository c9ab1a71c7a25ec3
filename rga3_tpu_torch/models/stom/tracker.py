"""Point trackers for STOM (counterpart of
`rga3_tpu/models/stom/tracker.py`).

The tracker interface STOM consumes: `track(frames, query_mask,
query_frame_idx, grid_size) -> (tracks (T, N, 2) xy, visibility (T, N)
bool)`. Two backends have it:

  * `cotracker3.CoTracker3Predictor`, the whole-clip point tracker, on the
    card;
  * `LKTracker`, pyramidal Lucas-Kanade on the host (OpenCV's
    `calcOpticalFlowPyrLK`, imported when it tracks), chained frame to frame
    from the query frame forward and backward. A point that loses its
    track stays lost; STOM consumes only robust averages over the points.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def sample_grid_points_in_mask(mask: np.ndarray, grid_size: int = 100) -> np.ndarray:
    """Regular grid_size x grid_size lattice over the image, keeping points
    inside the mask (CoTrackerPredictor's segm_mask grid semantics)."""
    h, w = mask.shape
    ys = np.linspace(0, h - 1, grid_size)
    xs = np.linspace(0, w - 1, grid_size)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)
    keep = mask[pts[:, 1].astype(int), pts[:, 0].astype(int)] > 0
    return pts[keep].astype(np.float32)


class LKTracker:
    """Pyramidal LK (window `win_size`, `max_level` pyramid levels) on the
    frames' grey levels."""

    def __init__(self, win_size: int = 21, max_level: int = 3):
        self.win_size = win_size
        self.max_level = max_level

    def _chain(self, grays: List[np.ndarray], pts0: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Track pts0 from grays[0] through the frames in order: a point is
        visible while LK has found it at every step and it lies in the
        frame."""
        import cv2

        n = len(pts0)
        tracks = np.zeros((len(grays), n, 2), np.float32)
        vis = np.zeros((len(grays), n), bool)
        tracks[0] = pts0
        vis[0] = True
        cur = pts0.reshape(-1, 1, 2).astype(np.float32)
        alive = np.ones(n, bool)
        for t in range(1, len(grays)):
            nxt, st, _ = cv2.calcOpticalFlowPyrLK(
                grays[t - 1], grays[t], cur, None,
                winSize=(self.win_size, self.win_size), maxLevel=self.max_level)
            alive = alive & st.reshape(-1).astype(bool)
            cur = nxt
            tracks[t] = nxt.reshape(-1, 2)
            h, w = grays[t].shape
            inb = ((tracks[t, :, 0] >= 0) & (tracks[t, :, 0] < w)
                   & (tracks[t, :, 1] >= 0) & (tracks[t, :, 1] < h))
            vis[t] = alive & inb
        return tracks, vis

    def track_points(self, frames: Sequence[np.ndarray], pts: np.ndarray,
                     query_frame_idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """Track explicit (N, 2) points of frame `query_frame_idx` forward
        and backward through (H, W, 3) RGB uint8 frames; returns (tracks (T,
        N, 2), vis (T, N) bool)."""
        import cv2

        grays = [cv2.cvtColor(f, cv2.COLOR_RGB2GRAY) for f in frames]
        t = len(frames)
        if len(pts) == 0:
            return np.zeros((t, 0, 2), np.float32), np.zeros((t, 0), bool)
        fwd_tracks, fwd_vis = self._chain(grays[query_frame_idx:], pts)
        bwd_tracks, bwd_vis = self._chain(grays[:query_frame_idx + 1][::-1], pts)
        tracks = np.zeros((t, len(pts), 2), np.float32)
        vis = np.zeros((t, len(pts)), bool)
        tracks[query_frame_idx:] = fwd_tracks
        vis[query_frame_idx:] = fwd_vis
        tracks[:query_frame_idx + 1] = bwd_tracks[::-1]
        vis[:query_frame_idx + 1] = bwd_vis[::-1]
        return tracks, vis

    def track(self, frames: Sequence[np.ndarray], query_mask: np.ndarray,
              query_frame_idx: int, grid_size: int = 100) -> Tuple[np.ndarray, np.ndarray]:
        pts = sample_grid_points_in_mask(query_mask, grid_size)
        return self.track_points(frames, pts, query_frame_idx)

"""Query points for STOM's tracker (counterpart of
`rga3_tpu/models/stom/tracker.py`).

The tracker interface STOM consumes: `track(frames, query_mask,
query_frame_idx, grid_size) -> (tracks (T, N, 2) xy, visibility (T, N)
bool)`. The port's backend is `cotracker3.CoTracker3Predictor`; the JAX
package's pyramidal Lucas-Kanade backend (`LKTracker`, cv2's
`calcOpticalFlowPyrLK`) is not ported (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

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

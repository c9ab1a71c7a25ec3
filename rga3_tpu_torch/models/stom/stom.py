"""STOM, the Spatio-Temporal Overlay Module (counterpart of
`rga3_tpu/models/stom/stom.py`).

Propagates a single-frame RGBA visual-prompt overlay to every frame of a
video by tracking points seeded in the overlay region:

  * query mask = filled circle at the overlay bbox centre, radius
    0.3 * min(bbox side);
  * shape overlays: per-frame flows key -> frame over visible points, MAD
    outlier rejection at 3 * MAD around the median magnitude, the frame left
    as it is when fewer than half the points survive, else the overlay
    translated by the mean flow (rounded to whole pixels) and
    alpha-composited;
  * mask-type overlays: a morphologically closed mask of the visible points
    and a disc in the overlay's colour at its centroid.

The tracker runs on the card (`cotracker3.CoTracker3Predictor`); the
compositing is host numpy, byte for byte the reference's: cv2's circle,
closing and moments are `raster`'s numpy versions, PIL's alpha composite is
`_composite_window`.
"""
from __future__ import annotations

import os
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ...device import DeviceLike
from . import raster


def _composite_window(
    dst_rgb: np.ndarray,  # (H, W, 3) uint8, modified in place
    src_rgba: np.ndarray,  # (h, w, 4) uint8 patch
    y0: int,
    x0: int,
) -> None:
    """Alpha-composite an RGBA patch over an opaque RGB frame, in place,
    byte-identical to PIL.Image.alpha_composite (dst alpha 255): for each
    channel t = src*a + dst*(255-a), out = round(t/255) computed exactly
    in integers. The window is clipped to the frame."""
    H, W = dst_rgb.shape[:2]
    h, w = src_rgba.shape[:2]
    sy0, sx0 = max(0, -y0), max(0, -x0)
    dy0, dx0 = max(0, y0), max(0, x0)
    dy1, dx1 = min(H, y0 + h), min(W, x0 + w)
    if dy1 <= dy0 or dx1 <= dx0:
        return
    patch = src_rgba[sy0:sy0 + (dy1 - dy0), sx0:sx0 + (dx1 - dx0)]
    a = patch[..., 3:4].astype(np.uint32)
    win = dst_rgb[dy0:dy1, dx0:dx1]
    t = patch[..., :3].astype(np.uint32) * a + win.astype(np.uint32) * (255 - a)
    win[:] = ((((t + 128) >> 8) + t + 128) >> 8).astype(np.uint8)


def _rgba_bbox(rgba: np.ndarray) -> Optional[Tuple[int, int, int, int]]:
    """(y0, y1, x0, x1) bounds of alpha>0, or None when fully clear."""
    alpha = rgba[:, :, 3] > 0
    rows = np.flatnonzero(alpha.any(axis=1))
    if rows.size == 0:
        return None
    cols = np.flatnonzero(alpha.any(axis=0))
    return int(rows[0]), int(rows[-1]) + 1, int(cols[0]), int(cols[-1]) + 1


def default_tracker(device: DeviceLike = None):
    """STOM's tracker from `RGA3_STOM_TRACKER`: `cotracker3` or unset /
    `auto` the repo's trained CoTracker3 weights, a path ending in `.npz`
    that self-describing weight file. The JAX package's LK tracker (`lk`,
    and its fallback when no weight file exists) is not ported (ROADMAP.md,
    Queue 1): those choices raise."""
    from .cotracker3 import _SHIPPED_WEIGHTS, shipped_tracker

    choice = os.environ.get("RGA3_STOM_TRACKER", "auto")
    if choice.lower() == "lk":
        raise NotImplementedError(
            "RGA3_STOM_TRACKER=lk: the LK tracker (cv2's calcOpticalFlowPyrLK) "
            "is not ported to rga3_tpu_torch (ROADMAP.md, Queue 1)")
    if choice.endswith(".npz"):
        tracker = shipped_tracker(path=choice, device=device)
        if tracker is None:
            raise FileNotFoundError(f"RGA3_STOM_TRACKER={choice}: no such weight file")
        return tracker
    tracker = shipped_tracker(device=device)
    if tracker is None:
        raise FileNotFoundError(
            f"no CoTracker3 weights at {_SHIPPED_WEIGHTS}; the LK tracker the JAX "
            "package falls back to is not ported (ROADMAP.md, Queue 1)")
    return tracker


def _like_frames(frames: Sequence, out: List[np.ndarray]) -> List:
    """`out` in the form `frames` came in: ndarrays, or images made by the
    `fromarray` of the module that made the input frames (PIL's, when the
    caller passed PIL images; the port itself imports no PIL)."""
    if isinstance(frames[0], np.ndarray):
        return out
    make = getattr(sys.modules.get(type(frames[0]).__module__), "fromarray", None)
    if make is None:
        return out
    return [make(a, "RGB") for a in out]


class STOM:
    """Overlay propagation over a tracker with STOM's interface; the
    default tracker (`default_tracker`) runs on the card unless `device`
    asks for the CPU."""

    def __init__(self, tracker=None, device: DeviceLike = None):
        self.tracker = tracker or default_tracker(device)

    @staticmethod
    def _query_mask(vip_frame) -> np.ndarray:
        vip_mask = (np.asarray(vip_frame)[:, :, 3] > 0).astype(np.uint8)
        coords = np.argwhere(vip_mask)
        min_y, min_x = coords.min(axis=0)
        max_y, max_x = coords.max(axis=0)
        cx = (min_x + max_x) // 2
        cy = (min_y + max_y) // 2
        radius = int(min(max_x - min_x, max_y - min_y) * 0.3)
        out = np.zeros_like(vip_mask)
        raster.fill_circle(out, (int(cx), int(cy)), max(radius, 1), 1)
        return out

    @staticmethod
    def _frames_to_rgb(frames: Sequence) -> List[np.ndarray]:
        """(H, W, 3) uint8 ndarrays (passed through without a copy), or
        image objects with `.mode` / `.convert("RGB")` (PIL's, by duck
        typing) -> a list of RGB arrays."""
        out = []
        for f in frames:
            if isinstance(f, np.ndarray):
                out.append(np.ascontiguousarray(f[..., :3]))
            else:
                out.append(np.asarray(f if getattr(f, "mode", None) == "RGB"
                                      else f.convert("RGB")))
        return out

    def track_in_video(self, frames: Sequence, vip_frame, vip_frame_idx: int,
                       grid_size: int = 100,
                       _frames_rgb: Optional[List[np.ndarray]] = None):
        arr = _frames_rgb or self._frames_to_rgb(frames)
        mask = self._query_mask(vip_frame)
        tracks, vis = self.tracker.track(arr, mask, vip_frame_idx, grid_size=grid_size)
        # the query points come from the visible prompt at the key frame: a
        # head that marks most of them hidden there is miscalibrated for the
        # content, and every point counts as visible (the reference's rule)
        if vis.shape[0] and vis[vip_frame_idx].mean() < 0.5:
            vis = np.ones_like(vis)
        return tracks, vis

    # -- overlay warps ---------------------------------------------------
    @staticmethod
    def _warp_translate(src_patch: np.ndarray, patch_y0: int, patch_x0: int,
                        tgt_frame: np.ndarray, dy: float, dx: float) -> np.ndarray:
        out = tgt_frame.copy()
        _composite_window(out, src_patch, patch_y0 + int(round(dy)),
                          patch_x0 + int(round(dx)))
        return out

    @staticmethod
    def _warp_point(src_vip: np.ndarray, tgt_frame: np.ndarray, tracks: np.ndarray,
                    vis: np.ndarray) -> np.ndarray:
        if vis.sum() < len(tracks) // 2:
            return tgt_frame
        vip_mask = src_vip[:, :, 3] > 0
        if vip_mask.any():
            color = src_vip[vip_mask][0].copy()
        else:
            color = np.zeros(4, np.uint8)
        color[3] = max(min(int(color[3]), 148), 96)

        h, w = src_vip.shape[:2]
        mask = np.zeros((h, w), np.uint8)
        pts = tracks[vis]
        xi = pts[:, 0].astype(int).clip(0, w - 1)
        yi = pts[:, 1].astype(int).clip(0, h - 1)
        mask[yi, xi] = 255
        k = max(min(h, w) // 15, 3)
        closed = raster.morph_close(mask, raster.ellipse_kernel(k))
        m = raster.moments(closed)
        out = tgt_frame.copy()
        if m["m00"] != 0:
            cx = int(m["m10"] / m["m00"])
            cy = int(m["m01"] / m["m00"])
            radius = min(h, w) // 20
            # disc patch in the overlay colour, composited in its window
            side = 2 * radius + 1
            circle = np.zeros((side, side), np.uint8)
            raster.fill_circle(circle, (radius, radius), radius, 255)
            patch = np.zeros((side, side, 4), np.uint8)
            patch[circle > 0] = color
            _composite_window(out, patch, cy - radius, cx - radius)
        return out

    # -- entry points ----------------------------------------------------
    def propagate_in_video(self, frames: Sequence, src_frame_vip, vip_frame_idx: int,
                           shape: str = "rectangle", grid_size: int = 100) -> List:
        """Frames (ndarrays or PIL-like images) with the key frame's RGBA
        overlay propagated; returned in the form they came in."""
        frames_rgb = self._frames_to_rgb(frames)
        tracks, vis = self.track_in_video(frames, src_frame_vip, vip_frame_idx, grid_size,
                                          _frames_rgb=frames_rgb)
        out = self._compose_from_tracks(frames_rgb, tracks, vis, np.asarray(src_frame_vip),
                                        vip_frame_idx, shape)
        return _like_frames(frames, out)

    def propagate_in_video_batch(self, batch: Sequence[dict],
                                 grid_size: int = 100) -> List[List]:
        """B samples' overlays with one tracker call (`track_batch`) when the
        tracker has it and the clips share a frame count. Like the reference,
        this path has no key-frame visibility fallback.

        batch: [{"frames", "vip" (RGBA), "key_idx", "shape"}]; returns the
        per-sample frame lists in the form the frames came in."""
        arrs = [self._frames_to_rgb(s["frames"]) for s in batch]
        vips = [np.asarray(s["vip"]) for s in batch]
        idxs = [s.get("key_idx", 0) for s in batch]
        masks = [self._query_mask(v) if (v[:, :, 3] > 0).any()
                 else np.zeros(v.shape[:2], np.uint8) for v in vips]
        if hasattr(self.tracker, "track_batch") and len({len(a) for a in arrs}) == 1:
            tr = self.tracker.track_batch(arrs, masks, idxs, grid_size=grid_size)
        else:
            tr = [self.tracker.track(a, m, i, grid_size=grid_size)
                  for a, m, i in zip(arrs, masks, idxs)]
        outs = []
        for s, a, v, i, (tracks, vis) in zip(batch, arrs, vips, idxs, tr):
            out = self._compose_from_tracks(a, tracks, vis, v, i, s.get("shape", "rectangle"))
            outs.append(_like_frames(s["frames"], out))
        return outs

    def _compose_from_tracks(self, frames_rgb: List[np.ndarray], tracks: np.ndarray,
                             vis: np.ndarray, src_vip: np.ndarray, vip_frame_idx: int,
                             shape: str) -> List[np.ndarray]:
        vip_track = tracks[vip_frame_idx]
        bbox = _rgba_bbox(src_vip)
        if bbox is None:
            patch, py0, px0 = src_vip[:0, :0], 0, 0
        else:
            py0, py1, px0, px1 = bbox
            patch = src_vip[py0:py1, px0:px1]

        out: List[np.ndarray] = []
        for idx, tgt_rgb in enumerate(frames_rgb):
            if idx == vip_frame_idx:
                composed = tgt_rgb.copy()
                _composite_window(composed, patch, py0, px0)
                out.append(composed)
                continue

            t_track = tracks[idx]
            t_vis = vis[idx]
            if shape in ("mask", "mask contour"):
                # the reference's guard, around host numpy only
                try:
                    out.append(self._warp_point(src_vip, tgt_rgb, t_track, t_vis))
                except Exception:
                    out.append(tgt_rgb)
                continue

            flows = t_track[t_vis] - vip_track[t_vis]
            if len(flows) == 0:
                out.append(tgt_rgb)
                continue
            mags = np.linalg.norm(flows, axis=1)
            median = np.median(mags)
            mad = np.median(np.abs(mags - median))
            keep = (mags >= median - 3 * mad) & (mags <= median + 3 * mad)
            filtered = flows[keep]
            if len(filtered) < t_vis.shape[0] // 2:
                out.append(tgt_rgb)
                continue
            # tracks are (x, y); the translate warp takes (dy, dx)
            avg_dx = float(np.mean(filtered[:, 0]))
            avg_dy = float(np.mean(filtered[:, 1]))
            if np.isnan(avg_dx) or np.isnan(avg_dy):
                out.append(tgt_rgb)
                continue
            out.append(self._warp_translate(patch, py0, px0, tgt_rgb, avg_dy, avg_dx))
        return out

"""Synthetic point-tracking supervision and scoring suites for STOM's
trackers (counterpart of `rga3_tpu/models/stom/synth.py`, numpy only).

The trackers train on procedurally generated motion: a random smoothed
texture warped by a per-frame similarity transform (translation + rotation
+ scale drift), or the layered curriculum (a background, independently
moving sprites and an opaque occluder, with exact visibility labels).
Ground-truth tracks are the warped query positions. Every array equals the
JAX package's for the same `np.random.Generator`; the photo texture is read
from the JPEG packaged beside this module (`data/grace_hopper.jpg`, the
file matplotlib bundles), so no matplotlib is needed.
"""
from __future__ import annotations

import functools
import os
from typing import Tuple

import numpy as np


def _smooth_noise(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """(H, W, 3) float [0,1] band-limited texture (box-filtered noise)."""
    img = rng.random((h, w, 3)).astype(np.float32)
    k = 5
    pad = np.pad(img, ((k, k), (k, k), (0, 0)), mode="wrap")
    win = 2 * k + 1
    # integral image with a leading zero row/col so every window position
    # is represented (a bare double-cumsum drops one row/col)
    csum = np.zeros(
        (pad.shape[0] + 1, pad.shape[1] + 1, 3), np.float64
    )
    csum[1:, 1:] = np.cumsum(np.cumsum(pad, axis=0), axis=1)
    box = (
        csum[win:, win:] - csum[:-win, win:] - csum[win:, :-win]
        + csum[:-win, :-win]
    ) / (win * win)
    out = box[:h, :w].astype(np.float32)
    out = out - out.min()
    return out / max(out.max(), 1e-6)


PHOTO_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                          "grace_hopper.jpg")


@functools.lru_cache(maxsize=1)
def _photo_bank() -> np.ndarray:
    """A real photograph as a texture source: the JPEG matplotlib bundles
    (`sample_data/grace_hopper.jpg`), carried in this package. (H, W, 3) f32
    in [0, 1], read-only (every caller shares it). Raises if it cannot be
    read: no texture stands in for it."""
    from PIL import Image

    with Image.open(PHOTO_PATH) as im:
        bank = np.asarray(im, np.float32) / 255.0
    bank.setflags(write=False)
    return bank


def _photo_texture(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """(H, W, 3) float [0,1] texture cropped from the photo bank, with a
    random flip/transpose and brightness/contrast jitter; tiled (with
    mirrored repeats, so seams stay photographic) when the request is
    larger than the source."""
    img = _photo_bank()
    if rng.random() < 0.5:
        img = img[:, ::-1]
    if rng.random() < 0.5:
        img = img[::-1]
    if rng.random() < 0.5:
        img = np.transpose(img, (1, 0, 2))
    ih, iw = img.shape[:2]
    if ih < h or iw < w:
        ry = -(-h // ih) + 1
        rx = -(-w // iw) + 1
        # mirror-tile: every other repeat flipped, no hard wrap seams
        rows = [img if j % 2 == 0 else img[::-1] for j in range(ry)]
        img = np.concatenate(rows, axis=0)
        cols = [img if j % 2 == 0 else img[:, ::-1] for j in range(rx)]
        img = np.concatenate(cols, axis=1)
        ih, iw = img.shape[:2]
    y0 = int(rng.integers(0, ih - h + 1))
    x0 = int(rng.integers(0, iw - w + 1))
    out = img[y0:y0 + h, x0:x0 + w].astype(np.float32)
    gain = float(rng.uniform(0.7, 1.2))
    bias = float(rng.uniform(-0.1, 0.1))
    return np.clip(out * gain + bias, 0.0, 1.0)


def _make_texture(
    rng: np.random.Generator, h: int, w: int, kind: str
) -> np.ndarray:
    if kind == "photo":
        return _photo_texture(rng, h, w)
    return _smooth_noise(rng, h, w)


def make_synthetic_batch(
    rng: np.random.Generator,
    t: int = 8,
    h: int = 64,
    w: int = 64,
    n_points: int = 16,
    max_speed: float = 2.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (frames (T,H,W,3) [0,1], queries (N,3) = (t0,x,y),
    gt_tracks (T,N,2))."""
    margin = int(max_speed * t + 8)
    texture = _smooth_noise(rng, h + 2 * margin, w + 2 * margin)

    # per-frame similarity transform of the camera over the texture
    vel = rng.uniform(-max_speed, max_speed, size=2)
    rot_rate = rng.uniform(-0.01, 0.01)
    scale_rate = rng.uniform(-0.003, 0.003)
    cx, cy = w / 2, h / 2

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = np.zeros((t, h, w, 3), np.float32)
    mats = []
    for ti in range(t):
        ang = rot_rate * ti
        s = 1.0 + scale_rate * ti
        ca, sa = np.cos(ang) * s, np.sin(ang) * s
        tx, ty = vel * ti
        # frame pixel (x, y) samples texture at A @ (x-c) + c + t + margin
        a = np.array([[ca, -sa], [sa, ca]], np.float32)
        mats.append((a, np.array([tx, ty], np.float32)))
        gx = ca * (xs - cx) - sa * (ys - cy) + cx + tx + margin
        gy = sa * (xs - cx) + ca * (ys - cy) + cy + ty + margin
        x0 = np.clip(gx.astype(np.int32), 0, texture.shape[1] - 2)
        y0 = np.clip(gy.astype(np.int32), 0, texture.shape[0] - 2)
        fx = (gx - x0)[..., None]
        fy = (gy - y0)[..., None]
        f = (
            texture[y0, x0] * (1 - fx) * (1 - fy)
            + texture[y0, x0 + 1] * fx * (1 - fy)
            + texture[y0 + 1, x0] * (1 - fx) * fy
            + texture[y0 + 1, x0 + 1] * fx * fy
        )
        frames[ti] = f

    # queries on frame 0, away from the border
    qx = rng.uniform(8, w - 8, n_points).astype(np.float32)
    qy = rng.uniform(8, h - 8, n_points).astype(np.float32)
    queries = np.stack(
        [np.zeros(n_points, np.float32), qx, qy], axis=1
    )

    # gt: the texture point under (x, y) at frame 0 appears at frame ti
    # where A_ti @ (p - c) + c + t_ti == A_0 @ (q - c) + c + t_0
    a0, t0 = mats[0]
    tex_pt = (a0 @ np.stack([qx - cx, qy - cy])).T + t0  # (N, 2)
    gt = np.zeros((t, n_points, 2), np.float32)
    for ti in range(t):
        a, tv = mats[ti]
        rel = tex_pt - tv
        inv = np.linalg.inv(a)
        p = (inv @ rel.T).T
        gt[ti, :, 0] = p[:, 0] + cx
        gt[ti, :, 1] = p[:, 1] + cy
    return frames, queries, gt


# ---------------------------------------------------------------------------
# Fixed benchmark suite (occlusion + large motion), VERDICT r2 item 6:
# a deterministic px-error harness any tracker backend can be scored on.
# ---------------------------------------------------------------------------

def _add_occluder(
    rng: np.random.Generator, frames: np.ndarray, gt: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Composite an opaque textured sprite sweeping across the tracked
    points mid-clip. Returns (frames, vis (T, N) bool) — vis False where
    the GT point sits under the sprite (the tracker cannot see it)."""
    t, h, w, _ = frames.shape
    n = gt.shape[1]
    side = max(8, min(h, w) // 3)
    tex = _smooth_noise(rng, side, side) * 0.5  # dark so it's distinct
    # aim at the tracked point nearest the cloud centre mid-clip (the
    # bare mean can miss every point for spread-out clouds, leaving the
    # "occlusion" case occlusion-free)
    mid = gt[t // 2]
    target = mid[np.argmin(
        np.linalg.norm(mid - mid.mean(axis=0), axis=-1)
    )]
    step = side  # sweep one sprite-width per frame
    vis = np.ones((t, n), bool)
    frames = frames.copy()
    for ti in range(t):
        cx = target[0] + (ti - t // 2) * step
        cy = target[1]
        x0, y0 = int(round(cx - side / 2)), int(round(cy - side / 2))
        xa, ya = max(x0, 0), max(y0, 0)
        xb, yb = min(x0 + side, w), min(y0 + side, h)
        if xb > xa and yb > ya:
            frames[ti, ya:yb, xa:xb] = tex[
                ya - y0 : yb - y0, xa - x0 : xb - x0
            ]
        under = (
            (gt[ti, :, 0] >= x0) & (gt[ti, :, 0] < x0 + side)
            & (gt[ti, :, 1] >= y0) & (gt[ti, :, 1] < y0 + side)
        )
        vis[ti] = ~under
    return frames, vis


BENCH_CASES = ("smooth", "large_motion", "occlusion")


def make_synthetic_case(
    rng: np.random.Generator,
    case: str,
    t: int = 8,
    h: int = 64,
    w: int = 64,
    n_points: int = 16,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One benchmark clip: (frames (T,H,W,3) [0,1], queries (N,3),
    gt_tracks (T,N,2), gt_vis (T,N) bool).

    smooth        gentle similarity motion (<=2 px/frame) — the training
                  distribution of tools/train_cotracker.py (flat)
    large_motion  <=8 px/frame translation + stronger rotation/scale
    occlusion     smooth motion + an opaque sprite sweeping over the
                  tracked points (vis goes False under it)
    """
    assert case in BENCH_CASES, case
    speed = 8.0 if case == "large_motion" else 2.0
    frames, queries, gt = make_synthetic_batch(
        rng, t=t, h=h, w=w, n_points=n_points, max_speed=speed
    )
    vis = np.ones((t, n_points), bool)
    if case == "occlusion":
        frames, vis = _add_occluder(rng, frames, gt)
    return frames, queries, gt, vis


def benchmark_tracker(
    track_points_fn,
    cases: Tuple[str, ...] = BENCH_CASES,
    seeds: Tuple[int, ...] = (0, 1, 2),
    t: int = 8,
    size: int = 64,
    n_points: int = 16,
) -> dict:
    """Score `track_points_fn(frames_u8 (T,H,W,3) uint8, pts0 (N,2),
    query_frame_idx) -> (T,N,2)` on the fixed suite.

    Per case: mean px error over GT-visible points, the stay-put
    baseline on the same points, and (occlusion only) the error measured
    while points are hidden — re-detection quality after the sprite
    passes shows up in px_err, behavior under it in px_err_occluded."""
    out = {}
    for case in cases:
        errs, occ_errs, stay = [], [], []
        for s in seeds:
            rng = np.random.default_rng(1000 + s)
            frames, queries, gt, vis = make_synthetic_case(
                rng, case, t=t, h=size, w=size, n_points=n_points
            )
            pts0 = queries[:, 1:3]
            frames_u8 = (frames * 255.0).astype(np.uint8)
            pred = np.asarray(track_points_fn(frames_u8, pts0, 0))
            err = np.linalg.norm(pred - gt, axis=-1)
            errs.append(float(err[vis].mean()))
            if (~vis).any():
                occ_errs.append(float(err[~vis].mean()))
            stay_err = np.linalg.norm(pts0[None] - gt, axis=-1)
            stay.append(float(stay_err[vis].mean()))
        out[case] = {
            "px_err": round(float(np.mean(errs)), 3),
            "stayput_px_err": round(float(np.mean(stay)), 3),
        }
        if occ_errs:
            out[case]["px_err_occluded"] = round(
                float(np.mean(occ_errs)), 3
            )
    return out


# ---------------------------------------------------------------------------
# Layered training generator (round 4): background + independently-moving
# foreground sprites + occluders, with TRUE visibility labels. The flat
# similarity-warp generator above lets a tracker cheat by estimating one
# global motion; real STOM clips have object-vs-camera parallax and the
# reference relies on CoTracker3's whole-clip attention to re-acquire
# points after occlusion (ref model/STOM.py:59-65 backward_tracking).
# ---------------------------------------------------------------------------


def _similarity_path(
    rng: np.random.Generator, t: int, max_speed: float,
    rot_scale: float = 1.0,
) -> list:
    """Per-frame (A (2,2), t (2,)) similarity transforms: frame-ti pixel p
    maps to layer-texture coords A @ (p - c) + c + t (c supplied later)."""
    vel = rng.uniform(-max_speed, max_speed, size=2)
    # mild acceleration so motion is not perfectly linear in time
    acc = rng.uniform(-max_speed / 8, max_speed / 8, size=2)
    rot_rate = rng.uniform(-0.02, 0.02) * rot_scale
    scale_rate = rng.uniform(-0.005, 0.005) * rot_scale
    mats = []
    for ti in range(t):
        ang = rot_rate * ti
        s = 1.0 + scale_rate * ti
        ca, sa = np.cos(ang) * s, np.sin(ang) * s
        a = np.array([[ca, -sa], [sa, ca]], np.float32)
        tv = (vel * ti + 0.5 * acc * ti * ti).astype(np.float32)
        mats.append((a, tv))
    return mats


def make_training_clip(
    rng: np.random.Generator,
    t: int = 8,
    h: int = 160,
    w: int = 224,
    n_points: int = 48,
    max_speed: float = 8.0,
    n_fg: Tuple[int, int] = (0, 2),
    occluder_prob: float = 0.7,
    random_query_frame: bool = True,
    speed_exponent: float = 1.0,
    texture: str = "noise",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One supervised clip: (frames (T,H,W,3) [0,1], queries (N,3)
    (t0,x,y), gt_tracks (T,N,2), gt_vis (T,N) bool).

    Layers, back to front: a similarity-warped background texture;
    0..n_fg[1] textured elliptical sprites each following its OWN
    similarity path (points are tracked on sprites and background both —
    parallax means no single global motion explains the clip); with
    probability `occluder_prob` one opaque occluder sprite sweeping over
    the densest tracked region (nothing is tracked on it; it only hides
    points). Visibility is exact: a point is visible iff in-bounds and
    not covered by any layer above its own. Per-clip speed is drawn
    uniformly from [0.5, max_speed] so one curriculum covers the smooth
    and large-motion regimes; `speed_exponent` < 1 biases the draw
    toward max_speed (speed = 0.5 + range * u^e) for
    large-displacement-weighted curricula."""
    speed = 0.5 + (max_speed - 0.5) * float(
        rng.uniform() ** speed_exponent
    )
    margin = int(speed * t + 8)
    tex_kind = texture
    texture = _make_texture(
        rng, h + 2 * margin, w + 2 * margin, tex_kind
    )
    cx, cy = w / 2, h / 2
    bg_mats = _similarity_path(rng, t, speed * rng.uniform(0.3, 1.0))

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    # one vectorized warp over ALL frames (the per-frame python loop was
    # the generator's hot spot on the 1-CPU host)
    A_bg = np.stack([m[0] for m in bg_mats])          # (T, 2, 2)
    TV_bg = np.stack([m[1] for m in bg_mats])         # (T, 2)
    dx, dy = xs - cx, ys - cy
    gx = (
        A_bg[:, 0, 0, None, None] * dx + A_bg[:, 0, 1, None, None] * dy
        + cx + TV_bg[:, 0, None, None] + margin
    )
    gy = (
        A_bg[:, 1, 0, None, None] * dx + A_bg[:, 1, 1, None, None] * dy
        + cy + TV_bg[:, 1, None, None] + margin
    )
    x0 = np.clip(gx.astype(np.int32), 0, texture.shape[1] - 2)
    y0 = np.clip(gy.astype(np.int32), 0, texture.shape[0] - 2)
    fx = (gx - x0)[..., None]
    fy = (gy - y0)[..., None]
    frames = (
        texture[y0, x0] * (1 - fx) * (1 - fy)
        + texture[y0, x0 + 1] * fx * (1 - fy)
        + texture[y0 + 1, x0] * (1 - fx) * fy
        + texture[y0 + 1, x0 + 1] * fx * fy
    ).astype(np.float32)

    # --- foreground sprites: own texture, elliptical support, own path --
    k_fg = int(rng.integers(n_fg[0], n_fg[1] + 1))
    sprites = []  # (mats, center0 (2,), radii (2,), tex, tex_margin)
    fg_masks = np.zeros((t, h, w), bool)  # union of sprite supports
    sprite_of_pixel = np.full((t, h, w), -1, np.int8)  # topmost sprite
    for si in range(k_fg):
        rx = float(rng.uniform(w / 10, w / 4))
        ry = float(rng.uniform(h / 10, h / 4))
        c0 = np.array(
            [rng.uniform(rx, w - rx), rng.uniform(ry, h - ry)], np.float32
        )
        sp_speed = speed * float(rng.uniform(0.5, 1.5))
        sp_margin = int(sp_speed * t + 8)
        stex = _make_texture(
            rng, int(2 * ry) + 2 * sp_margin,
            int(2 * rx) + 2 * sp_margin, tex_kind,
        )
        # sprite's own similarity path, applied about its (moving) centre
        mats = _similarity_path(rng, t, sp_speed, rot_scale=2.0)
        sprites.append((mats, c0, (rx, ry), stex, sp_margin))
        for ti in range(t):
            a, tv = mats[ti]
            # frame pixel p shows sprite texel A @ (p - c0) + t_shift;
            # the support (texel in the ellipse) is bounded in frame
            # coords by a disc of radius max(rx,ry)/|s| about the point
            # where the texel origin lands — warp only that window
            ainv = np.linalg.inv(a)
            pc = c0 + ainv @ (-tv)
            rad = float(max(rx, ry) / max(np.sqrt(abs(
                np.linalg.det(a)
            )), 1e-3)) + 2.0
            bx0, bx1 = max(int(pc[0] - rad), 0), min(
                int(pc[0] + rad) + 1, w
            )
            by0, by1 = max(int(pc[1] - rad), 0), min(
                int(pc[1] + rad) + 1, h
            )
            if bx1 <= bx0 or by1 <= by0:
                continue
            wxs = xs[by0:by1, bx0:bx1]
            wys = ys[by0:by1, bx0:bx1]
            lx = a[0, 0] * (wxs - c0[0]) + a[0, 1] * (wys - c0[1]) + tv[0]
            ly = a[1, 0] * (wxs - c0[0]) + a[1, 1] * (wys - c0[1]) + tv[1]
            # inverse: ellipse defined in sprite-local (undeformed) coords
            inside = (lx / rx) ** 2 + (ly / ry) ** 2 <= 1.0
            gx = lx + rx + sp_margin
            gy = ly + ry + sp_margin
            x0 = np.clip(gx.astype(np.int32), 0, stex.shape[1] - 2)
            y0 = np.clip(gy.astype(np.int32), 0, stex.shape[0] - 2)
            fx = (gx - x0)[..., None]
            fy = (gy - y0)[..., None]
            tex_val = (
                stex[y0, x0] * (1 - fx) * (1 - fy)
                + stex[y0, x0 + 1] * fx * (1 - fy)
                + stex[y0 + 1, x0] * (1 - fx) * fy
                + stex[y0 + 1, x0 + 1] * fx * fy
            )
            frames[ti, by0:by1, bx0:bx1][inside] = tex_val[inside]
            fg_masks[ti, by0:by1, bx0:bx1] |= inside
            sprite_of_pixel[ti, by0:by1, bx0:bx1][inside] = si

    # --- query points + GT tracks ---------------------------------------
    # assign each point to a layer: background or one of the sprites
    # (sprite points sampled inside the ellipse at its query frame)
    q_frame = (
        int(rng.integers(0, t)) if random_query_frame and t > 1 else 0
    )
    layer = np.full(n_points, -1, np.int32)
    if k_fg:
        n_sprite_pts = int(n_points * rng.uniform(0.2, 0.5))
        layer[:n_sprite_pts] = rng.integers(0, k_fg, n_sprite_pts)
    gt = np.zeros((t, n_points, 2), np.float32)
    Ainv_bg = np.linalg.inv(A_bg)                     # (T, 2, 2)
    centre = np.array([cx, cy], np.float32)
    bg_idx = np.flatnonzero(layer < 0)
    if bg_idx.size:
        # background points: texture coords from their query-frame pos
        # (rejection-sample spots not covered by a sprite at the query
        # frame — queries must be observed points)
        px = rng.uniform(4, w - 4, bg_idx.size)
        py = rng.uniform(4, h - 4, bg_idx.size)
        for k in range(bg_idx.size):
            for _ in range(16):
                if sprite_of_pixel[q_frame, int(py[k]), int(px[k])] < 0:
                    break
                px[k] = rng.uniform(4, w - 4)
                py[k] = rng.uniform(4, h - 4)
        pq = np.stack([px, py], -1).astype(np.float32)  # (Nb, 2)
        a, tv = bg_mats[q_frame]
        tex_pt = (a @ (pq - centre).T).T + tv           # (Nb, 2)
        rel = tex_pt[None, :, :] - TV_bg[:, None, :]    # (T, Nb, 2)
        gt[:, bg_idx] = np.einsum("tij,tnj->tni", Ainv_bg, rel) + centre
    for si in range(k_fg):
        sp_idx = np.flatnonzero(layer == si)
        if not sp_idx.size:
            continue
        mats, c0, (rx, ry), _, _ = sprites[si]
        # sample in sprite-local coords, inside the ellipse
        ang = rng.uniform(0, 2 * np.pi, sp_idx.size)
        rad = np.sqrt(rng.uniform(0, 0.85, sp_idx.size))
        local = np.stack(
            [rad * np.cos(ang) * rx, rad * np.sin(ang) * ry], -1
        ).astype(np.float32)                            # (Ns, 2)
        A_sp = np.stack([m[0] for m in mats])
        TV_sp = np.stack([m[1] for m in mats])
        rel = local[None, :, :] - TV_sp[:, None, :]
        gt[:, sp_idx] = np.einsum(
            "tij,tnj->tni", np.linalg.inv(A_sp), rel
        ) + c0
    qxy = gt[q_frame].copy()
    queries = np.concatenate(
        [np.full((n_points, 1), q_frame, np.float32), qxy], axis=1
    )

    # --- occluder (opaque, untracked, drawn last) -----------------------
    vis = np.ones((t, n_points), bool)
    if rng.random() < occluder_prob:
        frames, occ_vis = _add_occluder(rng, frames, gt)
        vis &= occ_vis

    # --- exact visibility: in-bounds + not covered by a higher layer ----
    xi = np.clip(gt[..., 0].astype(np.int32), 0, w - 1)
    yi = np.clip(gt[..., 1].astype(np.int32), 0, h - 1)
    inb = (
        (gt[..., 0] >= 0) & (gt[..., 0] < w)
        & (gt[..., 1] >= 0) & (gt[..., 1] < h)
    )
    ti_idx = np.arange(t)[:, None]
    covering = sprite_of_pixel[ti_idx, yi, xi].astype(np.int32)  # (T, N)
    is_bg = layer[None, :] < 0
    hidden_by_fg = np.where(
        is_bg, covering >= 0, covering != layer[None, :]
    ) & (covering >= 0)
    vis &= inb & ~hidden_by_fg
    # queries are observed points: a track is visible at its query frame
    # by construction (sprite points ride their sprite; background spots
    # are rejection-sampled off sprites); the occluder can still cross
    # the query frame, so override its label there
    vis[q_frame] = True
    return frames, queries, gt, vis


def benchmark_tracker_serving(
    track_points_fn,
    seeds: Tuple[int, ...] = tuple(range(8)),
    t: int = 8,
    h: int = 160,
    w: int = 224,
    n_points: int = 24,
    max_speed: float = 10.0,
    texture: str = "noise",
) -> dict:
    """Serving-resolution suite on the LAYERED generator — the r4
    verdict's gap: the fixed 64² suite is below the 160×224 STOM serving
    resolution and its band-limited-noise texture lets global-motion
    shortcuts win. Clips here have parallax layers, textured sprites and
    opaque occluders (same family the shipped tracker trains on, but a
    DISJOINT fixed seed range), split into slow/fast regimes by the
    clip's true median per-frame displacement, with hidden-point error
    reported separately.

    `texture="photo"` swaps every layer's band-limited-noise texture for
    random crops of a real photograph (`_photo_bank`) — out-of-family
    for the shipped trackers, which train on noise only, so it measures
    generalization to real image statistics (seed base offset keeps the
    clip geometry family distinct from the noise suite too)."""
    slow_errs, fast_errs, occ_errs, stay = [], [], [], []
    seed_base = 5000 if texture == "noise" else 7000
    for s in seeds:
        rng = np.random.default_rng(seed_base + s)
        frames, queries, gt, vis = make_training_clip(
            rng, t=t, h=h, w=w, n_points=n_points,
            max_speed=max_speed, random_query_frame=False,
            texture=texture,
        )
        pts0 = queries[:, 1:3]
        frames_u8 = (frames * 255.0).astype(np.uint8)
        pred = np.asarray(track_points_fn(frames_u8, pts0, 0))
        err = np.linalg.norm(pred - gt, axis=-1)
        disp = np.linalg.norm(np.diff(gt, axis=0), axis=-1)
        clip_speed = float(np.median(disp))
        e_vis = float(err[vis].mean())
        (slow_errs if clip_speed < 3.0 else fast_errs).append(e_vis)
        if (~vis).any():
            occ_errs.append(float(err[~vis].mean()))
        stay.append(
            float(np.linalg.norm(pts0[None] - gt, axis=-1)[vis].mean())
        )
    out = {
        "resolution": f"{h}x{w}",
        "texture": texture,
        "stayput_px_err": round(float(np.mean(stay)), 3),
    }
    if slow_errs:
        out["slow_px_err"] = round(float(np.mean(slow_errs)), 3)
        out["n_slow"] = len(slow_errs)
    if fast_errs:
        out["fast_px_err"] = round(float(np.mean(fast_errs)), 3)
        out["n_fast"] = len(fast_errs)
    if occ_errs:
        out["hidden_px_err"] = round(float(np.mean(occ_errs)), 3)
    return out

"""Resizing and normalization (counterpart of `rga3_tpu/ops/resize.py`).

`resize_bilinear` is torch's `interpolate(mode="bilinear",
align_corners=False)` without antialiasing, the half-pixel rule the JAX
package's `jax.image.resize` follows. `resize_bicubic_torch` is torch's
bicubic (a=-0.75) without antialiasing. `resize_u8_bicubic_aa` stands in for
PIL's bicubic resize of uint8 frames (the JAX package's host path): torch's
antialiased bicubic follows PIL's filter and, run in PIL's two 8-bit passes,
lands within one level of it; the tests hold that difference to a
tolerance. `resize_u8_bilinear_aa` stands in for PIL's BILINEAR resize (the
CoTracker3 predictor's host pre-resize) with PIL's own arithmetic: its
22-bit fixed-point coefficients, summed exactly in float64. The two differ
because the tracker's refinement multiplies an input difference many times
over, so its stand-in has to give PIL's bytes (and the same bytes on the
card and the CPU); the bicubic stand-in feeds SAM2, where one level is
below the model's bf16 rounding, and the segmentation path's checks were
recorded on its bytes.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W) -> (..., size[0], size[1]), computed in f32."""
    lead = x.shape[:-2]
    y = F.interpolate(
        x.float().reshape(-1, 1, *x.shape[-2:]), size=tuple(size),
        mode="bilinear", align_corners=False, antialias=False,
    )
    return y.reshape(*lead, *size).to(x.dtype)


def resize_bicubic_torch(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(..., H, W) -> (..., size[0], size[1]) bicubic (a=-0.75), f32."""
    lead = x.shape[:-2]
    y = F.interpolate(
        x.float().reshape(-1, 1, *x.shape[-2:]), size=tuple(size),
        mode="bicubic", align_corners=False,
    )
    return y.reshape(*lead, *size).to(x.dtype)


def resize_u8_bicubic_aa(
    frames: torch.Tensor, size: Tuple[int, int]
) -> torch.Tensor:
    """(T, H, W, C) uint8 -> (T, size[0], size[1], C) uint8 by antialiased
    bicubic in PIL's order: a horizontal pass, rounded and clamped to 8 bits,
    then a vertical pass, rounded and clamped. PIL's 8-bit intermediate is
    what clips the bicubic overshoot at sharp edges; with it the result is
    within one level of PIL's on every pixel."""
    x = frames.permute(0, 3, 1, 2).float()
    h, w = x.shape[-2:]
    for hw in ((h, size[1]), (size[0], size[1])):
        if tuple(x.shape[-2:]) != hw:
            x = F.interpolate(
                x, size=hw, mode="bicubic", align_corners=False, antialias=True
            )
            x = torch.floor(x + 0.5).clamp(0, 255)
    return x.to(torch.uint8).permute(0, 2, 3, 1)


PIL_PRECISION_BITS = 22  # Pillow's Resample.c, 8-bit images: 32 - 8 - 2


@functools.lru_cache(maxsize=32)
def _pil_bilinear_coeffs(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """(out, in) float64 holding Pillow's integer coefficients for a
    BILINEAR resize of one axis (`precompute_coeffs` with the triangle
    filter, support scaled by the reduction, then `normalize_coeffs_8bpc`);
    made on the host and moved to the device once per shape."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ss = 1.0 / filterscale
    one = 1 << PIL_PRECISION_BITS
    k = np.zeros((out_size, in_size))
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss)) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        for x, v in enumerate(w):
            v = v / ww if ww != 0.0 else v
            k[xx, xmin + x] = math.trunc(v * one + (0.5 if v >= 0 else -0.5))
    with torch.inference_mode(False):  # usable outside inference mode too
        return torch.from_numpy(k).to(device)


def resize_u8_bilinear_aa(
    frames: torch.Tensor, size: Tuple[int, int]
) -> torch.Tensor:
    """(T, H, W, C) uint8 -> (T, size[0], size[1], C) uint8, PIL's BILINEAR
    resize: a horizontal pass, then a vertical one, each summing 8-bit
    values times Pillow's fixed-point coefficients plus half a unit and
    shifting them back to 8 bits, clamped. The sums are integers below 2^53,
    so float64 holds them exactly and the bytes are PIL's on any device."""
    x = frames.to(torch.float64)
    half = float(1 << (PIL_PRECISION_BITS - 1))
    unit = float(1 << PIL_PRECISION_BITS)
    for axis, n_out in ((2, size[1]), (1, size[0])):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        k = _pil_bilinear_coeffs(n_in, n_out, x.device)
        x = torch.movedim(torch.matmul(torch.movedim(x, axis, -1), k.t()), -1, axis)
        x = torch.floor((x + half) / unit).clamp(0, 255)
    return x.to(torch.uint8)


def sam_normalize_maybe(images: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> ImageNet-normalized f32; float frames pass through
    and must already be normalized (|x| <= 16), else ValueError."""
    if images.dtype == torch.uint8:
        mean = torch.tensor(IMAGENET_MEAN, device=images.device)
        std = torch.tensor(IMAGENET_STD, device=images.device)
        return (images.float() - mean) / std
    amax = float(images.float().abs().max())
    if amax > 16.0:
        raise ValueError(
            f"sam_normalize_maybe: float input with |x| max {amax:.1f} looks "
            "like raw pixels, not ImageNet-normalized frames"
        )
    return images

"""Resizing and normalization (counterpart of `rga3_tpu/ops/resize.py`).

`resize_bilinear` is torch's `interpolate(mode="bilinear",
align_corners=False)` without antialiasing, the half-pixel rule the JAX
package's `jax.image.resize` follows. `resize_bicubic_torch` is torch's
bicubic (a=-0.75) without antialiasing. `resize_u8_bicubic_aa` stands in for
PIL's bicubic resize of uint8 frames (the JAX package's host path): torch's
antialiased bicubic follows PIL's filter and, run in PIL's two 8-bit passes,
lands within one level of it; the tests hold that difference to a
tolerance.
"""
from __future__ import annotations

from typing import Tuple

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

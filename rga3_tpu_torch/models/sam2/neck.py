"""FPN neck and the image encoder (Hiera trunk + neck), NHWC; counterpart
of `rga3_tpu/models/sam2/neck.py`."""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from .config import Sam2Config
from .hiera import Hiera
from .layers import sine_position_encoding


def conv1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv applied to NHWC as a per-pixel linear map."""
    return F.linear(x, conv.weight.flatten(1), conv.bias)


class FpnNeck(nn.Module):
    def __init__(self, cfg: Sam2Config, **factory):
        super().__init__()
        self.cfg = cfg
        chans = list(reversed(cfg.hiera.channel_list))  # high res first
        n = len(chans) - 1
        for i in range(n + 1):
            # conv index n - i pairs convs_0 with the LOWEST resolution
            setattr(self, f"convs_{n - i}_conv",
                    nn.Conv2d(chans[i], cfg.d_model, 1, **factory))

    def forward(self, xs: List[torch.Tensor]):
        """xs: trunk outputs, highest resolution first. Returns (features,
        pos) lists in the same order, all with d_model channels."""
        cfg = self.cfg
        n = len(xs) - 1
        out: List[torch.Tensor] = [None] * len(xs)
        pos: List[torch.Tensor] = [None] * len(xs)
        prev = None
        for i in range(n, -1, -1):
            lateral = conv1x1(getattr(self, f"convs_{n - i}_conv"), xs[i])
            if i in cfg.fpn_top_down_levels and prev is not None:
                top_down = prev.float().repeat_interleave(2, 1).repeat_interleave(2, 2)
                prev = lateral + top_down.to(lateral.dtype)
            else:
                prev = lateral
            out[i] = prev
            b, h, w = prev.shape[:3]
            pe = sine_position_encoding(h, w, cfg.d_model).to(prev.device)
            pos[i] = pe[None].expand(b, h, w, cfg.d_model).to(prev.dtype)
        return out, pos


class ImageEncoder(nn.Module):
    """Hiera trunk + FPN neck; drops the `scalp` lowest-resolution levels."""

    def __init__(self, cfg: Sam2Config, **factory):
        super().__init__()
        self.cfg = cfg
        self.trunk = Hiera(cfg.hiera, **factory)
        self.neck = FpnNeck(cfg, **factory)

    def forward(self, x):
        features, pos = self.neck(self.trunk(x))
        if self.cfg.scalp > 0:
            features = features[: -self.cfg.scalp]
            pos = pos[: -self.cfg.scalp]
        return {"backbone_fpn": features, "vision_pos_enc": pos}

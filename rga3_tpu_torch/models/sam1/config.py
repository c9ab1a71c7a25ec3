"""SAM-v1 architecture configs: the port's own copy of
`rga3_tpu/models/sam1/config.py`, field for field (ViT-H / L / B image
encoders, prompt dim 256, image 1024, patch 16, window 14, a two-way
transformer of depth 2, MLP 2048, 8 heads, 3 multimask outputs).

`d_model`, `image_size` and `feat_size` are named as in `Sam2Config`, so
that SAM2's prompt encoder and two-way transformer take this config as
they are.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from ...config import ConfigBase


@dataclass(frozen=True)
class Sam1Config(ConfigBase):
    # ViT encoder
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    window_size: int = 14
    patch_size: int = 16
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-6
    # decoder side (Sam2Config's field names)
    d_model: int = 256
    image_size: int = 1024
    num_multimask_outputs: int = 3
    twoway_depth: int = 2
    twoway_mlp_dim: int = 2048
    twoway_heads: int = 8
    iou_head_hidden: int = 256
    iou_head_depth: int = 3
    iou_prediction_use_sigmoid: bool = False
    # preprocessing
    pixel_mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    pixel_std: Tuple[float, float, float] = (58.395, 57.12, 57.375)

    @property
    def feat_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size


SAM1_VIT_H = Sam1Config()
SAM1_VIT_L = Sam1Config(
    embed_dim=1024, depth=24, num_heads=16, global_attn_indexes=(5, 11, 17, 23),
)
SAM1_VIT_B = Sam1Config(
    embed_dim=768, depth=12, num_heads=12, global_attn_indexes=(2, 5, 8, 11),
)


def tiny_sam1_config(image_size: int = 64) -> Sam1Config:
    """A small config for tests: window 3 on a 4x4 grid pads the grid to 6
    and crops it back."""
    return Sam1Config(
        embed_dim=32, depth=3, num_heads=2, global_attn_indexes=(1,), window_size=3,
        image_size=image_size, d_model=32, twoway_mlp_dim=64, twoway_heads=4,
        iou_head_hidden=32,
    )

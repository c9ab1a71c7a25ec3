"""Qwen2.5-VL architecture configs: the port's own copy of
`rga3_tpu/models/qwen25vl/config.py`, field for field, so that a config saved
by either package loads in the other. Presets match the released
`Qwen2.5-VL-{3B,7B}-Instruct` HF configs.

The port runs the float, int8 (weight-only or W8A8) and int4 paths with a
bf16 or int8 KV cache. `scan_layers` / `scan_blocks` keep the modules and
change only the JAX package's parameter tree (stacked layers, which
`convert` reads and writes); `window_resident` keeps the vision tower's
tokens in padded window order through its blocks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

from ...config import ConfigBase

# Special token ids (Qwen2.5 tokenizer)
IM_START_TOKEN_ID = 151644  # <|im_start|>
IM_END_TOKEN_ID = 151645  # <|im_end|>
ENDOFTEXT_TOKEN_ID = 151643  # <|endoftext|>
VISION_START_TOKEN_ID = 151652  # <|vision_start|>
VISION_END_TOKEN_ID = 151653  # <|vision_end|>
IMAGE_PAD_TOKEN_ID = 151655  # <|image_pad|>
VIDEO_PAD_TOKEN_ID = 151656  # <|video_pad|>


@dataclass(frozen=True)
class QwenVisionConfig(ConfigBase):
    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    tokens_per_second: int = 2
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    out_hidden_size: int = 3584
    rms_norm_eps: float = 1e-6
    scan_blocks: bool = False
    quant_int8: bool = False
    quant_w8a8: bool = False
    window_resident: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def merge_unit(self) -> int:
        return self.spatial_merge_size**2


@dataclass(frozen=True)
class QwenTextConfig(ConfigBase):
    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    mrope_section: Tuple[int, ...] = (16, 24, 24)
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 128000
    lora_rank: int = 0
    lora_alpha: float = 0.0
    scan_layers: bool = False
    quant_int8: bool = False
    quant_int4: bool = False
    kv_cache_int8: bool = False
    quant_w8a8: bool = False


@dataclass(frozen=True)
class Qwen25VLConfig(ConfigBase):
    vision: QwenVisionConfig = field(default_factory=QwenVisionConfig)
    text: QwenTextConfig = field(default_factory=QwenTextConfig)
    image_token_id: int = IMAGE_PAD_TOKEN_ID
    video_token_id: int = VIDEO_PAD_TOKEN_ID
    vision_start_token_id: int = VISION_START_TOKEN_ID


QWEN25_VL_7B = Qwen25VLConfig(
    vision=QwenVisionConfig(out_hidden_size=3584),
    text=QwenTextConfig(
        vocab_size=152064,
        hidden_size=3584,
        intermediate_size=18944,
        num_hidden_layers=28,
        num_attention_heads=28,
        num_key_value_heads=4,
        tie_word_embeddings=False,
    ),
)

QWEN25_VL_3B = Qwen25VLConfig(
    vision=QwenVisionConfig(out_hidden_size=2048),
    text=QwenTextConfig(
        vocab_size=151936,
        hidden_size=2048,
        intermediate_size=11008,
        num_hidden_layers=36,
        num_attention_heads=16,
        num_key_value_heads=2,
        tie_word_embeddings=True,
    ),
)


def tiny_config(vocab_size: int = 160_000) -> Qwen25VLConfig:
    """Small config with real special-token ids for fast tests."""
    return Qwen25VLConfig(
        vision=QwenVisionConfig(
            depth=4,
            hidden_size=64,
            intermediate_size=128,
            num_heads=4,
            window_size=28,  # 2 merged patches per window side
            fullatt_block_indexes=(1, 3),
            out_hidden_size=64,
        ),
        text=QwenTextConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            head_dim=16,
            mrope_section=(2, 3, 3),
            tie_word_embeddings=False,
        ),
    )

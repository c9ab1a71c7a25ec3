"""Qwen2.5-VL composite: vision tower + decoder LM, counterpart of
`rga3_tpu/models/qwen25vl/model.py`. Vision tokens replace the
<|image_pad|>/<|video_pad|> embeddings in sequence order."""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ...device import DeviceLike, resolve_device
from ..init import random_init_
from .config import Qwen25VLConfig
from .language import QwenForCausalLM
from .vision import QwenVisionTower


def scatter_vision_tokens(embeds, input_ids, vision_embeds, image_token_id,
                          video_token_id):
    """Replace vision-pad token embeddings (B, L, D) with the tower's merged
    tokens (N, D), in order, by a cumulative-count gather."""
    mask = (input_ids == image_token_id) | (input_ids == video_token_id)
    idx = (mask.reshape(-1).long().cumsum(0) - 1).clamp(0, vision_embeds.shape[0] - 1)
    gathered = vision_embeds[idx].reshape(embeds.shape).to(embeds.dtype)
    return torch.where(mask[..., None], gathered, embeds)


class Qwen25VL(nn.Module):
    """Vision tower + LM, built on the card (or on `device="cpu"` when
    asked) in `dtype`; `remat` ("none", "full" or "dots") is the LM's activation
    strategy in training."""

    def __init__(self, cfg: Qwen25VLConfig, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32, remat: Any = "none"):
        super().__init__()
        factory = dict(device=resolve_device(device), dtype=dtype)
        self.cfg = cfg
        self.visual = QwenVisionTower(cfg.vision, **factory)
        self.lm = QwenForCausalLM(cfg.text, remat=remat, **factory)

    @property
    def device(self) -> torch.device:
        return self.lm.embed_tokens.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.lm.embed_tokens.weight.dtype

    def init_weights(self, generator: torch.Generator, std: float = 0.02) -> None:
        """Random weights from `generator` (`models.init.random_init_`)."""
        random_init_(self.named_parameters(), generator, std)

    def forward(self, input_ids: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                pixel_patches: Optional[torch.Tensor] = None,
                vision_layout: Optional[Dict[str, np.ndarray]] = None,
                cache: Optional[Dict[str, Any]] = None,
                logits_indices: Optional[torch.Tensor] = None,
                logits: bool = True) -> Dict[str, Any]:
        """`cache` (from `language.make_kv_cache`) is written in place;
        `logits_indices` (B,) computes the head at one position per row."""
        embeds = self.lm.embed(input_ids)
        if pixel_patches is not None:
            vis = self.visual(pixel_patches, vision_layout)
            embeds = scatter_vision_tokens(
                embeds, input_ids, vis, self.cfg.image_token_id,
                self.cfg.video_token_id,
            )
        return self.lm(inputs_embeds=embeds, position_ids=position_ids,
                       segment_ids=segment_ids, cache=cache,
                       logits_indices=logits_indices, logits=logits)

"""Qwen2.5-VL composite: vision tower + decoder LM, counterpart of
`rga3_tpu/models/qwen25vl/model.py`. Vision tokens replace the
<|image_pad|>/<|video_pad|> embeddings in sequence order."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

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
    def __init__(self, cfg: Qwen25VLConfig, **factory):
        super().__init__()
        self.cfg = cfg
        self.visual = QwenVisionTower(cfg.vision, **factory)
        self.lm = QwenForCausalLM(cfg.text, **factory)

    def forward(self, input_ids: torch.Tensor,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                pixel_patches: Optional[torch.Tensor] = None,
                vision_layout: Optional[Dict[str, np.ndarray]] = None,
                logits: bool = True) -> Dict[str, torch.Tensor]:
        embeds = self.lm.embed(input_ids)
        if pixel_patches is not None:
            vis = self.visual(pixel_patches, vision_layout)
            embeds = scatter_vision_tokens(
                embeds, input_ids, vis, self.cfg.image_token_id,
                self.cfg.video_token_id,
            )
        return self.lm(inputs_embeds=embeds, position_ids=position_ids,
                       segment_ids=segment_ids, logits=logits)

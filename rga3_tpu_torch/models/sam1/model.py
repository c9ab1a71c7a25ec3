"""SAM-v1: the ViT image encoder, SAM2's prompt encoder (the same
architecture) and SAM-v1's mask decoder, with the legacy UniGR's
language-prompt pathway; counterpart of `rga3_tpu/models/sam1/model.py`.

The text embeddings are the sparse prompt (with no point or box prompt
they are the sparse tokens alone) and `no_mask_embed` the dense one; every
frame of a video decodes with its prompt, batched over the frames. Pixels
are normalized by the mean / std and padded bottom-right (`preprocess`).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.resize import sam_normalize_maybe
from ..sam2.prompt_encoder import PromptEncoder
from .config import Sam1Config
from .decoder import Sam1MaskDecoder
from .vit import ImageEncoderViT


class Sam1Model(nn.Module):
    def __init__(self, cfg: Sam1Config, **factory):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoderViT(cfg, **factory)
        self.prompt_encoder = PromptEncoder(cfg, **factory)
        self.mask_decoder = Sam1MaskDecoder(cfg, **factory)

    @property
    def dtype(self) -> torch.dtype:
        return self.image_encoder.pos_embed.dtype

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) frames, uint8 (normalized here with the ImageNet
        statistics, which are SAM-v1's) or normalized float ->
        (B, s, s, d_model) image embeddings."""
        return self.image_encoder(sam_normalize_maybe(images).to(self.dtype))

    def decode_with_language(self, image_embeddings: torch.Tensor,
                             language_embd: torch.Tensor,
                             multimask_output: bool = False) -> Dict[str, torch.Tensor]:
        """Language-only prompting: the sparse tokens are the text
        embeddings (B, N, d_model), the dense prompt `no_mask_embed`.
        Returns low_res_masks (B, M, 4s, 4s) f32 and iou_predictions."""
        b = image_embeddings.shape[0]
        s = self.cfg.feat_size
        dense = self.prompt_encoder.no_mask_embed.weight[0][None, None, None].expand(
            b, s, s, self.cfg.d_model)
        masks, iou = self.mask_decoder(
            image_embeddings, self.prompt_encoder.dense_pe(),
            language_embd.to(image_embeddings.dtype), dense, multimask_output=multimask_output)
        return {"low_res_masks": masks, "iou_predictions": iou}

    def decode_with_prompts(self, image_embeddings: torch.Tensor,
                            point_coords: Optional[torch.Tensor] = None,
                            point_labels: Optional[torch.Tensor] = None,
                            masks: Optional[torch.Tensor] = None,
                            multimask_output: bool = True) -> Dict[str, torch.Tensor]:
        """Point / box / mask prompting (points (B, P, 2) in pixels with
        labels (B, P); a box is its two corners labelled 2 and 3; a mask
        (B, 4s, 4s, 1))."""
        sparse, dense = self.prompt_encoder(point_coords, point_labels, masks=masks,
                                            batch=image_embeddings.shape[0])
        out_masks, iou = self.mask_decoder(
            image_embeddings, self.prompt_encoder.dense_pe(), sparse.to(image_embeddings.dtype),
            dense.to(image_embeddings.dtype), multimask_output=multimask_output)
        return {"low_res_masks": out_masks, "iou_predictions": iou}

    def decode_frames_with_language(self, frames: torch.Tensor, language_embd: torch.Tensor,
                                    multimask_output: bool = False) -> Dict[str, torch.Tensor]:
        """Frames (T, S, S, 3) and their prompts (T, N, d_model) in one
        batch: `encode_image`, then `decode_with_language`."""
        return self.decode_with_language(self.encode_image(frames), language_embd,
                                         multimask_output=multimask_output)

    def preprocess(self, x: torch.Tensor) -> torch.Tensor:
        """(..., H, W, 3) raw pixels -> normalized f32, zero padded
        bottom-right to image_size."""
        mean = torch.tensor(self.cfg.pixel_mean, device=x.device)
        std = torch.tensor(self.cfg.pixel_std, device=x.device)
        x = (x.float() - mean) / std
        h, w = x.shape[-3:-1]
        size = self.cfg.image_size
        return F.pad(x, (0, 0, 0, size - w, 0, size - h))

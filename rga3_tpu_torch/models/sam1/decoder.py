"""SAM-v1's mask decoder, counterpart of `rga3_tpu/models/sam1/decoder.py`:
SAM2's decoder without the object-score token, the high-resolution skip
features and the stability selection, on SAM2's two-way transformer (the
same architecture)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..sam2.layers import ChannelLayerNorm, MLP
from ..sam2.mask_decoder import TwoWayTransformer
from .config import Sam1Config


class Sam1MaskDecoder(nn.Module):
    """Computes in its parameters' dtype, its inputs cast to it; the mask
    logits in f32."""

    def __init__(self, cfg: Sam1Config, **factory):
        super().__init__()
        d = cfg.d_model
        self.num_mask_tokens = cfg.num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, d, **factory)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, d, **factory)
        self.transformer = TwoWayTransformer(cfg, **factory)
        self.output_upscaling_0 = nn.ConvTranspose2d(d, d // 4, 2, 2, **factory)
        self.output_upscaling_1 = ChannelLayerNorm(d // 4, **factory)
        self.output_upscaling_3 = nn.ConvTranspose2d(d // 4, d // 8, 2, 2, **factory)
        for i in range(self.num_mask_tokens):
            setattr(self, f"output_hypernetworks_mlps_{i}", MLP(d, d, d // 8, 3, **factory))
        self.iou_prediction_head = MLP(d, cfg.iou_head_hidden, self.num_mask_tokens,
                                       cfg.iou_head_depth,
                                       sigmoid_output=cfg.iou_prediction_use_sigmoid, **factory)

    @staticmethod
    def _nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.iou_token.weight.dtype

    def predict(self, image_embeddings, image_pe, sparse_prompt, dense_prompt
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """All mask logits (B, M, 4s, 4s) and IoU predictions (B, M)."""
        dt = self.dtype
        image_embeddings, sparse_prompt, dense_prompt = (
            t.to(dt) for t in (image_embeddings, sparse_prompt, dense_prompt))
        b = sparse_prompt.shape[0]
        output_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        tokens = torch.cat([output_tokens[None].expand(b, *output_tokens.shape), sparse_prompt],
                           dim=1)
        src = image_embeddings + dense_prompt
        pos = image_pe[None].expand(src.shape).to(src.dtype)
        hs, keys = self.transformer(src, pos, tokens)
        iou_token_out = hs[:, 0]
        mask_tokens_out = hs[:, 1:1 + self.num_mask_tokens]
        h, w = src.shape[1:3]
        up = self._nhwc(self.output_upscaling_0, keys.reshape(b, h, w, -1))
        up = F.gelu(self.output_upscaling_1(up))
        up = F.gelu(self._nhwc(self.output_upscaling_3, up))
        hyper = torch.stack([
            getattr(self, f"output_hypernetworks_mlps_{i}")(mask_tokens_out[:, i])
            for i in range(self.num_mask_tokens)
        ], dim=1)  # (B, M, C/8)
        masks = torch.einsum("bmc,bhwc->bmhw", hyper.float(), up.float())
        return masks, self.iou_prediction_head(iou_token_out)

    def forward(self, image_embeddings, image_pe, sparse_prompt, dense_prompt,
                multimask_output: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """The three multimask outputs, or the first mask alone."""
        masks, iou_pred = self.predict(image_embeddings, image_pe, sparse_prompt, dense_prompt)
        if multimask_output:
            return masks[:, 1:], iou_pred[:, 1:]
        return masks[:, 0:1], iou_pred[:, 0:1]

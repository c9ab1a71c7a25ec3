"""SAM2 prompt encoder, counterpart of
`rga3_tpu/models/sam2/prompt_encoder.py`: point prompts (or none: the
padding point alone, as the language-prompted decode has) as the sparse
embedding; a mask prompt (`embed_masks`: two stride-2 convolutions with
channel LayerNorm and GELU, then a 1x1 convolution), or else
`no_mask_embed`, as the dense one."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .config import Sam2Config
from .layers import ChannelLayerNorm, PositionEmbeddingRandom


class PromptEncoder(nn.Module):
    def __init__(self, cfg: Sam2Config, **factory):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.pe_layer = PositionEmbeddingRandom(d // 2, **factory)
        # neg, pos, box top-left, box bottom-right
        for i in range(4):
            setattr(self, f"point_embeddings_{i}", nn.Embedding(1, d, **factory))
        self.not_a_point_embed = nn.Embedding(1, d, **factory)
        self.no_mask_embed = nn.Embedding(1, d, **factory)
        mask_chans = 16  # the mask-prompt branch
        self.mask_downscaling_0 = nn.Conv2d(1, mask_chans // 4, 2, 2, **factory)
        self.mask_downscaling_1 = ChannelLayerNorm(mask_chans // 4, **factory)
        self.mask_downscaling_3 = nn.Conv2d(mask_chans // 4, mask_chans, 2, 2, **factory)
        self.mask_downscaling_4 = ChannelLayerNorm(mask_chans, **factory)
        self.mask_downscaling_6 = nn.Conv2d(mask_chans, d, 1, **factory)

    def dense_pe(self) -> torch.Tensor:
        s = self.cfg.feat_size
        return self.pe_layer.grid_pe(s, s)

    def embed_points(self, coords, labels):
        """coords (B, P, 2) pixels; labels (B, P) in {-1, 0, 1, 2, 3}; one
        padding point (0, 0) / -1 is appended."""
        b = coords.shape[0]
        coords = torch.cat([coords, coords.new_zeros(b, 1, 2)], dim=1)
        labels = torch.cat([labels, -labels.new_ones(b, 1)], dim=1)
        pe = self.pe_layer((coords + 0.5) / self.cfg.image_size)
        lab = labels[..., None]
        out = torch.where(lab == -1, torch.zeros_like(pe), pe)
        out = out + torch.where(
            lab == -1, self.not_a_point_embed.weight[0].float(), 0.0
        )
        for i in range(4):
            emb = getattr(self, f"point_embeddings_{i}").weight[0].float()
            out = out + torch.where(lab == i, emb, 0.0)
        return out

    @staticmethod
    def _conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def embed_masks(self, masks: torch.Tensor) -> torch.Tensor:
        """(B, 4s, 4s, 1) mask prompt -> (B, s, s, C), in the branch's dtype."""
        x = masks.to(self.mask_downscaling_0.weight.dtype)
        x = F.gelu(self.mask_downscaling_1(self._conv(self.mask_downscaling_0, x)))
        x = F.gelu(self.mask_downscaling_4(self._conv(self.mask_downscaling_3, x)))
        return self._conv(self.mask_downscaling_6, x)

    def forward(self, point_coords: Optional[torch.Tensor] = None,
                point_labels: Optional[torch.Tensor] = None,
                masks: Optional[torch.Tensor] = None, batch: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sparse (B, P + 1, C) f32 embeddings of the points (coords (B, P, 2)
        in pixels, labels (B, P)), or of one padding point per row of
        `batch` without them; dense (B, s, s, C): `embed_masks(masks)` of a
        (B, 4s, 4s, 1) mask prompt, else `no_mask_embed`."""
        if point_coords is None:
            dev = self.no_mask_embed.weight.device
            point_coords = torch.zeros(batch, 1, 2, device=dev)
            point_labels = -torch.ones(batch, 1, dtype=torch.int32, device=dev)
        sparse = self.embed_points(point_coords, point_labels)
        if masks is not None:
            return sparse, self.embed_masks(masks)
        s = self.cfg.feat_size
        dense = self.no_mask_embed.weight[0][None, None, None].expand(
            sparse.shape[0], s, s, self.cfg.d_model
        )
        return sparse, dense

"""The legacy UniGR: Qwen2.5-VL + the [SEG] projection + SAM-v1 (ViT-H),
counterpart of `rga3_tpu/models/unigr/legacy.py`.

The [SEG] recipe is the SAM2 composite's (`models/unigr/model.py`): the
[SEG] hidden state gathered shifted left by one and projected by
`text_hidden_fcs`. The grounding backbone is SAM-v1: every frame decodes
its own mask from the shared text prompt with `multimask_output=False`
(SAM-v1's decoder has no stability selection), batched over the frames,
with no video memory. The losses are the weighted cross-entropy, BCE and
dice over the per-frame masks.

`UniGRLegacy(cfg, device=None, dtype=torch.float32, remat="none",
qwen=None)` builds the model on the card (or on `device="cpu"` when asked);
`qwen`, a `Qwen25VL` already built, is shared instead of built again.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ...config import ConfigBase, SegHeadConfig
from ...device import DeviceLike, resolve_device
from ...ops import losses as loss_ops
from ...ops.resize import resize_bilinear
from ...ops.seg_gather import gather_seg_embeddings
from ..init import random_init_
from ..qwen25vl.config import Qwen25VLConfig
from ..qwen25vl.model import Qwen25VL
from ..sam1.config import Sam1Config
from ..sam1.model import Sam1Model
from .model import SegProjection


@dataclass(frozen=True)
class UniGRLegacyConfig(ConfigBase):
    qwen: Qwen25VLConfig = field(default_factory=Qwen25VLConfig)
    sam1: Sam1Config = field(default_factory=Sam1Config)
    seg: SegHeadConfig = field(default_factory=SegHeadConfig)


class UniGRLegacy(nn.Module):
    def __init__(self, cfg: UniGRLegacyConfig, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32, remat: Any = "none",
                 qwen: Optional[Qwen25VL] = None):
        super().__init__()
        self.cfg = cfg
        factory = dict(device=resolve_device(device), dtype=dtype)
        self.qwen = qwen if qwen is not None else Qwen25VL(cfg.qwen, remat=remat, **factory)
        self.sam_model = Sam1Model(cfg.sam1, **factory)
        self.text_hidden_fcs = SegProjection(cfg.qwen.text.hidden_size, cfg.seg.out_dim,
                                             **factory)

    @property
    def device(self) -> torch.device:
        return self.sam_model.image_encoder.pos_embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.sam_model.dtype

    def seg_embeddings(self, hidden: torch.Tensor, token_ids: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Project the LM's hidden states and gather the first [SEG]'s."""
        return gather_seg_embeddings(
            self.text_hidden_fcs(hidden), token_ids, self.cfg.seg.seg_token_id
        )

    @property
    def sam_image_size(self) -> int:
        return self.cfg.sam1.image_size

    def encode_frames(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """SAM-v1's image embedding of (B, S, S, 3) frames, as a 1-tuple."""
        return (self.sam_model.encode_image(images),)

    def decode_logits(self, feats: Tuple[torch.Tensor, ...], lang: torch.Tensor) -> torch.Tensor:
        """(B, S/4, S/4) low-resolution mask logits, one language prompt
        (B, 1, C) a frame (single-mask output)."""
        out = self.sam_model.decode_with_language(feats[0], lang, multimask_output=False)
        return out["low_res_masks"][:, 0]

    def _qwen(self, input_ids, position_ids, segment_ids=None, pixel_patches=None,
              vision_layout=None) -> Dict[str, torch.Tensor]:
        dev = self.device
        return self.qwen(
            torch.as_tensor(input_ids, device=dev),
            position_ids=torch.as_tensor(position_ids, device=dev),
            segment_ids=None if segment_ids is None else torch.as_tensor(segment_ids, device=dev),
            pixel_patches=None if pixel_patches is None else torch.as_tensor(pixel_patches),
            vision_layout=vision_layout,
        )

    def train_forward(
        self,
        input_ids: torch.Tensor,  # (B, L)
        labels: torch.Tensor,  # (B, L), -100 masked
        position_ids: torch.Tensor,  # (3, B, L)
        segment_ids: Optional[torch.Tensor],  # (B, L): the attention mask
        images_sam: torch.Tensor,  # (B, T, H, W, 3) uint8, or normalized float
        gt_masks: torch.Tensor,  # (B, T, h, w) float 0/1
        masks_valid: torch.Tensor,  # (B,) 1.0 when the sample supervises masks
        pixel_patches: Optional[torch.Tensor] = None,
        vision_layout: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, torch.Tensor]:
        """The training losses: the LM's next-token cross-entropy times
        `ce_loss_weight`; each sample's [SEG] embedding prompting each of its
        T frames' single-mask SAM-v1 decode, the low-resolution mask resized
        bilinearly to the gt size, and the BCE and dice mask losses weighted
        per sample by has-[SEG] x `masks_valid`. Returns loss, ce_loss,
        mask_bce_loss, mask_dice_loss and mask_loss (f32 scalars)."""
        cfg = self.cfg.seg
        dev = self.device
        images_sam = torch.as_tensor(images_sam, device=dev)
        b, t = images_sam.shape[:2]
        labels = torch.as_tensor(labels, device=dev)
        out = self._qwen(input_ids, position_ids, segment_ids, pixel_patches, vision_layout)
        ce_loss = loss_ops.cross_entropy_loss(out["logits"], labels) * cfg.ce_loss_weight
        seg_emb, has_seg = self.seg_embeddings(out["hidden_states"], labels)
        lang = seg_emb[:, None].expand(b, t, cfg.out_dim).reshape(b * t, 1, cfg.out_dim)
        frames = images_sam.reshape(b * t, *images_sam.shape[2:])
        low_res = self.sam_model.decode_frames_with_language(
            frames, lang, multimask_output=False)["low_res_masks"][:, 0]
        gt_masks = torch.as_tensor(gt_masks, device=dev)
        size = tuple(gt_masks.shape[-2:])
        pred = resize_bilinear(low_res, size)
        valid = has_seg.float() * torch.as_tensor(masks_valid, device=dev).float()
        valid_bt = valid.repeat_interleave(t)
        gt_flat = gt_masks.reshape(b * t, *size)
        mask_bce = loss_ops.masked_sigmoid_ce_loss(pred, gt_flat, valid_bt) * cfg.bce_loss_weight
        mask_dice = loss_ops.masked_dice_loss(pred, gt_flat, valid_bt,
                                              scale=cfg.dice_scale) * cfg.dice_loss_weight
        mask_loss = mask_bce + mask_dice
        return {
            "loss": ce_loss + mask_loss,
            "ce_loss": ce_loss,
            "mask_bce_loss": mask_bce,
            "mask_dice_loss": mask_dice,
            "mask_loss": mask_loss,
        }

    @torch.no_grad()
    def evaluate_step(self, input_ids, position_ids, images_sam: torch.Tensor,
                      pixel_patches=None, vision_layout=None) -> Dict[str, torch.Tensor]:
        """Teacher-forced [SEG] segmentation of the frames `images_sam`
        (T, H, W, 3): low_res_masks (T, 1, 4s, 4s) f32 (the caller resizes
        them to the frame size), has_seg and the LM's logits."""
        out = self._qwen(input_ids, position_ids, None, pixel_patches, vision_layout)
        ids = torch.as_tensor(input_ids, device=self.device)
        seg_emb, has_seg = self.seg_embeddings(out["hidden_states"], ids)
        frames = torch.as_tensor(images_sam, device=self.device)
        t = frames.shape[0]
        lang = seg_emb[0][None, None].expand(t, 1, self.cfg.seg.out_dim)
        low = self.sam_model.decode_frames_with_language(frames, lang, multimask_output=False)
        return {"low_res_masks": low["low_res_masks"], "has_seg": has_seg,
                "logits": out["logits"]}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02,
                     qwen: bool = True) -> None:
        """Random weights from `generator` (on the parameters' device), as
        `UniGR.init_weights` draws them: the Qwen2.5-VL parameters first
        (the values UniGR gets from the same seed), then `text_hidden_fcs`,
        then SAM-v1, the module this composite adds. `qwen=False` leaves a
        shared Qwen2.5-VL as it is (the stream then starts at
        `text_hidden_fcs`)."""
        params = [(n, p) for n, p in self.named_parameters()
                  if qwen or not n.startswith("qwen.")]
        random_init_(sorted(params, key=lambda item: item[0].startswith("sam_model.")),
                     generator, std)

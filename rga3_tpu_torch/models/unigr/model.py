"""UniGR composite: Qwen2.5-VL + the [SEG] projection head + SAM2, counterpart
of `rga3_tpu/models/unigr/model.py`.

`UniGR(cfg, device=None, dtype=torch.float32, remat="none")` builds the model
on the card (or on `device="cpu"` when asked) in `dtype`; `init_weights`
fills it from a `torch.Generator` without touching the host. The inference
path is `seg_embeddings` plus the SAM2 decode (`evaluation/segmentor.py`);
`train_forward` is the training loss.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ...config import ConfigBase, SegHeadConfig
from ...device import DeviceLike, resolve_device
from ...ops import losses as loss_ops
from ...ops.resize import resize_bilinear, sam_normalize_maybe
from ...ops.seg_gather import gather_seg_embeddings
from ...parallel.tensor import vocab_parallel_cross_entropy
from ..init import random_init_
from ..qwen25vl.config import Qwen25VLConfig
from ..qwen25vl.model import Qwen25VL
from ..sam2.config import Sam2Config
from ..sam2.model import Sam2Model


@dataclass(frozen=True)
class UniGRConfig(ConfigBase):
    qwen: Qwen25VLConfig = field(default_factory=Qwen25VLConfig)
    sam2: Sam2Config = field(default_factory=Sam2Config)
    seg: SegHeadConfig = field(default_factory=SegHeadConfig)


class SegProjection(nn.Module):
    """text_hidden_fcs: Linear(H, H) -> ReLU -> Linear(H, out_dim), in its
    parameters' dtype (float32 when the training entry point holds it in
    f32 under f32 masters, as the JAX package's f32 parameters promote it)."""

    def __init__(self, in_dim: int, out_dim: int, **factory):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, in_dim, **factory)
        self.fc2 = nn.Linear(in_dim, out_dim, **factory)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x.to(self.fc1.weight.dtype))))


class UniGR(nn.Module):
    def __init__(self, cfg: UniGRConfig, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32, remat: Any = "none"):
        super().__init__()
        self.cfg = cfg
        factory = dict(device=resolve_device(device), dtype=dtype)
        self.qwen = Qwen25VL(cfg.qwen, remat=remat, **factory)
        self.grounding_encoder = Sam2Model(cfg.sam2, **factory)
        self.text_hidden_fcs = SegProjection(
            cfg.qwen.text.hidden_size, cfg.seg.out_dim, **factory
        )

    @property
    def device(self) -> torch.device:
        return self.grounding_encoder.no_mem_embed.device

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: the LM's (SAM2 and the head may be held in
        f32 under f32 parameters, and compute in it)."""
        return self.qwen.dtype

    def seg_embeddings(self, hidden: torch.Tensor, token_ids: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Project the LM's hidden states and gather the first [SEG]'s."""
        return gather_seg_embeddings(
            self.text_hidden_fcs(hidden), token_ids, self.cfg.seg.seg_token_id
        )

    @property
    def sam_image_size(self) -> int:
        return self.cfg.sam2.image_size

    def encode_frames(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """SAM2's features (s0, s1, s2) of (B, S, S, 3) frames."""
        return tuple(self.grounding_encoder.forward_image(images)["backbone_fpn"])

    def decode_logits(self, feats: Tuple[torch.Tensor, ...], lang: torch.Tensor) -> torch.Tensor:
        """(B, S, S) mask logits at SAM2's resolution, one language prompt
        (B, 1, C) a frame."""
        out = self.grounding_encoder.decode_features_with_language(*feats, lang)
        return out["high_res_masks"][:, 0]

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
        reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        """The training losses (the JAX package's `train_forward`): the LM's
        next-token cross-entropy times `ce_loss_weight`; the [SEG] embedding
        tiled over the sample's T SAM frames, a no-memory language decode of
        every frame (the backbone frozen under `freeze_sam_backbone`), the
        best-IoU high-resolution mask resized bilinearly to the gt size, and
        the BCE and dice mask losses weighted per sample by has-[SEG] x
        `masks_valid`. Returns loss, ce_loss, mask_bce_loss, mask_dice_loss
        and mask_loss (f32 scalars).

        `reduce`, for rows split over ranks, sums the normalisers (a (2,)
        f32 tensor: the label count and the valid masks' count of these
        rows) over the ranks that hold the global batch's other rows (the
        JAX package normalises over the global batch); the losses are then
        these rows' shares of the global losses. Over the tensor axis the
        cross-entropy is vocab-parallel; the [SEG] hidden states are whole on
        every rank after the LM's last row-parallel sum, so SAM2 and the
        mask losses compute whole on each."""
        cfg = self.cfg.seg
        dev = self.device
        images_sam = torch.as_tensor(images_sam, device=dev)
        b, t = images_sam.shape[:2]
        labels = torch.as_tensor(labels, device=dev)
        out = self.qwen(
            torch.as_tensor(input_ids, device=dev),
            position_ids=torch.as_tensor(position_ids, device=dev),
            segment_ids=None if segment_ids is None else torch.as_tensor(segment_ids, device=dev),
            pixel_patches=None if pixel_patches is None else torch.as_tensor(pixel_patches),
            vision_layout=vision_layout,
        )
        seg_emb, has_seg = self.seg_embeddings(out["hidden_states"], labels)
        valid = has_seg.float() * torch.as_tensor(masks_valid, device=dev).float()
        valid_bt = valid.repeat_interleave(t)
        ce_total = mask_total = None
        if reduce is not None:
            ce_total, mask_total = reduce(torch.stack([loss_ops.label_count(labels),
                                                       loss_ops.masked_count(valid_bt)]))
        lm = self.qwen.lm
        if lm.vocab_range is not None:  # the tensor axis: this rank's vocabulary columns
            ce_loss = vocab_parallel_cross_entropy(out["logits"], labels, lm.vocab_range[0],
                                                   lm.tp.group, total=ce_total)
        else:
            ce_loss = loss_ops.cross_entropy_loss(out["logits"], labels, total=ce_total)
        ce_loss = ce_loss * cfg.ce_loss_weight

        lang = seg_emb[:, None].expand(b, t, cfg.out_dim).reshape(b * t, 1, cfg.out_dim)
        frames = sam_normalize_maybe(images_sam.reshape(b * t, *images_sam.shape[2:]))
        sam_out = self.grounding_encoder.decode_frames_with_language(
            frames.to(self.dtype), lang, multimask_output=True, training=True,
            stop_backbone_grad=cfg.freeze_sam_backbone,
        )
        gt_masks = torch.as_tensor(gt_masks, device=dev)
        size = tuple(gt_masks.shape[-2:])
        pred = resize_bilinear(sam_out["high_res_masks"][:, 0], size)  # (B*T, h, w)

        gt_flat = gt_masks.reshape(b * t, *size)
        mask_bce = loss_ops.masked_sigmoid_ce_loss(pred, gt_flat, valid_bt,
                                                   total=mask_total) * cfg.bce_loss_weight
        mask_dice = loss_ops.masked_dice_loss(pred, gt_flat, valid_bt, scale=cfg.dice_scale,
                                              total=mask_total) * cfg.dice_loss_weight
        mask_loss = mask_bce + mask_dice
        return {
            "loss": ce_loss + mask_loss,
            "ce_loss": ce_loss,
            "mask_bce_loss": mask_bce,
            "mask_dice_loss": mask_dice,
            "mask_loss": mask_loss,
        }

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02) -> None:
        """Random weights from `generator` (on the parameters' device):
        normal(0, std) for Linear / Embedding / conv weights and raw
        parameters, zero biases, unit norm scales, and zero LoRA B (PEFT's
        init: the adapters start as the identity). The SAM2 tracker's
        parameters draw last, so that a seed gives every other parameter
        the values it gave before the tracker was ported."""
        tracker = ("memory_attention.", "memory_encoder.", "maskmem_tpos_enc", "no_mem_pos_enc")
        random_init_(sorted(self.named_parameters(),
                            key=lambda item: any(t in item[0] for t in tracker)), generator, std)

"""SAM2 top-level model, counterpart of `rga3_tpu/models/sam2/model.py`:
image encoding (`forward_image`), the language- or point-prompted mask
decode (`forward_sam_heads`; `decode_features_with_language`, and
`decode_frames_with_language` from the frames, the training path's), and
the tracker's memory steps (`condition_on_memory`, `encode_new_memory`,
`obj_ptrs_to_tokens`), which `video.track_video` drives."""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn

from ...ops.resize import resize_bilinear, sam_normalize_maybe
from .config import Sam2Config
from .layers import MLP
from .mask_decoder import MaskDecoder
from .memory import MemoryAttention, MemoryEncoder
from .neck import ImageEncoder, conv1x1
from .prompt_encoder import PromptEncoder


class Sam2Model(nn.Module):
    def __init__(self, cfg: Sam2Config, **factory):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_dim
        self.image_encoder = ImageEncoder(cfg, **factory)
        self.sam_prompt_encoder = PromptEncoder(cfg, **factory)
        self.sam_mask_decoder = MaskDecoder(cfg, **factory)
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, d, **factory))
        self.no_obj_ptr = nn.Parameter(torch.zeros(1, d, **factory))
        self.obj_ptr_proj = MLP(d, d, d, 3, **factory)
        # the tracker's modules last: a seeded init draws the other
        # parameters as it did before they were ported
        self.memory_attention = MemoryAttention(cfg, **factory)
        self.memory_encoder = MemoryEncoder(cfg, **factory)
        self.no_mem_pos_enc = nn.Parameter(torch.zeros(1, 1, d, **factory))
        self.maskmem_tpos_enc = nn.Parameter(
            torch.zeros(cfg.num_maskmem, 1, 1, cfg.mem_dim, **factory))

    @property
    def dtype(self) -> torch.dtype:
        return self.no_mem_embed.dtype

    def forward_image(self, images: torch.Tensor, stop_backbone_grad: bool = False
                      ) -> Dict[str, List[torch.Tensor]]:
        """images (B, H, W, 3): uint8 (normalized here) or normalized float.
        Returns the FPN features, the two high-resolution levels already
        projected by the decoder's conv_s0/conv_s1.

        `stop_backbone_grad` cuts the gradient at the trunk + neck: they run
        under `torch.no_grad()` (a frozen backbone needs no backward, nor
        its activations kept), while conv_s0/conv_s1, which belong to the
        trained mask decoder, stay below the cut."""
        x = sam_normalize_maybe(images).to(self.dtype)
        if stop_backbone_grad:
            with torch.no_grad():
                out = self.image_encoder(x)
        else:
            out = self.image_encoder(x)
        fpn = list(out["backbone_fpn"])
        dt = self.sam_mask_decoder.dtype
        fpn[0] = conv1x1(self.sam_mask_decoder.conv_s0, fpn[0].to(dt))
        fpn[1] = conv1x1(self.sam_mask_decoder.conv_s1, fpn[1].to(dt))
        return {"backbone_fpn": fpn, "vision_pos_enc": out["vision_pos_enc"]}

    def forward_sam_heads(self, backbone_features, high_res_features,
                          language_embd: Optional[torch.Tensor] = None,
                          point_coords: Optional[torch.Tensor] = None,
                          point_labels: Optional[torch.Tensor] = None,
                          multimask_output: bool = True, training: bool = False):
        """The mask decoder on (B, s, s, C) features, prompted by
        `language_embd` (B, N, C), points (B, P, 2) pixels / (B, P) labels,
        both or neither."""
        cfg = self.cfg
        b = backbone_features.shape[0]
        sparse, dense = self.sam_prompt_encoder(point_coords, point_labels, batch=b)
        dt = self.sam_mask_decoder.dtype
        sparse = sparse.to(dt)
        if language_embd is not None:
            sparse = torch.cat([sparse, language_embd.to(dt)], dim=1)
        image_pe = self.sam_prompt_encoder.dense_pe()
        low_res_multimasks, ious, sam_tokens_out, object_score_logits = (
            self.sam_mask_decoder(
                backbone_features, image_pe, sparse, dense,
                high_res_features, multimask_output=multimask_output,
                training=training,
            )
        )
        low_res_multimasks = low_res_multimasks.float()
        # select the best-IoU mask at low resolution, then upscale only it
        # (bilinear resize is per channel, so this equals resize-then-select)
        sam_output_token = sam_tokens_out[:, 0]
        if multimask_output:
            best = ious.argmax(dim=-1)
            bidx = torch.arange(b, device=best.device)
            low_res_masks = low_res_multimasks[bidx, best][:, None]
            if sam_tokens_out.shape[1] > 1:
                sam_output_token = sam_tokens_out[bidx, best]
        else:
            low_res_masks = low_res_multimasks
        high_res_masks = resize_bilinear(
            low_res_masks, (cfg.image_size, cfg.image_size)
        )
        obj_ptr = self.obj_ptr_proj(sam_output_token.to(self.dtype))
        appearing = (object_score_logits > 0).to(obj_ptr.dtype)
        obj_ptr = appearing * obj_ptr + (1.0 - appearing) * self.no_obj_ptr
        return {
            "low_res_multimasks": low_res_multimasks,
            "ious": ious,
            "low_res_masks": low_res_masks,
            "high_res_masks": high_res_masks,
            "obj_ptr": obj_ptr,
            "object_score_logits": object_score_logits,
        }

    def decode_frames_with_language(self, images, language_embd,
                                    multimask_output: bool = True, training: bool = False,
                                    stop_backbone_grad: bool = False):
        """Batched no-memory language decode of frames (T, H, W, 3) with
        prompts (T, N, C): `forward_image`, then
        `decode_features_with_language`."""
        s0, s1, s2 = self.forward_image(images, stop_backbone_grad)["backbone_fpn"]
        return self.decode_features_with_language(
            s0, s1, s2, language_embd, multimask_output=multimask_output, training=training)

    def decode_features_with_language(self, s0, s1, s2, language_embd,
                                      multimask_output: bool = True, training: bool = False):
        """Language decode from precomputed FPN features: every frame is a
        conditioning frame, so the stride-16 feature gets `no_mem_embed`."""
        pix = s2 + self.no_mem_embed.reshape(1, 1, 1, -1).to(s2.dtype)
        return self.forward_sam_heads(
            pix, (s0, s1), language_embd=language_embd,
            multimask_output=multimask_output, training=training,
        )

    # ------------------------------------------------------------------
    # the memory-conditioned tracking step (driven by video.track_video)
    # ------------------------------------------------------------------
    def condition_on_memory(self, current_feat, current_pos, memory, memory_pos,
                            memory_valid, num_obj_ptr_tokens: int) -> torch.Tensor:
        """(B, s, s, C) features and positions attend to the (B, Lk,
        mem_dim) bank (`memory_valid` (B, Lk) bool); (B, s, s, C) out."""
        b, s, _, c = current_feat.shape
        out = self.memory_attention(
            current_feat.reshape(b, s * s, c), current_pos.reshape(b, s * s, c),
            memory, memory_pos, num_obj_ptr_tokens=num_obj_ptr_tokens, k_valid=memory_valid)
        return out.reshape(b, s, s, c)

    def encode_new_memory(self, current_feat, high_res_masks):
        """(B, s, s, C) stride-16 features and (B, S, S, 1) mask logits ->
        memory features (B, s, s, mem_dim) and their positional encoding:
        the scaled sigmoid, then the memory encoder."""
        cfg = self.cfg
        mask_for_mem = (torch.sigmoid(high_res_masks) * cfg.sigmoid_scale_for_mem_enc
                        + cfg.sigmoid_bias_for_mem_enc)
        return self.memory_encoder(current_feat, mask_for_mem, skip_mask_sigmoid=True)

    def obj_ptrs_to_tokens(self, obj_ptrs: torch.Tensor) -> torch.Tensor:
        """(N, B, C) pointers -> (N * C / mem_dim, B, mem_dim) tokens."""
        n, b, c = obj_ptrs.shape
        r = c // self.cfg.mem_dim
        toks = obj_ptrs.reshape(n, b, r, self.cfg.mem_dim)
        return toks.permute(0, 2, 1, 3).reshape(n * r, b, self.cfg.mem_dim)

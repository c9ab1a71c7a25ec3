"""SAM2 mask decoder (two-way transformer, hypernetwork mask heads, IoU and
object-score heads), NHWC; counterpart of
`rga3_tpu/models/sam2/mask_decoder.py`."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .config import Sam2Config
from .layers import ChannelLayerNorm, LayerNorm, MLP, SamAttention


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, cfg: Sam2Config, skip_first_layer_pe: bool, **factory):
        super().__init__()
        d, h = cfg.d_model, cfg.twoway_heads
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = SamAttention(d, h, **factory)
        self.norm1 = LayerNorm(d, **factory)
        self.cross_attn_token_to_image = SamAttention(d, h, 2, **factory)
        self.norm2 = LayerNorm(d, **factory)
        self.mlp = MLP(d, cfg.twoway_mlp_dim, d, 2, activation="relu", **factory)
        self.norm3 = LayerNorm(d, **factory)
        self.cross_attn_image_to_token = SamAttention(d, h, 2, **factory)
        self.norm4 = LayerNorm(d, **factory)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: Sam2Config, **factory):
        super().__init__()
        self.depth = cfg.twoway_depth
        for i in range(cfg.twoway_depth):
            setattr(self, f"layers_{i}",
                    TwoWayAttentionBlock(cfg, i == 0, **factory))
        self.final_attn_token_to_image = SamAttention(
            cfg.d_model, cfg.twoway_heads, 2, **factory
        )
        self.norm_final_attn = LayerNorm(cfg.d_model, **factory)

    def forward(self, image_embedding, image_pe, point_embedding):
        b, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(b, h * w, c)
        key_pe = image_pe.reshape(b, h * w, c)
        queries = point_embedding
        for i in range(self.depth):
            queries, keys = getattr(self, f"layers_{i}")(
                queries, keys, point_embedding, key_pe
            )
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys)
        )
        return queries, keys


class MaskDecoder(nn.Module):
    """Computes in its parameters' dtype, its inputs cast to it: the model's
    dtype, or float32 when the training entry point holds the decoder in
    f32 under f32 masters (the JAX package's f32 parameters promote the
    decoder's bf16 inputs to f32)."""

    def __init__(self, cfg: Sam2Config, **factory):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.num_mask_tokens = cfg.num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, d, **factory)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, d, **factory)
        self.obj_score_token = nn.Embedding(1, d, **factory)
        self.transformer = TwoWayTransformer(cfg, **factory)
        self.output_upscaling_0 = nn.ConvTranspose2d(d, d // 4, 2, 2, **factory)
        self.output_upscaling_1 = ChannelLayerNorm(d // 4, **factory)
        self.output_upscaling_3 = nn.ConvTranspose2d(d // 4, d // 8, 2, 2, **factory)
        # high-res skip projections, applied in Sam2Model.forward_image
        self.conv_s0 = nn.Conv2d(d, d // 8, 1, **factory)
        self.conv_s1 = nn.Conv2d(d, d // 4, 1, **factory)
        for i in range(self.num_mask_tokens):
            setattr(self, f"output_hypernetworks_mlps_{i}",
                    MLP(d, d, d // 8, 3, **factory))
        self.iou_prediction_head = MLP(
            d, 256, self.num_mask_tokens, 3,
            sigmoid_output=cfg.iou_prediction_use_sigmoid, **factory,
        )
        self.pred_obj_score_head = MLP(d, d, 1, 3, **factory)

    @staticmethod
    def _nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.iou_token.weight.dtype

    def predict(self, image_embeddings, image_pe, sparse_prompt, dense_prompt,
                high_res_features):
        dt = self.dtype
        image_embeddings, sparse_prompt, dense_prompt = (
            t.to(dt) for t in (image_embeddings, sparse_prompt, dense_prompt))
        high_res_features = [t.to(dt) for t in high_res_features]
        b = sparse_prompt.shape[0]
        output_tokens = torch.cat([
            self.obj_score_token.weight, self.iou_token.weight,
            self.mask_tokens.weight,
        ], dim=0)
        tokens = torch.cat([
            output_tokens[None].expand(b, *output_tokens.shape).to(sparse_prompt.dtype),
            sparse_prompt,
        ], dim=1)
        src = image_embeddings + dense_prompt
        pos = image_pe[None].expand(src.shape).to(src.dtype)
        hs, keys = self.transformer(src, pos, tokens)
        iou_token_out = hs[:, 1]
        mask_tokens_out = hs[:, 2:2 + self.num_mask_tokens]

        h, w = src.shape[1:3]
        src_img = keys.reshape(b, h, w, -1)
        feat_s0, feat_s1 = high_res_features
        up = self._nhwc(self.output_upscaling_0, src_img) + feat_s1
        up = F.gelu(self.output_upscaling_1(up))
        up = F.gelu(self._nhwc(self.output_upscaling_3, up) + feat_s0)
        hyper = torch.stack([
            getattr(self, f"output_hypernetworks_mlps_{i}")(mask_tokens_out[:, i])
            for i in range(self.num_mask_tokens)
        ], dim=1)  # (B, M, C/8)
        masks = torch.einsum("bmc,bhwc->bmhw", hyper.float(), up.float())
        iou_pred = self.iou_prediction_head(iou_token_out)
        object_score_logits = self.pred_obj_score_head(hs[:, 0])
        return masks, iou_pred, mask_tokens_out, object_score_logits

    def _stability_scores(self, mask_logits):
        """IoU of the mask thresholded at +delta and at -delta (1 where the
        union is empty)."""
        flat = mask_logits.flatten(-2)
        delta = self.cfg.dynamic_multimask_stability_delta
        area_i = (flat > delta).sum(-1).float()
        area_u = (flat > -delta).sum(-1).float()
        return torch.where(area_u > 0, area_i / area_u.clamp(min=1), torch.ones_like(area_u))

    def dynamic_single_mask(self, all_masks, all_iou):
        """The single-mask output: the first mask where it is stable enough,
        else the best-IoU one of the multimask outputs."""
        multi, multi_iou = all_masks[:, 1:], all_iou[:, 1:]
        best = multi_iou.argmax(dim=-1)
        bidx = torch.arange(all_masks.shape[0], device=all_masks.device)
        best_masks, best_iou = multi[bidx, best][:, None], multi_iou[bidx, best][:, None]
        single, single_iou = all_masks[:, :1], all_iou[:, :1]
        stable = (self._stability_scores(single)
                  >= self.cfg.dynamic_multimask_stability_thresh)
        masks = torch.where(stable[..., None, None], single, best_masks)
        return masks, torch.where(stable, single_iou, best_iou)

    def forward(self, image_embeddings, image_pe, sparse_prompt, dense_prompt,
                high_res_features, multimask_output: bool, training: bool = False):
        """Masks, IoU predictions, the mask tokens for the object pointer and
        the object-score logits. With one mask out, the dynamic selection by
        stability (`dynamic_multimask_via_stability`) applies outside
        training; in training, or without it, the first mask is taken."""
        masks, iou_pred, mask_tokens_out, object_score_logits = self.predict(
            image_embeddings, image_pe, sparse_prompt, dense_prompt,
            high_res_features,
        )
        if multimask_output:
            out_masks, out_iou = masks[:, 1:], iou_pred[:, 1:]
        elif self.cfg.dynamic_multimask_via_stability and not training:
            out_masks, out_iou = self.dynamic_single_mask(masks, iou_pred)
        else:
            out_masks, out_iou = masks[:, 0:1], iou_pred[:, 0:1]
        tokens = (mask_tokens_out[:, 1:]
                  if multimask_output and self.cfg.use_multimask_token_for_obj_ptr
                  else mask_tokens_out[:, 0:1])
        return out_masks, out_iou, tokens, object_score_logits

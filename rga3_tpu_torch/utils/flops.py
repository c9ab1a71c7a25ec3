"""Analytic model-FLOP counters for MFU reporting, counterpart of
`rga3_tpu/utils/flops.py` on the port's own config classes.

PyTorch has no compiled cost model to ask, and the hand-written kernels'
work would be invisible to one, so these counters walk the model configs
with the standard conventions: a matmul m x k x n is 2mkn FLOPs; attention
scores + values are 4 Lq Lk D; the backward is 2x the forward for
weight-bearing matmuls when the weights are trainable, 1x extra
(activation gradients) when they are frozen. The counts equal the JAX
package's for every config (`tests/test_torch_flops.py`).
"""
from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # annotations only
    from ..models.qwen25vl.config import QwenTextConfig, QwenVisionConfig
    from ..models.sam2.config import HieraConfig, Sam2Config
    from ..models.unigr.model import UniGRConfig


def dense(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def attention(lq: int, lk: int, d: int) -> float:
    """Score (lq·lk·d) + value (lq·lk·d) matmuls, 2 FLOPs per MAC."""
    return 4.0 * lq * lk * d


def conv2d(h: int, w: int, kh: int, kw: int, cin: int, cout: int) -> float:
    """Output-pixel count × kernel MACs × 2 (h, w are OUTPUT dims)."""
    return 2.0 * h * w * kh * kw * cin * cout


# ---------------------------------------------------------------------------
# SAM2
# ---------------------------------------------------------------------------

def hiera_flops(hcfg: "HieraConfig", image_size: int) -> float:
    """One frame through the Hiera trunk (patch embed + all blocks),
    following the stage loop of `models/sam2/hiera.py`."""
    s = image_size // hcfg.patch_stride  # tokens per side after embed
    total = conv2d(s, s, hcfg.patch_kernel, hcfg.patch_kernel,
                   3, hcfg.embed_dim)

    stage_ends = hcfg.stage_ends
    q_pool_blocks = set(hcfg.q_pool_blocks)
    dim = hcfg.embed_dim
    cur_stage = 1
    for i in range(hcfg.depth):
        dim_out = dim
        window = hcfg.window_spec[cur_stage - 1]
        if i in hcfg.global_att_blocks:
            window = 0
        if i - 1 in stage_ends:
            dim_out = int(dim * hcfg.dim_mul)
            cur_stage += 1
        tokens_in = s * s
        if i in q_pool_blocks:
            s = s // hcfg.q_stride[0]
        tokens_out = s * s

        total += dense(tokens_in, dim, 3 * dim_out)          # qkv
        if dim != dim_out:
            total += dense(tokens_in, dim, dim_out)          # proj shortcut
        lk = window * window if window else tokens_in
        lq = lk * tokens_out // tokens_in if window else tokens_out
        n_groups = tokens_in // lk
        total += n_groups * attention(lq, lk, dim_out)
        total += dense(tokens_out, dim_out, dim_out)         # attn proj
        hidden = int(dim_out * hcfg.mlp_ratio)
        total += dense(tokens_out, dim_out, hidden)          # mlp in
        total += dense(tokens_out, hidden, dim_out)          # mlp out
        dim = dim_out
    return total


def sam2_neck_flops(cfg: "Sam2Config", image_size: int) -> float:
    """FPN lateral 1x1 convs over every trunk level (`neck.py`)."""
    total = 0.0
    s = image_size // cfg.hiera.patch_stride
    for ch in reversed(cfg.hiera.channel_list):  # high res -> low res
        total += dense(s * s, ch, cfg.d_model)
        s //= 2
    return total


def sam2_heads_flops(cfg: "Sam2Config", image_size: int) -> float:
    """Prompt encoder + two-way mask decoder + upscaling for ONE frame/
    object (`mask_decoder.py`). Token counts: ~8 sparse+output tokens vs 64²
    image tokens — image-side projections dominate."""
    d = cfg.d_model
    s = image_size // cfg.backbone_stride
    ltok = s * s
    ntok = 8  # iou + obj + 4 mask tokens + ~2 prompt tokens
    total = 0.0
    for _ in range(cfg.twoway_depth):
        # token self-attn + token->image + image->token cross attns
        total += 3 * (dense(ntok, d, 3 * d) + dense(ntok, d, d))
        total += dense(ltok, d, 3 * d) + dense(ltok, d, d)
        total += 2 * attention(ntok, ltok, d) + attention(ntok, ntok, d)
        total += dense(ntok, d, cfg.twoway_mlp_dim)
        total += dense(ntok, cfg.twoway_mlp_dim, d)
        # image-side LN/residuals are elementwise (uncounted)
    # final image->token attention
    total += dense(ltok, d, 3 * d) + attention(ntok, ltok, d)
    # output upscaling: two stride-2 transposed convs 64->128->256
    total += conv2d(2 * s, 2 * s, 2, 2, d, d // 4)
    total += conv2d(4 * s, 4 * s, 2, 2, d // 4, d // 8)
    # hypernetwork mask product over the upscaled embedding
    total += dense(16 * ltok, d // 8, cfg.num_multimask_outputs + 1)
    return total


def sam2_memory_attention_flops(cfg: "Sam2Config", lk: int) -> float:
    """One frame/object through the 4-layer memory attention
    (`memory.py`); lk = memory bank length in tokens."""
    d = cfg.d_model
    lq = (cfg.image_size // cfg.backbone_stride) ** 2
    total = 0.0
    for _ in range(cfg.mem_attn_layers):
        # self attention
        total += dense(lq, d, 3 * d) + dense(lq, d, d)
        total += attention(lq, lq, d)
        # cross attention (kv projected from mem_dim)
        total += dense(lq, d, d) + 2 * dense(lk, cfg.mem_dim, d)
        total += dense(lq, d, d)
        total += attention(lq, lk, d)
        # FFN
        total += dense(lq, d, cfg.mem_attn_dim_feedforward)
        total += dense(lq, cfg.mem_attn_dim_feedforward, d)
    return total


def sam2_memory_encoder_flops(cfg: "Sam2Config", image_size: int) -> float:
    """Mask downsampler (4 conv stages over the 1024² mask) + pix-feat
    projection + 2 ConvNeXt fuser blocks (`memory.py`)."""
    total = 0.0
    h = image_size
    cin = 1
    for _ in range(4):
        cout = cin * 4
        h //= 2
        total += conv2d(h, h, 3, 3, cin, cout)
        cin = cout
    total += dense(h * h, cin, cfg.d_model)       # downsampler 1x1
    total += dense(h * h, cfg.d_model, cfg.d_model)  # pix_feat_proj
    for _ in range(2):  # CXBlock fuser: dw 7x7 + 2 pointwise
        total += conv2d(h, h, 7, 7, 1, cfg.d_model)
        total += dense(h * h, cfg.d_model, 4 * cfg.d_model)
        total += dense(h * h, 4 * cfg.d_model, cfg.d_model)
    total += dense(h * h, cfg.d_model, cfg.mem_dim)  # out_proj
    return total


def sam2_memory_bank_tokens(cfg: "Sam2Config") -> int:
    s = cfg.image_size // cfg.backbone_stride
    # each obj ptr (d_model wide) splits into d_model/mem_dim tokens
    ptr_tokens = cfg.max_obj_ptrs_in_encoder * (cfg.d_model // cfg.mem_dim)
    return cfg.num_maskmem * s * s + ptr_tokens


def sam2_track_step_flops(cfg: "Sam2Config") -> float:
    """One tracked frame for one object: trunk + neck + memory attention
    + heads + new-memory encoding (`models/sam2/video.py`)."""
    return (
        hiera_flops(cfg.hiera, cfg.image_size)
        + sam2_neck_flops(cfg, cfg.image_size)
        + sam2_memory_attention_flops(cfg, sam2_memory_bank_tokens(cfg))
        + sam2_heads_flops(cfg, cfg.image_size)
        + sam2_memory_encoder_flops(cfg, cfg.image_size)
    )


def sam2_decode_frame_flops(cfg: "Sam2Config") -> float:
    """One frame of batched no-memory language decoding (the UniGR eval
    hot path, `Sam2Model.decode_frames_with_language`)."""
    return (
        hiera_flops(cfg.hiera, cfg.image_size)
        + sam2_neck_flops(cfg, cfg.image_size)
        + sam2_heads_flops(cfg, cfg.image_size)
    )


# ---------------------------------------------------------------------------
# Qwen2.5-VL
# ---------------------------------------------------------------------------

def qwen_lm_flops(
    tcfg: "QwenTextConfig",
    tokens: int,
    kv_len: int | None = None,
    lm_head: bool = True,
) -> float:
    """Forward pass over `tokens` query positions attending to `kv_len`
    keys (defaults to `tokens`; pass cache length for decode steps).
    Causal prefill attention is counted at the causal half of the Lq·Lk
    rectangle (the PaLM convention), not at the blocks a kernel computes."""
    lk = kv_len if kv_len is not None else tokens
    d = tcfg.hidden_size
    h = tcfg.num_attention_heads
    hd = tcfg.head_dim
    kvh = tcfg.num_key_value_heads
    total = 0.0
    per_layer = (
        dense(tokens, d, h * hd)            # q
        + 2 * dense(tokens, d, kvh * hd)    # k,v (new positions only)
        + dense(tokens, h * hd, d)          # o
        + dense(tokens, d, tcfg.intermediate_size) * 3  # gate/up/down
    )
    causal_factor = 0.5 if kv_len is None else 1.0
    per_layer += causal_factor * attention(tokens, lk, h * hd)
    total += tcfg.num_hidden_layers * per_layer
    if lm_head:
        total += dense(tokens, d, tcfg.vocab_size)
    return total


def qwen_vision_flops(vcfg: "QwenVisionConfig", n_patches: int) -> float:
    """Vision tower forward over n_patches pre-merge patches. Window
    attention (112px = 8x8 merged cells = 64-patch windows) for all but
    the 4 full-attention blocks."""
    d = vcfg.hidden_size
    total = dense(
        n_patches,
        vcfg.in_channels * vcfg.temporal_patch_size * vcfg.patch_size ** 2,
        d,
    )
    win_tokens = (vcfg.window_size // vcfg.patch_size) ** 2
    for i in range(vcfg.depth):
        total += dense(n_patches, d, 3 * d) + dense(n_patches, d, d)
        lk = n_patches if i in vcfg.fullatt_block_indexes else win_tokens
        groups = 1 if i in vcfg.fullatt_block_indexes else max(
            1, n_patches // win_tokens
        )
        lq = n_patches if i in vcfg.fullatt_block_indexes else win_tokens
        total += groups * attention(lq, lk, d)
        total += 2 * dense(n_patches, d, vcfg.intermediate_size)  # gate,up
        total += dense(n_patches, vcfg.intermediate_size, d)      # down
    merged = n_patches // (vcfg.spatial_merge_size ** 2)
    merge_in = d * vcfg.spatial_merge_size ** 2
    total += dense(merged, merge_in, merge_in)
    total += dense(merged, merge_in, vcfg.out_hidden_size)
    return total


# ---------------------------------------------------------------------------
# UniGR composite train step
# ---------------------------------------------------------------------------

def unigr_train_step_flops(
    cfg: "UniGRConfig",
    batch: int,
    seq: int,
    sam_frames: int,
    vision_patches: int = 0,
    tensor: int = 1,
) -> float:
    """One optimizer step (fwd + bwd) of UniGR.train_forward; over a
    tensor axis of `tensor` ranks, one rank's share: the LM's FLOPs divided
    among them (its heads, MLP columns and vocabulary are split), the
    vision tower and SAM2 whole on every rank.

    Backward accounting:
    - LLM: frozen base + LoRA → forward (2NT) + activation-grad pass
      (2NT) + LoRA/embed/lm_head weight grads (small, folded into the
      2x) → 2x forward.
    - Qwen visual tower: frozen and nothing trainable sits inside it, so
      autograd runs no backward through it → forward only.
    - SAM trunk+neck: frozen under `freeze_sam_backbone` (run without
      grad) → forward only.
    - Mask decoder / text_hidden_fcs / memory-free heads: trainable →
      3x forward.
    """
    lm_fwd = qwen_lm_flops(cfg.qwen.text, batch * seq)
    vis_fwd = (
        qwen_vision_flops(cfg.qwen.vision, vision_patches)
        if vision_patches
        else 0.0
    )
    frames = batch * sam_frames
    trunk_fwd = frames * (
        hiera_flops(cfg.sam2.hiera, cfg.sam2.image_size)
        + sam2_neck_flops(cfg.sam2, cfg.sam2.image_size)
    )
    heads_fwd = frames * sam2_heads_flops(cfg.sam2, cfg.sam2.image_size)
    freeze = cfg.seg.freeze_sam_backbone
    trunk_mult = 1.0 if freeze else 3.0
    return (
        2.0 * lm_fwd / tensor
        + vis_fwd
        + trunk_mult * trunk_fwd
        + 3.0 * heads_fwd
    )

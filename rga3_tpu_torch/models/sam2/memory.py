"""SAM2 memory system, counterpart of `rga3_tpu/models/sam2/memory.py`:
memory attention (self- and cross-attention with 2D axial RoPE) and the
memory encoder (mask downsampler + ConvNeXt fuser), NHWC.

The memory bank arrives as one static tensor (cond frame, six earlier
frames, then the object-pointer tokens) with a key-validity mask; the
pointer tokens take no RoPE (`num_k_exclude_rope`). Attention over 1024 or
more keys on the card runs the flash kernel at head dim 256 with the
validity as kv segment ids (`memory_flash_attention`); elsewhere, and under
`plain_attention`, it runs the dense branch of the JAX package (f32 logits,
-1e30 for invalid keys). The convolutions and products are plain
`torch.nn.functional` calls, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.attention import flash_attention
from ...ops.rope import apply_rotary_interleaved, axial_cos_sin
from .config import Sam2Config
from .layers import ChannelLayerNorm, LayerNorm, sine_position_encoding
from .neck import conv1x1

MIN_FLASH_KEYS = 1024  # the JAX package's threshold for the flash branch


def memory_flash_attention(qh, kh, vh, k_valid: Optional[torch.Tensor], scale: float):
    """The flash branch: (B, L, H, D) attention with q segment ids all 1 and
    kv segment ids = `k_valid` (all 1 without it). A row with no valid key
    gives zeros from the kernel and mean(V) from the plain version on the
    CPU (`mha_reference`); the tracker keeps the cond-frame slot valid, so
    it never makes one."""
    b, lq, lk = qh.shape[0], qh.shape[1], kh.shape[1]
    q_seg = torch.ones(b, lq, dtype=torch.int32, device=qh.device)
    kv_seg = (k_valid.to(torch.int32) if k_valid is not None
              else torch.ones(b, lk, dtype=torch.int32, device=qh.device))
    return flash_attention(qh, kh, vh, segment_ids=q_seg, kv_segment_ids=kv_seg, scale=scale)


def memory_dense_attention(qh, kh, vh, k_valid: Optional[torch.Tensor]):
    """The dense branch: f32 logits over sqrt(D), -1e30 on invalid keys,
    softmax, the output in q's dtype (a row with no valid key gives mean(V))."""
    logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) / math.sqrt(qh.shape[-1])
    if k_valid is not None:
        logits = logits.masked_fill(~k_valid[:, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vh.float()).to(qh.dtype)


class RoPEAttention(nn.Module):
    """Attention (one head by default) with axial RoPE on q and on the first
    Lk - num_k_exclude_rope keys; `rope_k_repeat`: those keys are R repeats
    of the query grid (the memory frames), the table tiled R times."""

    def __init__(self, cfg: Sam2Config, kv_in_dim: Optional[int] = None,
                 rope_k_repeat: bool = False, num_heads: int = 1, **factory):
        super().__init__()
        d = cfg.d_model
        kv = kv_in_dim if kv_in_dim is not None else d
        self.cfg = cfg
        self.rope_k_repeat = rope_k_repeat
        self.num_heads = num_heads
        self.plain_attention = False
        self.q_proj = nn.Linear(d, d, **factory)
        self.k_proj = nn.Linear(kv, d, **factory)
        self.v_proj = nn.Linear(kv, d, **factory)
        self.out_proj = nn.Linear(d, d, **factory)

    def forward(self, q, k, v, num_k_exclude_rope: int = 0,
                k_valid: Optional[torch.Tensor] = None):
        d = self.cfg.d_model
        q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        b, lq, _ = q.shape
        lk, h = k.shape[1], self.num_heads
        hd = d // h
        qh, kh, vh = (t.reshape(b, t.shape[1], h, hd) for t in (q, k, v))
        side = math.isqrt(lq)
        assert side * side == lq, "RoPEAttention expects square token grids"
        cos, sin = axial_cos_sin(side, side, hd, self.cfg.mem_attn_rope_theta, device=q.device)
        qh = apply_rotary_interleaved(qh, cos[:, None], sin[:, None])
        num_k_rope = lk - num_k_exclude_rope
        if num_k_rope > 0:
            if self.rope_k_repeat and num_k_rope != lq:
                r = num_k_rope // lq
                cos, sin = cos.repeat(r, 1), sin.repeat(r, 1)
            k_rope = apply_rotary_interleaved(kh[:, :num_k_rope], cos[:, None], sin[:, None])
            kh = torch.cat([k_rope, kh[:, num_k_rope:]], dim=1)
        if lk >= MIN_FLASH_KEYS and q.device.type == "cuda" and not self.plain_attention:
            out = memory_flash_attention(qh, kh, vh, k_valid, 1.0 / math.sqrt(hd))
        else:
            out = memory_dense_attention(qh, kh, vh, k_valid)
        return self.out_proj(out.reshape(b, lq, d))


class MemoryAttentionLayer(nn.Module):
    def __init__(self, cfg: Sam2Config, **factory):
        super().__init__()
        d = cfg.d_model
        self.norm1 = LayerNorm(d, **factory)
        self.self_attn = RoPEAttention(cfg, **factory)
        self.norm2 = LayerNorm(d, **factory)
        self.cross_attn_image = RoPEAttention(cfg, kv_in_dim=cfg.mem_dim, rope_k_repeat=True,
                                              **factory)
        self.norm3 = LayerNorm(d, **factory)
        self.linear1 = nn.Linear(d, cfg.mem_attn_dim_feedforward, **factory)
        self.linear2 = nn.Linear(cfg.mem_attn_dim_feedforward, d, **factory)

    def forward(self, tgt, memory, pos, query_pos, num_k_exclude_rope: int = 0,
                k_valid: Optional[torch.Tensor] = None):
        t2 = self.norm1(tgt)
        tgt = tgt + self.self_attn(t2, t2, t2)  # no positional encoding at the self-attention
        t2 = self.norm2(tgt)
        tgt = tgt + self.cross_attn_image(t2, memory + pos, memory,
                                          num_k_exclude_rope=num_k_exclude_rope, k_valid=k_valid)
        t2 = self.linear2(F.relu(self.linear1(self.norm3(tgt))))
        return tgt + t2


class MemoryAttention(nn.Module):
    def __init__(self, cfg: Sam2Config, **factory):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.mem_attn_layers):
            setattr(self, f"layers_{i}", MemoryAttentionLayer(cfg, **factory))
        self.norm = LayerNorm(cfg.d_model, **factory)

    def forward(self, curr, curr_pos, memory, memory_pos, num_obj_ptr_tokens: int = 0,
                k_valid: Optional[torch.Tensor] = None):
        """curr, curr_pos (B, Lq, C); memory, memory_pos (B, Lk, mem_dim);
        k_valid (B, Lk) bool."""
        out = curr + 0.1 * curr_pos
        for i in range(self.cfg.mem_attn_layers):
            out = getattr(self, f"layers_{i}")(
                out, memory, memory_pos, curr_pos,
                num_k_exclude_rope=num_obj_ptr_tokens, k_valid=k_valid)
        return self.norm(out)


@functools.lru_cache(maxsize=8)
def _memory_pos(h: int, w: int, dim: int, device: torch.device, dtype: torch.dtype):
    """The memory features' sine positional encoding, made on the host
    once per shape and device: a copy to the card synchronizes the host,
    which the tracker's frame loop otherwise never does."""
    return sine_position_encoding(h, w, dim).to(device, dtype)


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`conv` on an NHWC tensor (computed channels-last), NHWC out."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class MaskDownSampler(nn.Module):
    """Four conv(3x3, stride 2, pad 1) + channel LayerNorm + exact GELU
    stages (channels x4 each), then a 1x1 conv to d_model: a 16s x 16s mask
    to s x s."""

    NUM_LAYERS = 4

    def __init__(self, cfg: Sam2Config, **factory):
        super().__init__()
        chans = 1
        for i in range(self.NUM_LAYERS):
            setattr(self, f"encoder_{3 * i}",
                    nn.Conv2d(chans, 4 * chans, 3, stride=2, padding=1, **factory))
            chans *= 4
            setattr(self, f"encoder_{3 * i + 1}", ChannelLayerNorm(chans, **factory))
        self.encoder_12 = nn.Conv2d(chans, cfg.d_model, 1, **factory)

    def forward(self, x):  # (B, H, W, 1)
        for i in range(self.NUM_LAYERS):
            x = _conv_nhwc(getattr(self, f"encoder_{3 * i}"), x)
            x = F.gelu(getattr(self, f"encoder_{3 * i + 1}")(x), approximate="none")
        return conv1x1(self.encoder_12, x)


class CXBlock(nn.Module):
    """ConvNeXt block: depthwise 7x7, channel LayerNorm, MLP (exact GELU),
    layer scale `g_weight`, residual."""

    def __init__(self, dim: int, **factory):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim, **factory)
        self.norm = ChannelLayerNorm(dim, **factory)
        self.pwconv1 = nn.Linear(dim, 4 * dim, **factory)
        self.pwconv2 = nn.Linear(4 * dim, dim, **factory)
        self.g_weight = nn.Parameter(torch.full((dim,), 1e-6, **factory))

    def forward(self, x):
        y = self.norm(_conv_nhwc(self.dwconv, x))
        y = self.pwconv2(F.gelu(self.pwconv1(y), approximate="none"))
        return x + self.g_weight * y


class MemoryEncoder(nn.Module):
    """Pixel features + a downsampled mask -> memory features (B, s, s,
    mem_dim) and their sine positional encoding (s, s, mem_dim). The mask
    is cast to the weights' dtype (bf16 on the card, where flax would
    promote the f32 mask's path to f32)."""

    def __init__(self, cfg: Sam2Config, **factory):
        super().__init__()
        self.cfg = cfg
        self.mask_downsampler = MaskDownSampler(cfg, **factory)
        self.pix_feat_proj = nn.Conv2d(cfg.d_model, cfg.d_model, 1, **factory)
        for i in range(2):
            setattr(self, f"fuser_layers_{i}", CXBlock(cfg.d_model, **factory))
        self.out_proj = nn.Conv2d(cfg.d_model, cfg.mem_dim, 1, **factory)

    def forward(self, pix_feat, masks, skip_mask_sigmoid: bool = False):
        if not skip_mask_sigmoid:
            masks = torch.sigmoid(masks)
        masks = self.mask_downsampler(masks.to(self.pix_feat_proj.weight.dtype))
        x = conv1x1(self.pix_feat_proj, pix_feat) + masks
        for i in range(2):
            x = getattr(self, f"fuser_layers_{i}")(x)
        x = conv1x1(self.out_proj, x)
        h, w = x.shape[1:3]
        return x, _memory_pos(h, w, self.cfg.mem_dim, x.device, x.dtype)

"""SAM-v1's ViT image encoder (ViTDet-style, decomposed relative positions),
NHWC; counterpart of `rga3_tpu/models/sam1/vit.py`.

A patch embedding, an absolute position embedding, `depth` blocks whose
attention runs in 14 x 14 windows padded to whole tiles, or over the whole
grid in the global blocks, each with MViTv2's decomposed relative-position
bias, then a convolutional neck. The JAX package computes this with XLA
einsums and softmax (no Pallas kernel), so the port computes it with torch
ops: the logits in f32 from operands in the model's dtype, as
`preferred_element_type=f32` does, the softmax in f32, its output rounded
to the values' dtype. The global blocks attend one frame at a time, as the
JAX package's `lax.map` does (16 heads x 4096^2 f32 logits are ~1 GB a
frame).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..sam2.layers import ChannelLayerNorm, LayerNorm
from .config import Sam1Config


def window_partition(x: torch.Tensor, ws: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B * n_win, ws, ws, C), zero padded to whole tiles;
    and the padded (H, W)."""
    b, h, w, c = x.shape
    pad_h, pad_w = (-h) % ws, (-w) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(wins: torch.Tensor, ws: int, pad_hw: Tuple[int, int],
                       hw: Tuple[int, int]) -> torch.Tensor:
    """The inverse of `window_partition`, the padding cropped."""
    hp, wp = pad_hw
    h, w = hw
    b = wins.shape[0] // (hp * wp // ws // ws)
    x = wins.reshape(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


def rel_pos_table(rel_pos: torch.Tensor, size: int) -> torch.Tensor:
    """(2 * size - 1, hd) -> (size, size, hd): the offset table of a square
    grid attending to itself."""
    idx = torch.arange(size, device=rel_pos.device)
    return rel_pos[idx[:, None] - idx[None, :] + size - 1]


def add_decomposed_rel_pos(attn: torch.Tensor, q: torch.Tensor, rel_pos_h: torch.Tensor,
                           rel_pos_w: torch.Tensor, size: int) -> torch.Tensor:
    """MViTv2's decomposed relative-position bias on f32 logits (B, nH,
    size^2, size^2), from the unscaled queries (B, nH, size^2, hd)."""
    rh = rel_pos_table(rel_pos_h, size).float()
    rw = rel_pos_table(rel_pos_w, size).float()
    b, nh = q.shape[:2]
    rq = q.reshape(b, nh, size, size, -1).float()
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", rq, rh)
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", rq, rw)
    attn = attn.reshape(b, nh, size, size, size, size)
    attn = attn + rel_h[..., :, None] + rel_w[..., None, :]
    return attn.reshape(b, nh, size * size, size * size)


class Sam1Attention(nn.Module):
    """Multi-head attention with the decomposed relative-position bias over
    a square (B, S, S, C) token grid (a window or the whole grid)."""

    def __init__(self, dim: int, num_heads: int, input_size: int, **factory):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim, **factory)
        self.proj = nn.Linear(dim, dim, **factory)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, hd, **factory))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, hd, **factory))

    def _heads(self, q, k, v, s):
        scale = q.shape[-1] ** -0.5
        attn = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
        attn = add_decomposed_rel_pos(attn, q, self.rel_pos_h, self.rel_pos_w, s)
        return torch.matmul(torch.softmax(attn, dim=-1).to(v.dtype), v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _, c = x.shape
        nh = self.num_heads
        qkv = self.qkv(x.reshape(b, s * s, c)).reshape(b, s * s, 3, nh, c // nh)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each (B, nH, L, hd)
        if s * s >= 1024 and b > 1:
            # the global blocks: one frame at a time bounds the f32 logits
            out = torch.cat([self._heads(q[i:i + 1], k[i:i + 1], v[i:i + 1], s)
                             for i in range(b)])
        else:
            out = self._heads(q, k, v, s)
        return self.proj(out.permute(0, 2, 1, 3).reshape(b, s, s, c))


class Sam1Block(nn.Module):
    """A transformer block with windowed (`window_size` > 0) or global
    attention; GELU (erf) MLP."""

    def __init__(self, cfg: Sam1Config, window_size: int, **factory):
        super().__init__()
        d = cfg.embed_dim
        self.window_size = window_size
        self.norm1 = LayerNorm(d, eps=cfg.ln_eps, **factory)
        self.attn = Sam1Attention(d, cfg.num_heads, window_size or cfg.grid_size, **factory)
        self.norm2 = LayerNorm(d, eps=cfg.ln_eps, **factory)
        hidden = int(d * cfg.mlp_ratio)
        self.mlp_lin1 = nn.Linear(d, hidden, **factory)
        self.mlp_lin2 = nn.Linear(hidden, d, **factory)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.norm1(x)
        ws = self.window_size
        if ws > 0:
            h, w = x.shape[1:3]
            x, pad_hw = window_partition(x, ws)
        x = self.attn(x)
        if ws > 0:
            x = window_unpartition(x, ws, pad_hw, (h, w))
        x = shortcut + x
        return x + self.mlp_lin2(F.gelu(self.mlp_lin1(self.norm2(x))))


class ImageEncoderViT(nn.Module):
    """(B, S, S, 3) normalized frames -> (B, S/16, S/16, d_model)."""

    def __init__(self, cfg: Sam1Config, **factory):
        super().__init__()
        self.cfg = cfg
        e, g = cfg.embed_dim, cfg.grid_size
        self.patch_embed_proj = nn.Conv2d(3, e, cfg.patch_size, cfg.patch_size, **factory)
        # NCHW, as the port keeps Hiera's (`convert` maps flax's NHWC)
        self.pos_embed = nn.Parameter(torch.zeros(1, e, g, g, **factory))
        for i in range(cfg.depth):
            ws = 0 if i in cfg.global_attn_indexes else cfg.window_size
            setattr(self, f"blocks_{i}", Sam1Block(cfg, ws, **factory))
        self.neck_0 = nn.Conv2d(e, cfg.d_model, 1, bias=False, **factory)
        self.neck_1 = ChannelLayerNorm(cfg.d_model, **factory)
        self.neck_2 = nn.Conv2d(cfg.d_model, cfg.d_model, 3, padding=1, bias=False, **factory)
        self.neck_3 = ChannelLayerNorm(cfg.d_model, **factory)

    @staticmethod
    def _nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._nhwc(self.patch_embed_proj, x.to(self.pos_embed.dtype))
        x = x + self.pos_embed.permute(0, 2, 3, 1).to(x.dtype)
        for i in range(self.cfg.depth):
            x = getattr(self, f"blocks_{i}")(x)
        x = self.neck_1(self._nhwc(self.neck_0, x))
        return self.neck_3(self._nhwc(self.neck_2, x))

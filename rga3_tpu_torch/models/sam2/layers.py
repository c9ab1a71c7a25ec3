"""Shared SAM2 building blocks (NHWC), counterpart of
`rga3_tpu/models/sam2/layers.py`. Submodule names follow the JAX package's
parameter names so that `convert.py` maps a flax tree onto them one to one.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.attention import flash_attention, mha_reference


def attend(q, k, v, *, plain: bool = False, min_flash_len: int = 1024):
    """(B, L, H, D) attention: the flash kernel for lq >= min_flash_len,
    else (or with `plain`) the plain version. The kernel is bf16: an f32
    caller (the mask decoder trained under f32 masters) attends through
    bf16 copies of q, k and v, and gets the output back in its dtype."""
    if q.shape[1] >= min_flash_len and not plain:
        if q.dtype != torch.bfloat16:
            return flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16()).to(q.dtype)
        return flash_attention(q, k, v)
    return mha_reference(q, k, v)


def layer_norm_f32(x, weight, bias, eps):
    """LayerNorm over the last dim with f32 statistics, output in x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with f32 statistics (eps 1e-5 by default; 1e-6 for the
    channel LayerNorm2d of the reference)."""

    def __init__(self, dim: int, eps: float = 1e-5, **factory):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, **factory))
        self.bias = nn.Parameter(torch.zeros(dim, **factory))

    def forward(self, x):
        return layer_norm_f32(x, self.weight, self.bias, self.eps)


def ChannelLayerNorm(dim: int, **factory) -> LayerNorm:
    return LayerNorm(dim, eps=1e-6, **factory)


class MLP(nn.Module):
    """num_layers-deep MLP with the activation between layers."""

    def __init__(self, input_dim, hidden_dim, output_dim, num_layers,
                 activation="relu", sigmoid_output=False, **factory):
        super().__init__()
        self.num_layers = num_layers
        self.act = {"relu": F.relu, "gelu": F.gelu}[activation]
        self.sigmoid_output = sigmoid_output
        for i in range(num_layers):
            d_in = input_dim if i == 0 else hidden_dim
            d_out = output_dim if i == num_layers - 1 else hidden_dim
            setattr(self, f"layers_{i}", nn.Linear(d_in, d_out, **factory))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x)
            if i < self.num_layers - 1:
                x = self.act(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


class SamAttention(nn.Module):
    """Projection attention with optional internal downsampling."""

    def __init__(self, embedding_dim, num_heads, downsample_rate=1,
                 **factory):
        super().__init__()
        internal = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.plain_attention = False
        self.q_proj = nn.Linear(embedding_dim, internal, **factory)
        self.k_proj = nn.Linear(embedding_dim, internal, **factory)
        self.v_proj = nn.Linear(embedding_dim, internal, **factory)
        self.out_proj = nn.Linear(internal, embedding_dim, **factory)

    def forward(self, q, k, v):
        q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        b, lq, internal = q.shape
        lk, h = k.shape[1], self.num_heads
        out = attend(
            q.reshape(b, lq, h, internal // h),
            k.reshape(b, lk, h, internal // h),
            v.reshape(b, lk, h, internal // h),
            plain=self.plain_attention,
        )
        return self.out_proj(out.reshape(b, lq, internal))


def sine_position_encoding(h, w, num_pos_feats, temperature=10000.0):
    """PositionEmbeddingSine (normalize=True, scale=2*pi) as an
    (H, W, num_pos_feats) f32 tensor, [y | x] order."""
    half = num_pos_feats // 2
    scale, eps = 2 * math.pi, 1e-6
    y = np.arange(1, h + 1, dtype=np.float32)[:, None].repeat(w, 1)
    x = np.arange(1, w + 1, dtype=np.float32)[None, :].repeat(h, 0)
    y = y / (y[-1:, :] + eps) * scale
    x = x / (x[:, -1:] + eps) * scale
    dim_t = np.arange(half, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / half)
    pos_x = x[:, :, None] / dim_t
    pos_y = y[:, :, None] / dim_t
    pos_x = np.stack(
        [np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])], axis=3
    ).reshape(h, w, -1)
    pos_y = np.stack(
        [np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])], axis=3
    ).reshape(h, w, -1)
    return torch.from_numpy(np.concatenate([pos_y, pos_x], axis=-1))


class PositionEmbeddingRandom(nn.Module):
    """Gaussian random-frequency positional encoding."""

    def __init__(self, num_pos_feats=128, **factory):
        super().__init__()
        self.positional_encoding_gaussian_matrix = nn.Parameter(
            torch.randn(2, num_pos_feats, **factory)
        )

    def forward(self, coords):
        """coords in [0, 1], (..., 2) -> (..., 2 * num_pos_feats) f32."""
        c = 2 * coords.float() - 1
        c = 2 * math.pi * (c @ self.positional_encoding_gaussian_matrix.float())
        return torch.cat([c.sin(), c.cos()], dim=-1)

    def grid_pe(self, h, w):
        """(H, W, C) encoding at pixel centres."""
        dev = self.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        grid = torch.stack(
            [xs[None, :].expand(h, w), ys[:, None].expand(h, w)], dim=-1
        )
        return self(grid)

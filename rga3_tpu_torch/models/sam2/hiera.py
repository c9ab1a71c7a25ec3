"""Hiera hierarchical windowed ViT trunk (NHWC), counterpart of
`rga3_tpu/models/sam2/hiera.py`.

The block dispatch mirrors the JAX module's. With the fused switches on (the
default config) a windowed block of width <= `fused_block_max_dim` runs
`fused_window_block`, a wider one `fused_window_block_split`, a global block
`fused_global_block` and a q-pool stage-entry block `fused_transition_block`
(`ops/fused_block.py`, the ports of the Pallas fused-block kernels). With
them off, the unfused path runs: windowed blocks through `window_attention`
over window-major tokens, global and q-pool blocks through `attend` (the
flash kernel from 1024 query tokens). Both routes read the same submodules,
so one state_dict loads into either.
"""
from __future__ import annotations

import functools
import math
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import fused_block as fb
from ...ops.attention import window_attention, window_reference
from ...ops.resize import resize_bicubic_torch
from .config import HieraConfig
from .layers import LayerNorm, attend


def window_partition(x: torch.Tensor, ws: int):
    """(B, H, W, C) -> (B*nW, ws, ws, C), zero-padded to whole windows."""
    b, h, w, c = x.shape
    pad_h, pad_w = (-h) % ws, (-w) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)
    return x, (hp, wp)


def window_unpartition(windows, ws: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // ((hp // ws) * (wp // ws))
    x = windows.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def _max_pool(x: torch.Tensor, stride: Tuple[int, int]) -> torch.Tensor:
    """MaxPool2d(kernel=stride, stride=stride) on NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=stride, stride=stride)
    return y.permute(0, 2, 3, 1)


class MultiScaleBlock(nn.Module):
    def __init__(self, cfg: HieraConfig, dim: int, dim_out: int,
                 num_heads: int, window_size: int, do_q_pool: bool,
                 **factory):
        super().__init__()
        self.cfg = cfg
        self.dim, self.dim_out = dim, dim_out
        self.num_heads = num_heads
        self.window_size = window_size  # 0 = global attention
        self.do_q_pool = do_q_pool
        self.plain_attention = False
        hidden = int(dim_out * cfg.mlp_ratio)
        self.norm1 = LayerNorm(dim, eps=1e-6, **factory)
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out, **factory)
        self.attn_qkv = nn.Linear(dim, 3 * dim_out, **factory)
        self.attn_proj = nn.Linear(dim_out, dim_out, **factory)
        self.norm2 = LayerNorm(dim_out, eps=1e-6, **factory)
        self.mlp_layers_0 = nn.Linear(dim_out, hidden, **factory)
        self.mlp_layers_1 = nn.Linear(hidden, dim_out, **factory)

    def _block_params(self) -> dict:
        """The fused kernels' params dict, from the unfused path's modules."""
        p = {
            "ln1_g": self.norm1.weight, "ln1_b": self.norm1.bias,
            "wqkv": self.attn_qkv.weight, "bqkv": self.attn_qkv.bias,
            "ln2_g": self.norm2.weight, "ln2_b": self.norm2.bias,
            "w1": self.mlp_layers_0.weight, "b1": self.mlp_layers_0.bias,
            "w2": self.mlp_layers_1.weight, "b2": self.mlp_layers_1.bias,
        }
        if self.dim != self.dim_out:  # the transition: proj is the shortcut
            p.update(wproj=self.proj.weight, bproj=self.proj.bias,
                     wattn=self.attn_proj.weight, battn=self.attn_proj.bias)
        else:
            p.update(wproj=self.attn_proj.weight, bproj=self.attn_proj.bias)
        return p

    def _fused(self, x: torch.Tensor, split: bool = False) -> torch.Tensor:
        ws, d = self.window_size, self.dim_out
        b, h, w = x.shape[:3]
        attn_in, pad_hw = window_partition(x, ws)
        tokens = attn_in.reshape(b, -1, d).contiguous()
        if self.plain_attention:
            fn = functools.partial(fb.reference_block, split=split)
        else:
            fn = fb.fused_window_block_split if split else fb.fused_window_block
        out = fn(tokens, self._block_params(), num_heads=self.num_heads,
                 window=ws * ws, gelu_tanh=self.cfg.gelu_tanh)
        out = out.reshape(-1, ws, ws, d)
        return window_unpartition(out, ws, pad_hw, (h, w))

    def _fused_global(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, d = x.shape
        fn = fb.reference_global_block if self.plain_attention else fb.fused_global_block
        out = fn(x.reshape(b, h * w, d).contiguous(), self._block_params(),
                 num_heads=self.num_heads, gelu_tanh=self.cfg.gelu_tanh)
        return out.reshape(b, h, w, d)

    def _fused_transition(self, x: torch.Tensor) -> torch.Tensor:
        ws = self.window_size
        b, h, w = x.shape[:3]
        attn_in, pad_hw = window_partition(x, ws)
        tokens = attn_in.reshape(b, -1, self.dim).contiguous()
        fn = fb.reference_transition if self.plain_attention else fb.fused_transition_block
        out = fn(tokens, self._block_params(), num_heads=self.num_heads, ws=ws,
                 gelu_tanh=self.cfg.gelu_tanh)
        ws_out = ws // 2
        out = out.reshape(-1, ws_out, ws_out, self.dim_out)
        return window_unpartition(
            out, ws_out, (pad_hw[0] // 2, pad_hw[1] // 2), (h // 2, w // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, ws, heads = self.cfg, self.window_size, self.num_heads
        if not self.do_q_pool and self.dim == self.dim_out and cfg.use_fused_block:
            if self.dim_out <= cfg.fused_block_max_dim:
                return self._fused(x) if ws > 0 else self._fused_global(x)
            if ws > 0 and cfg.use_split_fused_block:
                return self._fused(x, split=True)
        if (self.do_q_pool and self.dim != self.dim_out and ws > 0
                and cfg.use_fused_block and cfg.use_fused_transition
                and tuple(cfg.q_stride) == (2, 2)
                and x.shape[1] % ws == 0 and x.shape[2] % ws == 0):
            return self._fused_transition(x)
        shortcut = x
        normed = self.norm1(x)
        if self.dim != self.dim_out:
            proj = self.proj(normed)
            shortcut = _max_pool(proj, cfg.q_stride) if self.do_q_pool else proj
        b, h, w = x.shape[:3]

        if ws > 0 and not self.do_q_pool and cfg.use_window_kernel:
            # windows stay in the sequence (window-major) for the kernel
            attn_in, pad_hw = window_partition(normed, ws)
            n_tok = attn_in.shape[0] // b * ws * ws
            qkv = self.attn_qkv(attn_in.reshape(b, n_tok, -1))
            qkv = qkv.reshape(b, n_tok, 3, heads, -1)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            if self.plain_attention:
                out = window_reference(
                    q, k, v, ws * ws, 1.0 / math.sqrt(q.shape[-1])
                )
            else:
                out = window_attention(q, k, v, ws * ws)
            out = self.attn_proj(out.reshape(-1, ws, ws, self.dim_out))
            out = window_unpartition(out, ws, pad_hw, (h, w))
        else:
            if ws > 0:
                attn_in, pad_hw = window_partition(normed, ws)
            else:
                attn_in, pad_hw = normed, (h, w)
            b_, ah, aw, _ = attn_in.shape
            qkv = self.attn_qkv(attn_in).reshape(b_, ah * aw, 3, heads, -1)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            if self.do_q_pool:
                hd = q.shape[-1]
                q = _max_pool(q.reshape(b_, ah, aw, heads * hd), cfg.q_stride)
                ah, aw = q.shape[1:3]
                q = q.reshape(b_, ah * aw, heads, hd)
            out = attend(q, k, v, plain=self.plain_attention)
            out = self.attn_proj(out.reshape(b_, ah, aw, -1))
            if self.do_q_pool:
                if ws > 0:
                    ws_out = ws // cfg.q_stride[0]
                    h_out, w_out = shortcut.shape[1:3]
                    pad_hw = (h_out + (-h_out) % ws_out,
                              w_out + (-w_out) % ws_out)
                    out = window_unpartition(out, ws_out, pad_hw, (h_out, w_out))
            elif ws > 0:
                out = window_unpartition(out, ws, pad_hw, (h, w))

        x = shortcut + out
        hidden = self.mlp_layers_0(self.norm2(x))
        hidden = F.gelu(hidden, approximate="tanh" if fb.gelu_variant(cfg.gelu_tanh) else "none")
        return x + self.mlp_layers_1(hidden)


class Hiera(nn.Module):
    """Per-stage feature maps, highest resolution first
    (B, H/4, W/4, 144) ... (B, H/32, W/32, 1152) for Hiera-L."""

    def __init__(self, cfg: HieraConfig, **factory):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dim
        self.patch_embed_proj = nn.Conv2d(
            3, e, cfg.patch_kernel, cfg.patch_stride, cfg.patch_padding,
            **factory,
        )
        ws0 = cfg.window_spec[0]
        self.pos_embed = nn.Parameter(
            torch.zeros(1, e, *cfg.window_pos_embed_bkg_spatial_size, **factory)
        )
        self.pos_embed_window = nn.Parameter(torch.zeros(1, e, ws0, ws0, **factory))
        dim, heads, cur_stage = e, cfg.num_heads, 1
        q_pool_blocks = set(cfg.q_pool_blocks)
        for i in range(cfg.depth):
            dim_out = dim
            # the window size lags one block behind the stage transition
            window_size = cfg.window_spec[cur_stage - 1]
            if i in cfg.global_att_blocks:
                window_size = 0
            if i - 1 in cfg.stage_ends:
                dim_out = int(dim * cfg.dim_mul)
                heads = int(heads * cfg.head_mul)
                cur_stage += 1
            setattr(self, f"blocks_{i}", MultiScaleBlock(
                cfg, dim, dim_out, heads, window_size, i in q_pool_blocks,
                **factory,
            ))
            dim = dim_out

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        cfg = self.cfg
        x = self.patch_embed_proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        h, w = x.shape[1:3]
        ws0 = cfg.window_spec[0]
        pos = resize_bicubic_torch(self.pos_embed.float(), (h, w))
        pos = pos + self.pos_embed_window.float().repeat(1, 1, h // ws0, w // ws0)
        x = x + pos.permute(0, 2, 3, 1).to(x.dtype)
        outputs = []
        for i in range(cfg.depth):
            x = getattr(self, f"blocks_{i}")(x)
            if i in cfg.stage_ends:
                outputs.append(x)
        return outputs

"""CoTrackerLite in PyTorch: the counterpart of `rga3_tpu/models/stom/cotracker.py`.

A trainable point tracker with CoTracker's skeleton: a stride-4
convolutional feature encoder, correlation of each track's query feature
with a 7x7 bilinear stencil around its current estimate at `num_scales`
pyramid levels, and `iterations` refinements by a transformer that
alternates attention over time and over tracks. Submodules keep the flax
names (`encoder.layer2.conv1`, `block_3.attn.query`, `delta_head`, ...), so
the weight bridge (`convert.torch_state_dict_from_flax` /
`flax_tree_from_torch`) maps the JAX package's parameter tree both ways.

Everything runs in f32 as plain torch ops (the reference has no Pallas
kernel here), with flax's conventions made explicit:

  * convolutions pad as flax's "SAME": a 7x7 stride-2 conv on an even size
    pads (2, 3), a 3x3 stride-2 one (0, 1) (`cotracker3.Conv`);
  * GroupNorm and LayerNorm use eps 1e-6 and flax's E[x^2] - E[x]^2;
  * GELU is the tanh form, the pyramid's 2x2 average pool is VALID;
  * attention is flax's `MultiHeadDotProductAttention`: `query` / `key` /
    `value` / `out` projections with biases, the query divided by
    sqrt(head_dim) before the product, the softmax in f32.

Unlike CoTracker3, the refinement does not stop the gradient through the
track estimates: the loss of the last iteration reaches every earlier one.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...device import DeviceLike, resolve_device
from .cotracker3 import Conv, Dense, LayerNorm, _avg_pool2, _gelu_tanh, lecun_normal_


def _bilinear_gather(fmaps: torch.Tensor, frame: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of a stack of maps: fmaps (F, H, W, C), frame (...)
    the map of each point (broadcast against xy's leading axes), xy (..., 2)
    pixel coords of that map, clamped to it -> (..., C)."""
    _, h, w, c = fmaps.shape
    x = xy[..., 0].clamp(0.0, w - 1.0)
    y = xy[..., 1].clamp(0.0, h - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(0, w - 1), (y0 + 1).clamp(0, h - 1)
    flat = fmaps.reshape(-1, c)
    base = frame * h

    def at(yy, xx):
        return flat[(base + yy) * w + xx]

    return (at(y0, x0) * (1 - wx) * (1 - wy) + at(y0, x1) * wx * (1 - wy)
            + at(y1, x0) * (1 - wx) * wy + at(y1, x1) * wx * wy)


def bilinear_sample(fmap: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """fmap (H, W, C); xy (..., 2) in pixel coords of that map -> (..., C)."""
    frame = torch.zeros(xy.shape[:-1], dtype=torch.long, device=fmap.device)
    return _bilinear_gather(fmap[None], frame, xy)


class GroupNorm(nn.Module):
    """flax `nn.GroupNorm` (eps 1e-6) on NCHW: statistics per sample and
    group over the group's channels and the spatial dims, by E[x^2] -
    E[x]^2; scale and bias per channel."""

    flax_kind = "norm"  # the weight bridge's layout (`convert._flax_layout`)

    def __init__(self, channels: int, groups: int = 8, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.groups, self.eps = groups, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        g = x.reshape(n, self.groups, -1)
        mean = g.mean(-1, keepdim=True)
        var = ((g * g).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        shape = (n, c) + (1,) * (x.dim() - 2)

        def per_channel(stat):  # (n, groups, 1) -> (n, c, 1, ...)
            return stat.repeat_interleave(c // self.groups, dim=1).reshape(shape)

        mul = per_channel(torch.rsqrt(var + self.eps)) * self.weight.reshape(shape[1:])
        return (x - per_channel(mean)) * mul + self.bias.reshape(shape[1:])


class ConvBlock(nn.Module):
    def __init__(self, c_in: int, dim: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(c_in, dim, 3, stride, "same")
        self.norm1 = GroupNorm(dim)
        self.conv2 = Conv(dim, dim, 3, 1, "same")
        self.norm2 = GroupNorm(dim)
        self.proj = Conv(c_in, dim, 1, stride, "same") if stride != 1 or c_in != dim else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW -> NCHW."""
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        if self.proj is not None:
            x = self.proj(x)
        return F.relu(x + y)


class FeatureEncoder(nn.Module):
    """Stride-4 convolutional encoder (BasicEncoder lineage), `dim` channels."""

    def __init__(self, dim: int = 128):
        super().__init__()
        self.dim = dim
        self.stem = Conv(3, 64, 7, 2, "same")
        self.stem_norm = GroupNorm(64)
        self.layer1 = ConvBlock(64, 64)
        self.layer2 = ConvBlock(64, 96, stride=2)
        self.layer3 = ConvBlock(96, dim)
        self.out = Conv(dim, dim, 1, 1, "same")

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """(T, H, W, 3) in [0, 1] -> (T, ceil(H/4), ceil(W/4), dim)."""
        x = (frames * 2.0 - 1.0).permute(0, 3, 1, 2)
        x = F.relu(self.stem_norm(self.stem(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.out(x).permute(0, 2, 3, 1)


class HeadDense(Dense):
    """One of flax's `MultiHeadDotProductAttention` DenseGeneral projections,
    held flattened as a Dense: `side` "in" for query / key / value (flax
    kernel (in, heads, head_dim), bias (heads, head_dim)), "out" for the
    output projection (kernel (heads, head_dim, out))."""

    def __init__(self, d_in: int, d_out: int, heads: int, side: str):
        super().__init__(d_in, d_out)
        self.heads = heads
        self.flax_kind = f"heads_{side}"


class MultiHeadAttention(nn.Module):
    """flax `nn.MultiHeadDotProductAttention(num_heads)` self-attention over
    the second-to-last axis, f32."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = HeadDense(dim, dim, heads, "in")
        self.key = HeadDense(dim, dim, heads, "in")
        self.value = HeadDense(dim, dim, heads, "in")
        self.out = HeadDense(dim, dim, heads, "out")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., L, D) -> (..., L, D)."""
        h = self.heads
        hd = x.shape[-1] // h

        def split(t):  # (..., L, D) -> (..., H, L, hd)
            return t.reshape(*t.shape[:-1], h, hd).transpose(-2, -3)

        q = split(self.query(x)) / math.sqrt(hd)
        k, v = split(self.key(x)), split(self.value(x))
        att = torch.softmax(torch.matmul(q, k.transpose(-1, -2)), dim=-1)
        out = torch.matmul(att, v).transpose(-2, -3)
        return self.out(out.reshape(*x.shape[:-1], h * hd))


class UpdateBlock(nn.Module):
    """One transformer block: attention over one axis, then an MLP."""

    def __init__(self, dim: int, heads: int, axis: str):
        super().__init__()
        if axis not in ("time", "track"):
            raise ValueError(f"axis {axis!r}: 'time' or 'track'")
        self.axis = axis
        self.ln1 = LayerNorm(dim, eps=1e-6)
        self.attn = MultiHeadAttention(dim, heads)
        self.ln2 = LayerNorm(dim, eps=1e-6)
        self.fc1 = Dense(dim, 4 * dim)
        self.fc2 = Dense(4 * dim, dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (N, T, D) -> (N, T, D)."""
        x = tokens if self.axis == "time" else tokens.transpose(0, 1)
        x = x + self.attn(self.ln1(x))
        x = x + self.fc2(_gelu_tanh(self.fc1(self.ln2(x))))
        return x if self.axis == "time" else x.transpose(0, 1)


def _offset_grid(radius: int = 3) -> np.ndarray:
    ys, xs = np.mgrid[-radius: radius + 1, -radius: radius + 1]
    return np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)  # (K, 2), x fastest


def _sincos_embed(x: torch.Tensor, dim: int) -> torch.Tensor:
    """(..., 2) displacements -> (..., dim) sin/cos features: per axis,
    dim // 4 frequencies from 1 down to 1/1000, sines then cosines."""
    half = dim // 4
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device)
                      * (-math.log(1000.0) / half))
    ang = x[..., None] * freqs  # (..., 2, half)
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return emb.reshape(*x.shape[:-1], -1)


class CoTrackerLite(nn.Module):
    """Iterative point-tracking transformer.

    forward(frames (T, H, W, 3) f32 in [0, 1], queries (N, 3) (t_query, x,
    y) in pixels) -> (tracks (T, N, 2) xy, visibility logits (T, N))."""

    def __init__(self, dim: int = 256, heads: int = 8, depth: int = 3, num_scales: int = 4,
                 radius: int = 3, iterations: int = 4):
        super().__init__()
        self.dim, self.num_scales, self.iterations = dim, num_scales, iterations
        self.radius = radius
        k = (2 * radius + 1) ** 2
        # the reference builds its encoder at the default 128 channels,
        # whatever `dim` is
        self.encoder = FeatureEncoder()
        self.corr_proj = Dense(num_scales * k, dim)
        self.flow_proj = Dense(dim, dim)
        self.track_proj = Dense(self.encoder.dim, dim)
        self.blocks = [f"block_{i}" for i in range(2 * depth)]
        for i, name in enumerate(self.blocks):
            self.add_module(name, UpdateBlock(dim, heads, "time" if i % 2 == 0 else "track"))
        self.delta_head = Dense(dim, 3)  # (dx, dy, dvis)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's default initialisers: LeCun normal (truncated at two
        standard deviations) for dense and conv kernels (an attention
        projection at its flax fan-in, which the flattened weight keeps),
        zero biases, unit norm scales."""
        for module in self.modules():
            if isinstance(module, (Dense, Conv)):
                lecun_normal_(module.weight, generator)
                module.bias.zero_()
            elif isinstance(module, (GroupNorm, LayerNorm)):
                module.weight.fill_(1.0)
                module.bias.zero_()

    def forward(self, frames: torch.Tensor,
                queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        t, n = frames.shape[0], queries.shape[0]
        dev = frames.device
        fmaps = self.encoder(frames)  # (T, h4, w4, C)
        c = fmaps.shape[-1]
        pyramid = [fmaps]
        for _ in range(self.num_scales - 1):
            pyramid.append(_avg_pool2(pyramid[-1].permute(0, 3, 1, 2)).permute(0, 2, 3, 1))

        queries = queries.to(dev, torch.float32)
        q_t = queries[:, 0].to(torch.int32).long()
        feats_at_q = _bilinear_gather(fmaps, q_t, queries[:, 1:3] / 4.0)  # (N, C)

        offsets = torch.from_numpy(_offset_grid(self.radius)).to(dev)  # (K, 2)
        k = offsets.shape[0]
        frame = torch.arange(t, device=dev)[:, None, None]  # (T, 1, 1)

        def corr_features(positions):
            """positions (T, N, 2) full-resolution xy -> (T, N, scales * K)."""
            out = []
            for si, fm in enumerate(pyramid):
                grid = positions[:, :, None, :] / (4.0 * 2 ** si) + offsets  # (T, N, K, 2)
                sampled = _bilinear_gather(fm, frame, grid)  # (T, N, K, C)
                out.append(torch.einsum("tnkc,nc->tnk", sampled, feats_at_q) / math.sqrt(c))
            return torch.cat(out, dim=-1)

        pos0 = queries[None, :, 1:3].expand(t, n, 2)
        pos, vis = pos0, torch.zeros(t, n, device=dev)
        track_feat = self.track_proj(feats_at_q)[None]
        for _ in range(self.iterations):
            corr = corr_features(pos)
            disp = _sincos_embed((pos - pos0) / 16.0, self.dim)
            tokens = (self.corr_proj(corr) + self.flow_proj(disp) + track_feat).transpose(0, 1)
            for name in self.blocks:
                tokens = getattr(self, name)(tokens)  # (N, T, D)
            delta = self.delta_head(tokens).transpose(0, 1)  # (T, N, 3)
            pos = pos + delta[..., :2]
            vis = vis + delta[..., 2]
        return pos, vis


def tiny_lite() -> CoTrackerLite:
    """The dims of `train_cotracker --tiny` and `bench_stom_synth --tiny`."""
    return CoTrackerLite(dim=64, heads=4, depth=1, num_scales=2, iterations=2)


def save_params(path: str, model: nn.Module) -> None:
    """Flat npz of f32 leaves keyed by the JAX package's `keystr` paths
    (its `save_params` format)."""
    from ...convert import save_keystr_npz

    save_keystr_npz(path, model)


def load_params(path: str, model: nn.Module) -> nn.Module:
    """Load an npz written by `save_params` or `cotracker3.save_cotracker3`
    (either package's; a `__config__` entry is ignored, f16 leaves are read
    as f32) into `model`, every parameter required. Returns the model."""
    from ...convert import load_keystr_npz, torch_state_dict_from_flax

    tree, _ = load_keystr_npz(path)
    sd = torch_state_dict_from_flax(tree)
    dev = next(model.parameters()).device
    model.load_state_dict({k: v.to(dev) for k, v in sd.items()}, strict=True)
    return model


class CoTrackerLitePredictor:
    """STOM tracker backend over CoTrackerLite (the JAX package's
    `CoTrackerJax`): `track_points(frames, pts, query_frame_idx)` and
    `track(frames, query_mask, query_frame_idx, grid_size)` as the LK
    tracker has them. Runs on the card unless `device` names another; the
    model must be on that device."""

    def __init__(self, model: CoTrackerLite, device: DeviceLike = None):
        self.device = resolve_device(device)
        have = next(model.parameters()).device
        if have.type != self.device.type:
            raise ValueError(f"the tracker model is on {have}, not on {self.device}")
        self.model = model

    def track_points(self, frames: Sequence[np.ndarray], pts: np.ndarray, query_frame_idx: int):
        """Track explicit (N, 2) points; returns (tracks (T, N, 2) f32,
        visible (T, N) bool)."""
        t = len(frames)
        if len(pts) == 0:
            return np.zeros((t, 0, 2), np.float32), np.zeros((t, 0), bool)
        video = torch.from_numpy(np.stack(frames).astype(np.float32) / 255.0).to(self.device)
        queries = np.concatenate([np.full((len(pts), 1), query_frame_idx, np.float32),
                                  np.asarray(pts, np.float32)], axis=1)
        with torch.inference_mode():
            tracks, vis = self.model(video, torch.from_numpy(queries).to(self.device))
        return tracks.cpu().numpy(), vis.cpu().numpy() > 0

    def track(self, frames: Sequence[np.ndarray], query_mask: np.ndarray, query_frame_idx: int,
              grid_size: int = 100):
        from .tracker import sample_grid_points_in_mask

        pts = sample_grid_points_in_mask(query_mask, grid_size)
        return self.track_points(frames, pts, query_frame_idx)

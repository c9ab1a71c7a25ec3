"""CoTracker3-offline in PyTorch: the counterpart of
`rga3_tpu/models/stom/cotracker3.py`.

STOM's point tracker: a RAFT-style encoder (stride 4, instance norms), a
correlation pyramid sampled on a (2r+1)^2 stencil around each track, and an
update transformer (time attention per track, space attention through
learned virtual tracks) refining the tracks for `iters` iterations over the
whole clip at once. Submodules keep the flax names (`fnet.layer1_0.conv1`,
`updateformer.time_blocks_0.attn.to_q`, `virual_tracks`, ...), so the JAX
package's weight files load through `convert.load_keystr_npz` and
`convert.torch_state_dict_from_flax`, and `save_cotracker3` writes files
the JAX package reads (`Dense`, `Conv` and `LayerNorm` name their flax
layouts for `convert.flax_tree_from_torch`).

Convolutions run in NCHW, dense layers on (..., C). There is no Pallas
kernel in the reference: every op here is a plain torch op, at the rounding
points of the reference's `compute_dtype`:

  * `Dense` / `Conv` cast input and kernel to the compute dtype, round the
    product to it, then add the bias in it (flax's order; a fused bias would
    round once);
  * `instance_norm` and `_pre_norm` take f32 statistics and cast back;
    `norm_context` is a LayerNorm in f32 (flax's promotion), its statistics
    by flax's E[x^2] - E[x]^2;
  * the attention logits are divided by sqrt(d) in f32 (the reference
    divides by a numpy scalar, which promotes) and the softmax runs in f32;
  * the tanh GELU is `jax.nn.gelu`'s formula op by op, its constants
    rounded to the compute dtype;
  * the correlation accumulates in f32, `stencil_sample` rounds its
    fractional weights to the map's dtype, the pyramid's 2x2 average sums
    its four values in row-major order in the map's dtype;
  * `_resize_bilinear` is `jax.image.resize(..., "bilinear")` (antialiased):
    its weight matrices, cast to the input's dtype, contracted in the order
    `jnp.einsum` picks;
  * the heads run in f32.

`CoTracker3Offline.forward` takes a batch of clips, (B, T, H, W, 3) frames
and (B, N, 3) queries, or one clip without the batch axis; the predictor's
`track_batch` runs B clips in one forward where the reference vmaps. As in
the reference, each refinement iteration starts from the estimates with
their gradient stopped, so training supervises every iteration on its own
update (`tools/train_cotracker.py`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...device import DeviceLike, resolve_device
from ...ops.resize import resize_u8_bilinear_aa


@dataclasses.dataclass(frozen=True)
class CoTracker3Config:
    stride: int = 4
    latent_dim: int = 128            # fnet output channels
    corr_levels: int = 4
    corr_radius: int = 3
    corr_mlp_hidden: int = 384
    corr_mlp_out: int = 256
    hidden_size: int = 384
    num_heads: int = 8
    time_depth: int = 3
    space_depth: int = 3
    num_virtual_tracks: int = 64
    mlp_ratio: float = 4.0
    flow_emb_dim: int = 64           # C of get_2d_embedding
    flow_cat_coords: bool = True     # raw xy appended to the sincos emb
    model_resolution: Tuple[int, int] = (384, 512)
    iters: int = 6
    linear_layer_for_vis_conf: bool = True
    compute_dtype: str = "float32"   # or "bfloat16"; params stay f32

    @property
    def patch_points(self) -> int:
        return (2 * self.corr_radius + 1) ** 2

    @property
    def input_dim(self) -> int:
        # [vis, conf] + corr embeddings + flow sincos embedding (+coords)
        return 2 + self.corr_levels * self.corr_mlp_out + (
            2 * self.flow_emb_dim + (2 if self.flow_cat_coords else 0)
        )

    def replace(self, **kw) -> "CoTracker3Config":
        return dataclasses.replace(self, **kw)


def cotracker3_offline_config() -> CoTracker3Config:
    """The `scaled_offline.pth` dims."""
    return CoTracker3Config()


def tiny_cotracker3_config() -> CoTracker3Config:
    """CPU-testable dims, same structure."""
    return CoTracker3Config(
        latent_dim=32, corr_levels=2, corr_radius=1, corr_mlp_hidden=32,
        corr_mlp_out=24, hidden_size=64, num_heads=4, time_depth=2,
        space_depth=2, num_virtual_tracks=8, flow_emb_dim=8,
        model_resolution=(64, 96), iters=2,
    )


def cotracker3_small_config() -> CoTracker3Config:
    """The dims of the shipped weights (`cotracker3_small.npz`)."""
    return CoTracker3Config(
        latent_dim=96, corr_levels=3, corr_radius=3, corr_mlp_hidden=256,
        corr_mlp_out=192, hidden_size=256, num_heads=8, time_depth=3,
        space_depth=3, num_virtual_tracks=48, flow_emb_dim=64,
        model_resolution=(160, 224), iters=4,
        compute_dtype="bfloat16",
    )


def _compute_dtype(cfg: CoTracker3Config) -> Optional[torch.dtype]:
    """The reference's `dtype=` of its dense and conv layers: bf16, or None
    (the promotion of the input's and the f32 kernel's dtypes)."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


# -- building blocks ---------------------------------------------------------


class Dense(nn.Module):
    """flax `nn.Dense` with its `dtype`: weight (out, in), bias (out,)."""

    flax_kind = "dense"  # the weight bridge's layout (`convert._flax_layout`)

    def __init__(self, d_in: int, d_out: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax `padding="SAME"` on one axis: (low, high), the extra pixel high
    (so a 7x7 stride-2 conv on an even size pads (2, 3), a 3x3 one (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax `nn.Conv` (square kernel) on NCHW: `padding` an int (symmetric)
    or "same" (flax's "SAME", asymmetric where flax pads asymmetrically)."""

    flax_kind = "conv"

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1, padding=0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        x, pad = x.to(dt), self.padding
        if pad == "same":
            k = self.weight.shape[-1]
            (top, bottom), (left, right) = (_same_pads(n, k, self.stride) for n in x.shape[-2:])
            x, pad = F.pad(x, (left, right, top, bottom)), 0
        y = F.conv2d(x, self.weight.to(dt), None, self.stride, pad)
        return y + self.bias.to(dt)[:, None, None]


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) over NCHW spatial dims (statistics in f32
    whatever the compute dtype)."""
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=(-2, -1), keepdim=True, correction=0)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class ResidualBlock(nn.Module):
    """RAFT residual block, instance-norm variant (parameter-free norms)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv(in_planes, planes, 3, stride, 1, dtype)
        self.conv2 = Conv(planes, planes, 3, 1, 1, dtype)
        if stride != 1 or in_planes != planes:
            self.downsample_0 = Conv(in_planes, planes, 1, stride, 0, dtype)
        else:
            self.downsample_0 = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(instance_norm(self.conv1(x)))
        y = F.relu(instance_norm(self.conv2(y)))
        if self.downsample_0 is not None:
            x = instance_norm(self.downsample_0(x))
        return F.relu(x + y)


@functools.lru_cache(maxsize=32)
def _resize_weights(m: int, n: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """(m, n): `jax.image.compute_weight_mat` for the antialiased triangle
    kernel, scale n / m, no translation; computed in f32 on the host, cast
    to `dtype` and moved to the device once per shape (a copy to the card
    synchronizes the host)."""
    f32 = np.float32
    inv = 1.0 / (n / m)
    kernel_scale = f32(max(inv, 1.0))
    sample_f = (np.arange(n, dtype=f32) + f32(0.5)) * f32(inv) - f32(0.0) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0), f32(1) - np.abs(x))
    total = w.sum(0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    w = np.where(inside[None, :], w, f32(0)).astype(f32)
    with torch.inference_mode(False):  # usable outside inference mode too
        return torch.from_numpy(w).to(device, dtype)


def _resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """`jax.image.resize(x, ..., "bilinear")` (antialias=True) on the last two
    axes of (..., H, W): one contraction per axis whose size changes, each
    rounded to x's dtype, H first when `jnp.einsum`'s cost order puts it
    first."""
    h, w = x.shape[-2:]
    oh, ow = hw
    dims = []
    if oh != h:
        dims.append("h")
    if ow != w:
        dims.append("w")
    if len(dims) == 2 and w * h * oh + oh * w * ow > h * w * ow + h * ow * oh:
        dims = ["w", "h"]
    for d in dims:
        if d == "h":
            x = torch.matmul(_resize_weights(h, oh, x.device, x.dtype).t(), x)
        else:
            x = torch.matmul(x, _resize_weights(w, ow, x.device, x.dtype))
    return x


class BasicEncoder(nn.Module):
    """CoTracker's multi-scale RAFT encoder on NCHW: 4 stages resized to
    stride resolution and fused to `output_dim` channels."""

    def __init__(self, output_dim: int = 128, stride: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        d = output_dim
        self.stride = stride
        self.conv1 = Conv(3, d // 2, 7, 2, 3, dtype)
        self.layer1_0 = ResidualBlock(d // 2, d // 2, 1, dtype)
        self.layer1_1 = ResidualBlock(d // 2, d // 2, 1, dtype)
        self.layer2_0 = ResidualBlock(d // 2, d // 4 * 3, 2, dtype)
        self.layer2_1 = ResidualBlock(d // 4 * 3, d // 4 * 3, 1, dtype)
        self.layer3_0 = ResidualBlock(d // 4 * 3, d, 2, dtype)
        self.layer3_1 = ResidualBlock(d, d, 1, dtype)
        self.layer4_0 = ResidualBlock(d, d, 2, dtype)
        self.layer4_1 = ResidualBlock(d, d, 1, dtype)
        cat = d // 2 + d // 4 * 3 + 2 * d
        self.conv2 = Conv(cat, d * 2, 3, 1, 1, dtype)
        self.conv3 = Conv(d * 2, d, 1, 1, 0, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        out_hw = (h // self.stride, w // self.stride)
        x = F.relu(instance_norm(self.conv1(x)))
        a = self.layer1_1(self.layer1_0(x))
        b = self.layer2_1(self.layer2_0(a))
        c = self.layer3_1(self.layer3_0(b))
        e = self.layer4_1(self.layer4_0(c))
        cat = torch.cat([_resize_bilinear(t, out_hw) for t in (a, b, c, e)], dim=1)
        y = F.relu(instance_norm(self.conv2(cat)))
        return self.conv3(y)


class Attention(nn.Module):
    """to_q / to_kv / to_out attention (CoTracker blocks.Attention), the
    softmax written out."""

    def __init__(self, dim: int, num_heads: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.to_q = Dense(dim, dim, dtype)
        self.to_kv = Dense(dim, 2 * dim, dtype)
        self.to_out = Dense(dim, dim, dtype)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        h = self.num_heads
        hd = self.dim // h
        q = self.to_q(x)
        k, v = self.to_kv(ctx).chunk(2, dim=-1)

        def heads(t):
            return t.reshape(*t.shape[:-1], h, hd).transpose(-2, -3)

        q, k, v = heads(q), heads(k), heads(v)
        att = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(hd)
        att = torch.softmax(att, dim=-1).to(v.dtype)
        out = torch.matmul(att, v)
        out = out.transpose(-2, -3).reshape(*x.shape[:-1], self.dim)
        return self.to_out(out)


def _pre_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm(elementwise_affine=False), statistics in f32."""
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` with no dtype: f32 output, statistics by
    E[x^2] - E[x]^2 (flax's fast variance), scale and bias."""

    flax_kind = "norm"

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


@functools.lru_cache(maxsize=None)
def _gelu_constants(dtype: torch.dtype) -> Tuple[float, float]:
    """sqrt(2/pi) and 0.044715 rounded to `dtype`, as Python floats (a
    tensor made per call would be a host-to-device copy per call)."""
    return tuple(float(torch.tensor(v, dtype=dtype)) for v in (math.sqrt(2.0 / math.pi), 0.044715))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu(x, approximate=True)` op by op at x's dtype, its
    constants rounded to it (in bf16 this is not torch's one-rounding gelu)."""
    c, k = _gelu_constants(x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype)
        self.fc2 = Dense(hidden, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(_gelu_tanh(self.fc1(x)))


class AttnBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.attn = Attention(dim, num_heads, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(_pre_norm(x))
        return x + self.mlp(_pre_norm(x))


class CrossAttnBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm_context = LayerNorm(dim)
        self.cross_attn = Attention(dim, num_heads, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        ctx = self.norm_context(context)
        x = x + self.cross_attn(_pre_norm(x), context=ctx)
        return x + self.mlp(_pre_norm(x))


class EfficientUpdateFormer(nn.Module):
    """Alternating time/track attention with learned virtual tracks
    (parameter names mirror the upstream module, `virual_tracks` too)."""

    def __init__(self, cfg: CoTracker3Config):
        super().__init__()
        c = self.cfg = cfg
        dt = _compute_dtype(cfg)
        d = c.hidden_size
        self.input_transform = Dense(c.input_dim, d, dt)
        self.virual_tracks = nn.Parameter(torch.empty(1, c.num_virtual_tracks, 1, d))
        space_every = max(1, c.time_depth // c.space_depth)
        self.space_rounds = []  # time block index -> space round j
        for i in range(c.time_depth):
            self.add_module(f"time_blocks_{i}", AttnBlock(d, c.num_heads, c.mlp_ratio, dt))
            j = len(self.space_rounds)
            if i % space_every == 0 and j < c.space_depth:
                self.add_module(f"space_virtual2point_blocks_{j}",
                                CrossAttnBlock(d, c.num_heads, c.mlp_ratio, dt))
                self.add_module(f"space_virtual_blocks_{j}",
                                AttnBlock(d, c.num_heads, c.mlp_ratio, dt))
                self.add_module(f"space_point2virtual_blocks_{j}",
                                CrossAttnBlock(d, c.num_heads, c.mlp_ratio, dt))
                self.space_rounds.append(i)
        self.flow_head = Dense(d, 2)
        self.vis_conf_head = Dense(d, 2) if c.linear_layer_for_vis_conf else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, N, T, input_dim) -> (B, N, T, 4) [dx, dy, vis, conf]."""
        c = self.cfg
        tokens = self.input_transform(x)
        b, n, t, d = tokens.shape
        virtual = self.virual_tracks.expand(b, c.num_virtual_tracks, t, d).to(tokens.dtype)
        tokens = torch.cat([tokens, virtual], dim=1)
        n_tot = n + c.num_virtual_tracks
        for i in range(c.time_depth):
            block = getattr(self, f"time_blocks_{i}")
            tokens = block(tokens.reshape(b * n_tot, t, d)).reshape(b, n_tot, t, d)
            if i in self.space_rounds:
                j = self.space_rounds.index(i)
                space = tokens.transpose(1, 2).reshape(b * t, n_tot, d)
                pts, virt = space[:, :n], space[:, n:]
                virt = getattr(self, f"space_virtual2point_blocks_{j}")(virt, pts)
                virt = getattr(self, f"space_virtual_blocks_{j}")(virt)
                pts = getattr(self, f"space_point2virtual_blocks_{j}")(pts, virt)
                space = torch.cat([pts, virt], dim=1)
                tokens = space.reshape(b, t, n_tot, d).transpose(1, 2)
        tokens = tokens[:, :n].float()
        flow = self.flow_head(tokens)
        if self.vis_conf_head is not None:
            vis_conf = self.vis_conf_head(tokens)
        else:
            vis_conf = torch.zeros_like(flow)
        return torch.cat([flow, vis_conf], dim=-1)


def get_2d_embedding(xy: torch.Tensor, dim: int, cat_coords: bool = True) -> torch.Tensor:
    """Sincos embedding of 2-d offsets: per axis, interleaved sin/cos over
    `dim` channels, concatenated (+ raw xy)."""
    x, y = xy[..., 0:1], xy[..., 1:2]
    div = torch.arange(0, dim, 2, dtype=torch.float32, device=xy.device) * (1000.0 / dim)

    def pe(v):
        s, c = torch.sin(v * div), torch.cos(v * div)
        return torch.stack([s, c], dim=-1).reshape(*s.shape[:-1], dim)

    out = torch.cat([pe(x), pe(y)], dim=-1)
    if cat_coords:
        out = torch.cat([xy, out], dim=-1)
    return out


def get_1d_sincos_embed(dim: int, length: int, device=None) -> torch.Tensor:
    """Sincos time embedding (dim must be even): (length, dim) f32."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    omega = torch.arange(dim // 2, dtype=torch.float32, device=device) / (dim / 2.0)
    omega = 1.0 / (10000.0 ** omega)
    ang = pos * omega[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _stencil_gather(fmaps: torch.Tensor, frame: torch.Tensor, centers: torch.Tensor,
                    radius: int) -> torch.Tensor:
    """`stencil_sample` over a stack of maps: fmaps (F, h, w, C), frame
    (...) the map of each center (broadcast against centers' leading axes),
    centers (..., 2) xy -> (..., P, C). One (2r+2)^2 patch per center, the
    four lerp corners as shifted windows of it; indices clamped to the map."""
    _, h, w, c = fmaps.shape
    cx = centers[..., 0].clamp(0.0, w - 1.0)
    cy = centers[..., 1].clamp(0.0, h - 1.0)
    x0, y0 = torch.floor(cx), torch.floor(cy)
    fx = (cx - x0).to(fmaps.dtype)[..., None, None, None]
    fy = (cy - y0).to(fmaps.dtype)[..., None, None, None]
    offs = torch.arange(-radius, radius + 2, device=fmaps.device)
    xs = (x0.long()[..., None] + offs).clamp(0, w - 1)  # (..., S)
    ys = (y0.long()[..., None] + offs).clamp(0, h - 1)
    idx = (frame[..., None, None] * h + ys[..., :, None]) * w + xs[..., None, :]
    patch = fmaps.reshape(-1, c)[idx]  # (..., S, S, C)
    p00 = patch[..., :-1, :-1, :]
    p01 = patch[..., :-1, 1:, :]
    p10 = patch[..., 1:, :-1, :]
    p11 = patch[..., 1:, 1:, :]
    out = (p00 * (1 - fx) * (1 - fy) + p01 * fx * (1 - fy)
           + p10 * (1 - fx) * fy + p11 * fx * fy)
    return out.reshape(*centers.shape[:-1], (2 * radius + 1) ** 2, c)


def stencil_sample(fmap: torch.Tensor, centers: torch.Tensor, radius: int) -> torch.Tensor:
    """Bilinear samples at centers + the (2r+1)^2 integer stencil: fmap
    (h, w, c), centers (N, 2) xy -> (N, P, c), P = (2r+1)^2 offsets in
    y-major order. Points beyond the edge replicate the border row/col."""
    frame = torch.zeros(centers.shape[:-1], dtype=torch.long, device=fmap.device)
    return _stencil_gather(fmap[None], frame, centers, radius)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """flax `nn.avg_pool((2, 2), strides (2, 2), VALID)` on NCHW: the four
    values summed in row-major order in x's dtype, then halved twice."""
    h, w = x.shape[-2] // 2 * 2, x.shape[-1] // 2 * 2
    x = x[..., :h, :w]
    s = x[..., 0::2, 0::2] + x[..., 0::2, 1::2]
    s = s + x[..., 1::2, 0::2]
    s = s + x[..., 1::2, 1::2]
    return s / 4


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default kernel initialiser in place: normal with variance 1 /
    fan_in truncated at two standard deviations (fan_in: the elements of a
    weight's row, (out, in, ...) in torch's layout)."""
    std = math.sqrt(1.0 / weight[0].numel()) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


class CoTracker3Offline(nn.Module):
    """Whole-clip point tracker.

    forward(frames (B, T, H, W, 3) in [0, 255] (uint8 or float), queries (B,
    N, 3) [t, x, y] in input-pixel coords) -> dict with tracks (B, iters, T,
    N, 2), vis / conf logits (B, T, N); without the batch axis on the inputs,
    none on the outputs. The last iteration of `tracks` is the prediction.
    """

    def __init__(self, cfg: CoTracker3Config):
        super().__init__()
        self.cfg = cfg
        dt = _compute_dtype(cfg)
        p = cfg.patch_points
        self.fnet = BasicEncoder(cfg.latent_dim, cfg.stride, dt)
        self.updateformer = EfficientUpdateFormer(cfg)
        self.corr_mlp_fc1 = Dense(p * p, cfg.corr_mlp_hidden, dt)
        self.corr_mlp_fc2 = Dense(cfg.corr_mlp_hidden, cfg.corr_mlp_out, dt)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's default initialisers: LeCun normal (truncated at two
        standard deviations) for dense and conv kernels, zero biases, unit
        LayerNorm scales, normal(1.0) for the virtual tracks."""
        for name, prm in self.named_parameters():
            if name.endswith("virual_tracks"):
                prm.normal_(0.0, 1.0, generator=generator)
            elif name.endswith("norm_context.weight"):
                prm.fill_(1.0)
            elif prm.dim() >= 2:
                lecun_normal_(prm, generator)
            else:
                prm.zero_()

    def corr_embedding(self, neigh: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
        """neigh (B, T, N, P, C) and support (B, N, P, C) at the compute
        dtype -> (B, T, N, corr_mlp_out): their correlation volume, its
        products summed in f32 and divided by sqrt(C) in f32, through the
        correlation MLP."""
        b, t, n, p, _ = neigh.shape
        vol = torch.einsum("btnpc,bnqc->btnpq", neigh.float(),
                           support.float()) / math.sqrt(self.cfg.latent_dim)
        return self.corr_mlp_fc2(_gelu_tanh(self.corr_mlp_fc1(vol.reshape(b, t, n, p * p))))

    def forward(self, frames: torch.Tensor, queries: torch.Tensor) -> Dict[str, torch.Tensor]:
        single = frames.dim() == 4
        if single:
            frames, queries = frames[None], queries[None]
        c = self.cfg
        b, t_len, in_h, in_w, _ = frames.shape
        n = queries.shape[1]
        dev = frames.device
        mh, mw = c.model_resolution
        dt = _compute_dtype(c) or torch.float32
        video = frames.float().permute(0, 1, 4, 2, 3).reshape(b * t_len, 3, in_h, in_w)
        if (in_h, in_w) != (mh, mw):
            video = _resize_bilinear(video, (mh, mw))
        video = (2.0 * (video / 255.0) - 1.0).to(dt)

        fmaps = self.fnet(video)  # (B*T, C, h, w)
        pyramid = [fmaps]
        for _ in range(c.corr_levels - 1):
            pyramid.append(_avg_pool2(pyramid[-1]))
        pyramid = [fm.permute(0, 2, 3, 1).contiguous() for fm in pyramid]  # (B*T, h, w, C)

        scale = torch.tensor([mw / in_w / c.stride, mh / in_h / c.stride],
                             dtype=torch.float32, device=dev)
        queries = queries.to(dev, torch.float32)
        q_t = queries[..., 0].to(torch.int32).long()       # (B, N)
        q_xy = queries[..., 1:3] * scale                    # (B, N, 2) grid px
        clip0 = torch.arange(b, device=dev)[:, None] * t_len

        # track support patches at the query frame, per level
        support = [
            _stencil_gather(fm, clip0 + q_t, q_xy / (2.0 ** lvl), c.corr_radius).to(dt)
            for lvl, fm in enumerate(pyramid)
        ]                                                   # (B, N, P, C)
        time_emb = get_1d_sincos_embed(c.input_dim, t_len, dev)
        frame = (clip0 + torch.arange(t_len, device=dev))[:, :, None]  # (B, T, 1)

        coords = q_xy[:, None].expand(b, t_len, n, 2)       # (B, T, N, 2)
        vis = torch.zeros(b, t_len, n, device=dev)
        conf = torch.zeros_like(vis)
        all_coords = []
        for _ in range(c.iters):
            # the reference stops the gradient through the estimates here:
            # each iteration is supervised on its own refinement
            coords = coords.detach()
            corr_embs = []
            for lvl, fm in enumerate(pyramid):
                neigh = _stencil_gather(fm, frame, coords / (2.0 ** lvl), c.corr_radius)
                corr_embs.append(self.corr_embedding(neigh.to(dt), support[lvl]))
            corr_embs = torch.cat(corr_embs, dim=-1).float()
            flows = coords - q_xy[:, None]
            flows_emb = get_2d_embedding(flows, c.flow_emb_dim, cat_coords=c.flow_cat_coords)
            token = torch.cat([vis[..., None], conf[..., None], corr_embs, flows_emb], dim=-1)
            token = token + time_emb[:, None, :]
            delta = self.updateformer(token.transpose(1, 2)).transpose(1, 2)  # (B, T, N, 4)
            coords = coords + delta[..., :2]
            vis = vis + delta[..., 2]
            conf = conf + delta[..., 3]
            all_coords.append(coords)

        inv_scale = 1.0 / scale
        out = {"tracks": torch.stack(all_coords, dim=1) * inv_scale, "vis": vis, "conf": conf}
        if single:
            out = {k: v[0] for k, v in out.items()}
        return out


# -- self-describing weight files ----------------------------------------------

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
# read as a data file beside the JAX package; nothing of it is imported
_SHIPPED_WEIGHTS = os.path.join(_REPO, "rga3_tpu", "models", "stom", "weights",
                                "cotracker3_small.npz")


def config_from_dict(raw: Dict) -> CoTracker3Config:
    raw = dict(raw)
    raw["model_resolution"] = tuple(raw["model_resolution"])
    return CoTracker3Config(**raw)


def save_cotracker3(path: str, model_or_tree, cfg: CoTracker3Config) -> None:
    """A self-describing weight file (the JAX package's `save_cotracker3`):
    flat npz keyed by flax `keystr` paths, f32 leaves stored as f16, and a
    `__config__` JSON entry. `model_or_tree` is a CoTracker3Offline or its
    nested numpy flax tree."""
    from ...convert import save_keystr_npz

    save_keystr_npz(path, model_or_tree, dataclasses.asdict(cfg), np.float16)


def load_cotracker3(path: str, device: DeviceLike = None):
    """A self-describing weight file (flax `keystr` keys + `__config__`) ->
    (CoTracker3Offline on the device, eval mode; its CoTracker3Config).
    Raises KeyError for a file without a config."""
    from ...convert import load_keystr_npz, torch_state_dict_from_flax

    dev = resolve_device(device)
    tree, raw = load_keystr_npz(path)
    if raw is None:
        raise KeyError(f"{path}: no __config__ entry (not a save_cotracker3 file)")
    cfg = config_from_dict(raw)
    model = CoTracker3Offline(cfg)
    model.load_state_dict(torch_state_dict_from_flax(tree), strict=True)
    return model.to(dev).eval(), cfg


def shipped_tracker(path: Optional[str] = None, device: DeviceLike = None, **predictor_kw):
    """CoTracker3Predictor over the repo's trained weights (or an explicit
    self-describing npz); None when the file does not exist."""
    p = path or _SHIPPED_WEIGHTS
    if not os.path.exists(p):
        return None
    model, _ = load_cotracker3(p, device)
    return CoTracker3Predictor(model, device=device, **predictor_kw)


class CoTracker3Predictor:
    """CoTrackerPredictor-equivalent wrapper: segm-mask grid queries on a
    chosen frame, whole-clip (bidirectional) tracking, boolean visibility
    (sigmoid(vis) * sigmoid(conf) > 0.6). `track(frames, query_mask,
    query_frame_idx, grid_size)` is STOM's tracker interface.

    Runs on the card unless `device` names another; the model must be on
    that device. With `pre_resize`, uint8 frames are resized to the model
    resolution on the device (`ops.resize.resize_u8_bilinear_aa`, the
    reference's host PIL BILINEAR) and queries / tracks rescaled.
    """

    def __init__(self, model: CoTracker3Offline, device: DeviceLike = None,
                 max_points: int = 256, vis_threshold: float = 0.6,
                 pre_resize: bool = True, max_batch_clips: int = 8):
        self.device = resolve_device(device)
        have = next(model.parameters()).device
        if have.type != self.device.type or (
                self.device.index is not None and have.index != self.device.index):
            raise ValueError(f"the tracker model is on {have}, not on {self.device}")
        self.model = model
        self.max_points = max_points
        self.vis_threshold = vis_threshold
        self.pre_resize = pre_resize
        self.max_batch_clips = max(int(max_batch_clips), 1)

    def _prep(self, frames: Sequence[np.ndarray], pts: np.ndarray, query_frame_idx: int):
        """Point subselection, the frames on the device (resized to the model
        resolution with `pre_resize`) and the query padding to max_points.
        Returns (video (T, h, w, 3) on the device, q (max_points, 3) f32, n,
        back (2,))."""
        pts = np.asarray(pts, np.float32)
        n = min(len(pts), self.max_points)
        sel = np.linspace(0, len(pts) - 1, n).astype(int)
        pts = pts[sel]

        in_h, in_w = frames[0].shape[:2]
        mh, mw = self.model.cfg.model_resolution
        back = np.ones(2, np.float32)
        video = torch.from_numpy(np.stack(frames)).to(self.device)
        if self.pre_resize and (in_h, in_w) != (mh, mw) and frames[0].dtype == np.uint8:
            video = resize_u8_bilinear_aa(video, (mh, mw))
            fwd = np.asarray([mw / in_w, mh / in_h], np.float32)
            back = np.asarray([in_w / mw, in_h / mh], np.float32)
            pts = pts * fwd[None, :]

        pad = self.max_points - n
        q = np.concatenate(
            [np.full((len(pts), 1), query_frame_idx, np.float32), pts], axis=-1)
        if pad:
            q = np.concatenate([q, np.tile(q[-1:], (pad, 1))], axis=0)
        return video, q, n, back

    def _forward(self, preps: Sequence[Tuple]) -> Dict[str, torch.Tensor]:
        """One batched forward over `_prep` results of one shape (enqueued,
        not waited for)."""
        with torch.inference_mode():
            return self.model(torch.stack([p[0] for p in preps]),
                              torch.from_numpy(np.stack([p[1] for p in preps])).to(self.device))

    def _collect(self, out: Dict[str, torch.Tensor], preps: Sequence[Tuple]) -> List[Tuple]:
        """`_forward`'s outputs -> per clip (tracks, visible) as `_finish` gives them."""
        tracks = out["tracks"][:, -1].cpu().numpy()
        vis, conf = out["vis"].cpu().numpy(), out["conf"].cpu().numpy()
        return [self._finish(tracks[j], vis[j], conf[j], n, back)
                for j, (_, _, n, back) in enumerate(preps)]

    def _finish(self, out_tracks, out_vis, out_conf, n: int, back: np.ndarray):
        """Last-iteration (T, P, 2) tracks + (T, P) vis/conf (numpy) ->
        (tracks (T, n, 2) in input-pixel coords, visible (T, n) bool)."""
        tracks = np.asarray(out_tracks)[:, :n] * back[None, None, :]
        vis_p = 0.5 * (1.0 + np.tanh(0.5 * np.asarray(out_vis)))
        conf_p = 0.5 * (1.0 + np.tanh(0.5 * np.asarray(out_conf)))
        visible = (vis_p * conf_p)[:, :n] > self.vis_threshold
        return tracks.astype(np.float32), visible

    def track_points(self, frames: Sequence[np.ndarray], pts: np.ndarray,
                     query_frame_idx: int):
        """Track explicit (N, 2) points (padded / truncated to max_points);
        returns (tracks (T, N, 2), vis (T, N))."""
        t = len(frames)
        if len(pts) == 0:
            return np.zeros((t, 0, 2), np.float32), np.zeros((t, 0), bool)
        prep = [self._prep(frames, pts, query_frame_idx)]
        return self._collect(self._forward(prep), prep)[0]

    @staticmethod
    def _mask_points(query_mask: np.ndarray, grid_size: int):
        from .tracker import sample_grid_points_in_mask

        pts = sample_grid_points_in_mask(query_mask, grid_size)
        if len(pts) == 0:
            ys, xs = np.nonzero(query_mask)
            if len(ys) == 0:
                return np.zeros((0, 2), np.float32)
            pts = np.stack([xs, ys], -1).astype(np.float32)[:1]
        return pts

    def track(self, frames: Sequence[np.ndarray], query_mask: np.ndarray,
              query_frame_idx: int, grid_size: int = 100):
        pts = self._mask_points(query_mask, grid_size)
        if len(pts) == 0:
            t = len(frames)
            return np.zeros((t, 0, 2), np.float32), np.zeros((t, 0), bool)
        return self.track_points(frames, pts, query_frame_idx)

    def track_batch(self, frames_list: Sequence[Sequence[np.ndarray]],
                    masks: Sequence[np.ndarray], query_frame_idxs: Sequence[int],
                    grid_size: int = 100):
        """Track B clips in one batched forward per `max_batch_clips` chunk.
        Clips with another prepared shape (a ragged T, or mixed resolutions
        without pre_resize) run one by one. Returns a list of (tracks, vis)."""
        b = len(frames_list)
        results: List = [None] * b
        preps, live = [], []
        for i in range(b):
            pts = self._mask_points(masks[i], grid_size)
            if len(pts) == 0:
                t = len(frames_list[i])
                results[i] = (np.zeros((t, 0, 2), np.float32), np.zeros((t, 0), bool))
                continue
            preps.append(self._prep(frames_list[i], pts, query_frame_idxs[i]))
            live.append(i)
        if not live:
            return results
        if len({tuple(p[0].shape) for p in preps}) > 1:
            chunks = [[p] for p in preps]
        else:
            chunks = [preps[c0:c0 + self.max_batch_clips]
                      for c0 in range(0, len(preps), self.max_batch_clips)]
        # every chunk is enqueued before the first result is fetched
        pending = [(chunk, self._forward(chunk)) for chunk in chunks]
        outs = [r for chunk, out in pending for r in self._collect(out, chunk)]
        for i, r in zip(live, outs):
            results[i] = r
        return results

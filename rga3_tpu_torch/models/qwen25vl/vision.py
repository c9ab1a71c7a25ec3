"""Qwen2.5-VL windowed-attention vision tower, counterpart of
`rga3_tpu/models/qwen25vl/vision.py`.

Host side (numpy, `compute_vision_layout` / `layout_device_args`, and
`pad_vision_inputs` for a fixed token budget): window
reordering, per-grid segment ids, rotary coordinates and the gathers of the
uniform-window blocks, for a given `grid_thw`. Device side: the patch
embedding as one matmul over pre-extracted patches, `depth` blocks, then the
2x2 spatial merger. Full-attention blocks run the flash kernel with one
segment per grid; windowed blocks run plain batched per-window attention
over windows padded to the full tile (the JAX package computes that part
outside Pallas too), gathered in and out per block or, under
`window_resident`, once for the whole stack.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...data.processor import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD
from ...ops.attention import flash_attention, mha_reference
from ...ops.rope import apply_rope, vision_rope_cos_sin
from .config import QwenVisionConfig
from .language import RMSNorm, make_linear


class VisionLayout(NamedTuple):
    """Host-computed layout for one batch of grids (images/video clips)."""

    window_index: np.ndarray  # (L_merged,) permutation of merge units
    reverse_index: np.ndarray  # (L_merged,) inverse permutation
    window_seg: np.ndarray  # (L_tokens,) segment id per window
    grid_seg: np.ndarray  # (L_tokens,) segment id per grid
    hpos: np.ndarray  # (L_tokens,) window-ordered h coords
    wpos: np.ndarray  # (L_tokens,) window-ordered w coords
    total_tokens: int
    win_pad_units: np.ndarray  # padded-window slot -> unit index, or -1
    win_unpad_units: np.ndarray  # valid unit -> padded-stream position


def _grid_pos_ids(t: int, h: int, w: int, sms: int) -> np.ndarray:
    """Patch (h, w) coords in merge-unit order, repeated t times."""
    hpos = np.arange(h)[:, None].repeat(w, 1)
    wpos = np.arange(w)[None, :].repeat(h, 0)

    def perm(p):
        return p.reshape(h // sms, sms, w // sms, sms).transpose(0, 2, 1, 3).reshape(-1)

    return np.stack([np.tile(perm(hpos), t), np.tile(perm(wpos), t)], axis=-1)


def compute_vision_layout(
    grid_thw: Sequence[Tuple[int, int, int]], cfg: QwenVisionConfig
) -> VisionLayout:
    """Window reorder, segments and rotary coords for a list of grids (HF
    `get_window_index` + `rot_pos_emb`), on the host."""
    sms = cfg.spatial_merge_size
    unit = cfg.merge_unit
    wsize = cfg.window_size // sms // cfg.patch_size  # merged units per side
    tile_units = wsize * wsize
    window_index: List[np.ndarray] = []
    window_seqlens: List[int] = []
    grid_seqlens: List[int] = []
    pos_list: List[np.ndarray] = []
    win_pad_rows: List[np.ndarray] = []
    valid_units = start = 0
    for t, h, w in grid_thw:
        lh, lw = h // sms, w // sms
        idx = np.arange(t * lh * lw).reshape(t, lh, lw)
        pad_h, pad_w = (-lh) % wsize, (-lw) % wsize
        idx_p = np.pad(idx, ((0, 0), (0, pad_h), (0, pad_w)), constant_values=-100)
        nwh, nww = (lh + pad_h) // wsize, (lw + pad_w) // wsize
        idx_p = idx_p.reshape(t, nwh, wsize, nww, wsize)
        idx_p = idx_p.transpose(0, 1, 3, 2, 4).reshape(t * nwh * nww, tile_units)
        for row in idx_p:
            valid = row[row != -100]
            window_index.append(valid + start)
            window_seqlens.append(len(valid) * unit)
            slots = np.full(tile_units, -1, np.int64)
            slots[: len(valid)] = np.arange(valid_units, valid_units + len(valid))
            win_pad_rows.append(slots)
            valid_units += len(valid)
        start += t * lh * lw
        grid_seqlens.append(t * h * w)
        pos_list.append(_grid_pos_ids(t, h, w, sms))

    win_pad_units = np.concatenate(win_pad_rows)
    pos_of_valid = np.nonzero(win_pad_units >= 0)[0]
    win_unpad_units = pos_of_valid[np.argsort(win_pad_units[pos_of_valid])]
    window_index_np = np.concatenate(window_index)
    window_seg = np.repeat(np.arange(len(window_seqlens)), window_seqlens)
    grid_seg_natural = np.repeat(np.arange(len(grid_seqlens)), grid_seqlens)
    pos = np.concatenate(pos_list, axis=0)
    token_perm = (window_index_np[:, None] * unit + np.arange(unit)[None, :]).reshape(-1)
    pos_w = pos[token_perm]
    return VisionLayout(
        window_index=window_index_np,
        reverse_index=np.argsort(window_index_np),
        window_seg=window_seg.astype(np.int32),
        grid_seg=grid_seg_natural[token_perm].astype(np.int32),
        hpos=pos_w[:, 0].astype(np.int32),
        wpos=pos_w[:, 1].astype(np.int32),
        total_tokens=pos.shape[0],
        win_pad_units=win_pad_units.astype(np.int32),
        win_unpad_units=win_unpad_units.astype(np.int32),
    )


def layout_device_args(layout: VisionLayout, cfg: QwenVisionConfig) -> Dict[str, np.ndarray]:
    """The host part of the JAX package's `layout_device_args`: the index
    arrays the tower takes, as numpy (token-level window gathers; -1 marks
    a window-pad slot)."""
    unit = cfg.merge_unit
    token_perm = (layout.window_index[:, None] * unit + np.arange(unit)[None, :]).reshape(-1)
    wp = layout.win_pad_units.astype(np.int64)
    win_pad = np.where(
        wp[:, None] >= 0, wp[:, None] * unit + np.arange(unit)[None, :], -1
    ).reshape(-1)
    up = layout.win_unpad_units.astype(np.int64)
    win_unpad = (up[:, None] * unit + np.arange(unit)[None, :]).reshape(-1)
    return dict(
        hpos=layout.hpos.astype(np.int64),
        wpos=layout.wpos.astype(np.int64),
        grid_seg=layout.grid_seg.astype(np.int32),
        token_perm=token_perm.astype(np.int64),
        merged_reverse=layout.reverse_index.astype(np.int64),
        win_pad=win_pad.astype(np.int64),
        win_unpad=win_unpad.astype(np.int64),
    )


def win_budget_tokens(budget_tokens: int, cfg: QwenVisionConfig) -> int:
    """The padded-window stream's length for a token budget: edge windows
    are padded to full tiles (up to ~1.5x the tokens), in whole tiles."""
    tile = (cfg.window_size // cfg.patch_size) ** 2
    need = budget_tokens + budget_tokens // 2
    return -(-need // tile) * tile


def pad_vision_inputs(pixel_patches: np.ndarray, layout: VisionLayout,
                      cfg: QwenVisionConfig, budget_tokens: int,
                      win_budget: Optional[int] = None):
    """Pad ragged vision inputs to `budget_tokens` patches (a multiple of
    the merge unit), as the JAX package's `pad_vision_inputs`: pad patches
    are zeros in windows and a grid of their own (segment ids -3 / -4),
    left out of every window gather (-1) and mapped onto the merged tail,
    which the LM's scatter never reads. Returns (patches, layout args)."""
    if budget_tokens % cfg.merge_unit:
        raise ValueError(f"budget {budget_tokens} is not a multiple of the merge unit")
    n = layout.total_tokens
    if n > budget_tokens:
        raise ValueError(f"{n} vision tokens exceed the budget {budget_tokens}")
    pad = budget_tokens - n
    unit = cfg.merge_unit
    token_perm = (layout.window_index[:, None] * unit + np.arange(unit)[None, :]).reshape(-1)
    patches = np.zeros((budget_tokens, pixel_patches.shape[1]), pixel_patches.dtype)
    patches[:n] = pixel_patches

    def pad1(x, fill):
        return np.concatenate([x, np.full((pad,), fill, x.dtype)]) if pad else x

    wp = layout.win_pad_units.astype(np.int64)
    win_pad = np.where(wp[:, None] >= 0, wp[:, None] * unit + np.arange(unit)[None, :],
                       -1).reshape(-1).astype(np.int32)
    up = layout.win_unpad_units.astype(np.int64)
    win_unpad = (up[:, None] * unit + np.arange(unit)[None, :]).reshape(-1).astype(np.int32)
    wb = win_budget if win_budget is not None else win_budget_tokens(budget_tokens, cfg)
    if len(win_pad) > wb:
        raise ValueError(f"padded-window stream {len(win_pad)} exceeds win_budget {wb}")
    merged = n // unit
    layout_args = dict(
        hpos=pad1(layout.hpos, 0),
        wpos=pad1(layout.wpos, 0),
        window_seg=pad1(layout.window_seg, -3),
        grid_seg=pad1(layout.grid_seg, -4),
        token_perm=pad1(token_perm.astype(np.int32), 0),
        merged_reverse=np.concatenate([
            layout.reverse_index.astype(np.int32),
            np.arange(merged, merged + pad // unit, dtype=np.int32)]),
        win_pad=np.concatenate([win_pad, np.full(wb - len(win_pad), -1, np.int32)]),
        win_unpad=np.concatenate([win_unpad, np.full(budget_tokens - len(win_unpad), -1,
                                                     np.int32)]),
    )
    return patches, layout_args


def _take_fill(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[idx] along dim 0 with idx == -1 giving zeros."""
    out = t[idx.clamp(min=0)]
    keep = (idx >= 0).view(-1, *([1] * (t.dim() - 1)))
    return out * keep.to(out.dtype)


def uniform_window_attention(q, k, v, win_pad, win_unpad, tile: int):
    """Batched per-window attention over windows padded to full tiles.
    q/k/v (L, H, hd) in window order; pad slots are zero and masked as
    keys."""
    l, h, hd = q.shape
    nw = win_pad.shape[0] // tile
    qw = _take_fill(q, win_pad).reshape(nw, tile, h, hd)
    kw = _take_fill(k, win_pad).reshape(nw, tile, h, hd)
    vw = _take_fill(v, win_pad).reshape(nw, tile, h, hd)
    kv_seg = (win_pad < 0).to(torch.int32).reshape(nw, tile)
    aw = mha_reference(
        qw, kw, vw, segment_ids=torch.zeros_like(kv_seg), kv_segment_ids=kv_seg
    )
    return _take_fill(aw.reshape(-1, h, hd), win_unpad)


# the JAX package writes the vision norm as x * sqrt(1 / (var + eps)); in
# the port it is the same computation as the LM's RMSNorm
VisionRMSNorm = RMSNorm


class VisionBlock(nn.Module):
    def __init__(self, cfg: QwenVisionConfig, **factory):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.plain_attention = False
        self.norm1 = VisionRMSNorm(d, cfg.rms_norm_eps, **factory)
        f = cfg.intermediate_size
        # QuantLinear (int8, W8A8 from 32 tokens) under quant_int8 / quant_w8a8
        self.attn_qkv = make_linear(cfg, d, 3 * d, True, **factory)
        self.attn_proj = make_linear(cfg, d, d, True, **factory)
        self.norm2 = VisionRMSNorm(d, cfg.rms_norm_eps, **factory)
        self.mlp_gate = make_linear(cfg, d, f, True, **factory)
        self.mlp_up = make_linear(cfg, d, f, True, **factory)
        self.mlp_down = make_linear(cfg, f, d, True, **factory)

    def forward(self, x, cos, sin, grid_seg, win_pad, win_unpad, use_full: bool,
                resident_kv_seg: Optional[torch.Tensor] = None):
        """`resident_kv_seg` (n_win, tile) set: `x` is the padded window
        stream (`window_resident`), so window attention is a reshape into
        whole windows with those key segments (1 marks a pad slot) and
        full attention takes `grid_seg`, whose pad slots are -1."""
        cfg = self.cfg
        l, d = x.shape
        h, hd = cfg.num_heads, cfg.head_dim
        qkv = self.attn_qkv(self.norm1(x)).reshape(l, 3, h, hd)
        q = apply_rope(qkv[:, 0], cos, sin)
        k = apply_rope(qkv[:, 1], cos, sin)
        v = qkv[:, 2]
        tile = (cfg.window_size // cfg.patch_size) ** 2
        if use_full:
            attend = mha_reference if self.plain_attention else flash_attention
            attn = attend(q[None], k[None], v[None], segment_ids=grid_seg[None])[0]
        elif resident_kv_seg is not None:
            nw = l // tile
            attn = mha_reference(
                q.reshape(nw, tile, h, hd), k.reshape(nw, tile, h, hd),
                v.reshape(nw, tile, h, hd), segment_ids=torch.zeros_like(resident_kv_seg),
                kv_segment_ids=resident_kv_seg,
            ).reshape(l, h, hd)
        else:
            attn = uniform_window_attention(q, k, v, win_pad, win_unpad, tile)
        x = x + self.attn_proj(attn.reshape(l, d))
        normed = self.norm2(x)
        return x + self.mlp_down(F.silu(self.mlp_gate(normed)) * self.mlp_up(normed))


class QwenVisionTower(nn.Module):
    """Vision tower over window-ordered patch tokens. `pixel_patches`
    (L, C * tps * ps^2) arrive in natural merge-unit order, uint8 (CLIP
    normalization runs here) or already normalized; the output is merged
    tokens (L/4, out_hidden_size) in natural order.

    Under `window_resident` the tokens stay in padded window order through
    the whole block stack (one gather in, one out; the pad slots carry
    zeros in, are masked as keys in every block and dropped on the way
    out), as the JAX package's resident route. Under `scan_blocks` the
    blocks are the same modules; only the JAX package's parameter tree
    differs (`blocks_scan/block/...`, stacked along a leading block axis),
    which `convert` reads and writes (`flax_scan`)."""

    def __init__(self, cfg: QwenVisionConfig, **factory):
        super().__init__()
        self.cfg = cfg
        # (module prefix, the JAX package's stacked path) under scan_blocks
        self.flax_scan = ("blocks_", "blocks_scan/block") if cfg.scan_blocks else None
        d = cfg.hidden_size
        feat = cfg.in_channels * cfg.temporal_patch_size * cfg.patch_size ** 2
        self.patch_embed = nn.Linear(feat, d, bias=False, **factory)
        for i in range(cfg.depth):
            setattr(self, f"blocks_{i}", VisionBlock(cfg, **factory))
        self.merger_ln_q = VisionRMSNorm(d, cfg.rms_norm_eps, **factory)
        self.merger_fc1 = nn.Linear(cfg.merge_unit * d, cfg.merge_unit * d, **factory)
        self.merger_fc2 = nn.Linear(cfg.merge_unit * d, cfg.out_hidden_size, **factory)

    def forward(self, pixel_patches: torch.Tensor, layout: Dict[str, np.ndarray]):
        cfg = self.cfg
        dev = self.patch_embed.weight.device
        dtype = self.patch_embed.weight.dtype
        la = {k: torch.as_tensor(v, device=dev) for k, v in layout.items()}
        x = pixel_patches.to(dev)
        if x.dtype == torch.uint8:
            reps = x.shape[-1] // 3
            mean = torch.tensor(OPENAI_CLIP_MEAN, device=dev).repeat_interleave(reps) * 255.0
            std = torch.tensor(OPENAI_CLIP_STD, device=dev).repeat_interleave(reps) * 255.0
            x = (x.float() - mean) / std
        x = self.patch_embed(x.to(dtype))[la["token_perm"]]  # window order
        hpos, wpos, grid_seg, kv_seg = la["hpos"], la["wpos"], la["grid_seg"], None
        if cfg.window_resident:
            win_pad = la["win_pad"]
            tile = (cfg.window_size // cfg.patch_size) ** 2
            x, hpos, wpos = (_take_fill(t, win_pad) for t in (x, hpos, wpos))
            grid_seg = torch.where(win_pad >= 0, _take_fill(grid_seg, win_pad), -1)
            kv_seg = (win_pad < 0).to(torch.int32).reshape(-1, tile)
        cos, sin = vision_rope_cos_sin(hpos, wpos, cfg.head_dim)
        for i in range(cfg.depth):
            x = getattr(self, f"blocks_{i}")(
                x, cos, sin, grid_seg, la["win_pad"], la["win_unpad"],
                use_full=i in cfg.fullatt_block_indexes, resident_kv_seg=kv_seg,
            )
        if cfg.window_resident:
            x = _take_fill(x, la["win_unpad"])  # valid window order, budget pads 0
        x = self.merger_ln_q(x).reshape(-1, cfg.merge_unit * cfg.hidden_size)
        x = self.merger_fc2(F.gelu(self.merger_fc1(x)))
        return x[la["merged_reverse"]]  # natural order

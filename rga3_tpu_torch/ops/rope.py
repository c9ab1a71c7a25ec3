"""Rotary position embeddings: Qwen2.5-VL M-RoPE and the Qwen ViT 2D RoPE
(rotate_half layout), and SAM2's axial RoPE (interleaved pairs).

Counterpart of `rga3_tpu/ops/rope.py` (tables in f32).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def rope_inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (
        theta ** (
            torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
            / head_dim
        )
    )


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """x: (..., L, H, D); cos/sin: (..., L, D) (a head axis is inserted)."""
    if cos.dim() == x.dim() - 1:
        cos = cos.unsqueeze(-2)
        sin = sin.unsqueeze(-2)
    x32 = x.float()
    return (x32 * cos + rotate_half(x32) * sin).to(x.dtype)


def mrope_cos_sin(
    position_ids: torch.Tensor,
    head_dim: int,
    theta: float,
    mrope_section: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """position_ids (3, B, L) -> cos, sin (B, L, head_dim): frequency k of
    the half table comes from stream section[k] (HF
    `apply_multimodal_rotary_pos_emb`)."""
    assert sum(mrope_section) == head_dim // 2
    inv = rope_inv_freq(head_dim, theta, position_ids.device)
    freqs = position_ids.float()[..., None] * inv  # (3, B, L, D/2)
    sec_id = torch.cat([
        torch.full((n,), i, dtype=torch.long)
        for i, n in enumerate(mrope_section)
    ]).to(position_ids.device)
    merged = freqs.gather(
        0, sec_id.view(1, 1, 1, -1).expand(1, *freqs.shape[1:])
    )[0]
    emb = torch.cat([merged, merged], dim=-1)
    return emb.cos(), emb.sin()


def vision_rope_cos_sin(
    hpos: torch.Tensor, wpos: torch.Tensor, head_dim: int,
    theta: float = 10_000.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen ViT 2D rotary table: (L,) coords -> cos, sin (L, head_dim)."""
    inv = rope_inv_freq(head_dim // 2, theta, hpos.device)
    half = torch.cat(
        [hpos.float()[:, None] * inv, wpos.float()[:, None] * inv], dim=-1
    )
    emb = torch.cat([half, half], dim=-1)
    return emb.cos(), emb.sin()


# ---------------------------------------------------------------------------
# SAM2 axial RoPE (interleaved complex-pair convention)
# ---------------------------------------------------------------------------


def axial_cos_sin(end_x: int, end_y: int, dim: int, theta: float = 10_000.0,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """2D axial rotary table for a flattened (end_x * end_y) token grid:
    cos, sin (end_x * end_y, dim // 2) f32, the first dim // 4 pair
    frequencies for x (t % end_x), the rest for y (t // end_x). Computed in
    f32 in the order of the JAX package's numpy table."""
    quarter = dim // 4
    f32 = dict(dtype=torch.float32, device=device)
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 4, **f32)[:quarter] / dim))
    t = torch.arange(end_x * end_y, **f32)
    fx = torch.outer(t % end_x, freqs)
    fy = torch.outer(torch.floor(t / end_x), freqs)
    ang = torch.cat([fx, fy], dim=-1)
    return ang.cos(), ang.sin()


def apply_rotary_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                             ) -> torch.Tensor:
    """Rotate the interleaved (even, odd) pairs of x's last dim by the
    angles of cos / sin (broadcast against x[..., 0::2]), in f32; the
    output keeps x's dtype."""
    x32 = x.float()
    even, odd = x32[..., 0::2], x32[..., 1::2]
    out = torch.stack([even * cos - odd * sin, even * sin + odd * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)

"""[SEG]-token hidden-state extraction (counterpart of
`rga3_tpu/ops/seg_gather.py`): the hidden state one position before the
first [SEG] token of each row predicts it."""
from __future__ import annotations

from typing import Tuple

import torch


def shift_seg_mask(token_ids: torch.Tensor, seg_token_id: int) -> torch.Tensor:
    """(B, L) ids -> (B, L) bool mask, shifted left by one."""
    mask = token_ids == seg_token_id
    return torch.cat([mask[:, 1:], torch.zeros_like(mask[:, :1])], dim=1)


def gather_seg_embeddings(
    hidden: torch.Tensor, token_ids: torch.Tensor, seg_token_id: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden (B, L, D) -> (emb (B, D), has_seg (B,)): the first [SEG]'s
    embedding per row, zeros for a row without one."""
    mask = shift_seg_mask(token_ids, seg_token_id)
    has_seg = mask.any(dim=1)
    first = mask.int().argmax(dim=1)
    emb = hidden[torch.arange(hidden.shape[0], device=hidden.device), first]
    return emb * has_seg[:, None].to(emb.dtype), has_seg

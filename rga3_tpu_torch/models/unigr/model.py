"""UniGR composite: Qwen2.5-VL + the [SEG] projection head + SAM2, counterpart
of `rga3_tpu/models/unigr/model.py` on its inference path.

`UniGR(cfg, device=None, dtype=torch.float32)` builds the model on the card
(or on `device="cpu"` when asked) in `dtype`; `init_weights` fills it from a
`torch.Generator` without touching the host.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import torch
import torch.nn as nn

from ...config import ConfigBase, SegHeadConfig
from ...device import DeviceLike, resolve_device
from ...ops.seg_gather import gather_seg_embeddings
from ..qwen25vl.config import Qwen25VLConfig
from ..qwen25vl.model import Qwen25VL
from ..sam2.config import Sam2Config
from ..sam2.model import Sam2Model


@dataclass(frozen=True)
class UniGRConfig(ConfigBase):
    qwen: Qwen25VLConfig = field(default_factory=Qwen25VLConfig)
    sam2: Sam2Config = field(default_factory=Sam2Config)
    seg: SegHeadConfig = field(default_factory=SegHeadConfig)


class SegProjection(nn.Module):
    """text_hidden_fcs: Linear(H, H) -> ReLU -> Linear(H, out_dim)."""

    def __init__(self, in_dim: int, out_dim: int, **factory):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, in_dim, **factory)
        self.fc2 = nn.Linear(in_dim, out_dim, **factory)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


class UniGR(nn.Module):
    def __init__(self, cfg: UniGRConfig, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        factory = dict(device=resolve_device(device), dtype=dtype)
        self.qwen = Qwen25VL(cfg.qwen, **factory)
        self.grounding_encoder = Sam2Model(cfg.sam2, **factory)
        self.text_hidden_fcs = SegProjection(
            cfg.qwen.text.hidden_size, cfg.seg.out_dim, **factory
        )

    @property
    def device(self) -> torch.device:
        return self.grounding_encoder.no_mem_embed.device

    @property
    def dtype(self) -> torch.dtype:
        return self.grounding_encoder.no_mem_embed.dtype

    def seg_embeddings(self, hidden: torch.Tensor, token_ids: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Project the LM's hidden states and gather the first [SEG]'s."""
        return gather_seg_embeddings(
            self.text_hidden_fcs(hidden), token_ids, self.cfg.seg.seg_token_id
        )

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, std: float = 0.02) -> None:
        """Random weights from `generator` (on the parameters' device):
        normal(0, std) for Linear / Embedding / conv weights and raw
        parameters, zero biases, unit norm scales."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "bias":
                p.zero_()
            elif leaf == "weight" and p.dim() == 1:
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=generator)

"""Random weights for models built without a checkpoint (smoke runs, the
server's `--model_dir dummy`)."""
from __future__ import annotations

from typing import Iterable, Tuple

import torch


@torch.no_grad()
def random_init_(named_params: Iterable[Tuple[str, torch.Tensor]], generator: torch.Generator,
                 std: float = 0.02) -> None:
    """In place, in the given order, from `generator` (on the parameters'
    device): zero biases and LoRA B (PEFT's init: the adapters start as the
    identity), unit norm scales (1-d weights), normal(0, std) for the
    rest."""
    for name, p in named_params:
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias" or leaf.endswith("_lora_b"):
            p.zero_()
        elif leaf == "weight" and p.dim() == 1:
            p.fill_(1.0)
        else:
            p.normal_(0.0, std, generator=generator)

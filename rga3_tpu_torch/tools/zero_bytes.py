"""What a rank keeps resident over a mesh, reckoned on the meta device (nothing
is allocated), for the train CLI's model at a size and LoRA rank (the
release: 7B, r 128), at each (fsdp, tensor) asked:

  * the trainable state under ZeRO-2 (`MaskedAdamW`): f32 masters, Adam's
    mu (`adam_mu_dtype`) and nu of the rank's blocks (fsdp blocks of its
    tensor blocks; a tensor the rule gives no fsdp dimension stays whole);
  * the frozen weights (bf16) cut by `parallel.fsdp.shard_model`: the
    rank's tensor blocks of the LM, and the fsdp blocks of every frozen leaf
    in a gathered block; the leaves fsdp does not divide and those outside
    the gathered blocks stay whole.

    python -m rga3_tpu_torch.tools.zero_bytes [--model_size 7b] [--lora_r 128] \\
        [--fsdp 1 2 8 16] [--tensor 1] [--adam_mu_dtype float32]

Prints one JSON object: the trainable parameters, the bytes a whole state
holds, and for each "fsdp<f>-tensor<t>" the most loaded rank's (rank 0's)
trainable-state bytes, its frozen bytes, the whole-over-fsdp bytes of the
frozen leaves it keeps an fsdp block of, and the frozen bytes it keeps
whole over fsdp.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, Sequence

import numpy as np
import torch

from ..config import MeshConfig, SegHeadConfig
from ..models.sam2.config import Sam2Config, tiny_sam2_config
from ..models.unigr.build import QWEN_SIZES, qwen_config
from ..models.unigr.model import UniGR, UniGRConfig
from ..parallel.fsdp import shard_model
from ..parallel.mesh import Mesh
from ..parallel.sharding import state_entries
from ..train.optimizer import DTYPES, trainable_mask


def _model(model_size: str, lora_r: int) -> UniGR:
    qcfg = qwen_config(model_size)
    qcfg = qcfg.replace(text=qcfg.text.replace(lora_rank=lora_r, lora_alpha=2.0 * lora_r))
    scfg = tiny_sam2_config() if model_size == "tiny" else Sam2Config()
    return UniGR(UniGRConfig(qwen=qcfg, sam2=scfg, seg=SegHeadConfig(out_dim=scfg.d_model)),
                 device="meta", dtype=torch.bfloat16)


def rank_bytes(model_size: str, lora_r: int, fsdp: int, tensor: int,
               adam_mu_dtype: str = "float32") -> Dict:
    """Rank 0's resident bytes at (fsdp, tensor) (see the module doc)."""
    model = _model(model_size, lora_r)
    mask = trainable_mask(model)
    mesh = Mesh(MeshConfig(fsdp=fsdp, tensor=tensor), np.arange(fsdp * tensor).reshape(
        1, fsdp, tensor))
    plan = shard_model(model, mesh, trainable=mask.get)
    per_element = 4 + DTYPES[adam_mu_dtype].itemsize + 4  # f32 master, mu, f32 nu
    out = {"trainable_bytes": 0, "frozen_bytes": 0, "frozen_sharded_bytes": 0,
           "frozen_whole_bytes": 0, "unsharded_trainable_elements": 0}
    for name, x in state_entries(model).items():
        b = plan.blocks[name]
        if mask.get(name, False):
            n = x.numel() // (fsdp if b.fsdp_dim is not None else 1)
            out["trainable_bytes"] += n * per_element
            if b.fsdp_dim is None:
                out["unsharded_trainable_elements"] += x.numel()
            continue
        n = x.numel() * x.element_size()
        out["frozen_bytes"] += n
        if b.fsdp_stored:
            out["frozen_sharded_bytes"] += n * fsdp
        else:
            out["frozen_whole_bytes"] += n
    return out


def zero_bytes(model_size: str = "7b", lora_r: int = 128, fsdp: Sequence[int] = (1, 2, 8, 16),
               adam_mu_dtype: str = "float32", tensor: Sequence[int] = (1,)) -> Dict:
    model = _model(model_size, lora_r)
    mask = trainable_mask(model)
    trainable = sum(p.numel() for n, p in model.named_parameters() if mask[n])
    per_element = 4 + DTYPES[adam_mu_dtype].itemsize + 4
    out = {"model_size": model_size, "lora_r": lora_r, "adam_mu_dtype": adam_mu_dtype,
           "trainable": trainable, "whole_bytes": trainable * per_element,
           "frozen_whole_model_bytes": sum(
               x.numel() * x.element_size() for n, x in state_entries(model).items()
               if not mask.get(n, False)),
           "per_rank": {}}
    for t in tensor:
        for f in fsdp:
            out["per_rank"][f"fsdp{f}-tensor{t}"] = rank_bytes(model_size, lora_r, f, t,
                                                              adam_mu_dtype)
    return out


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model_size", choices=QWEN_SIZES, default="7b")
    p.add_argument("--lora_r", type=int, default=128)
    p.add_argument("--fsdp", type=int, nargs="+", default=[1, 2, 8, 16])
    p.add_argument("--tensor", type=int, nargs="+", default=[1])
    p.add_argument("--adam_mu_dtype", choices=sorted(DTYPES), default="float32")
    args = p.parse_args(argv)
    out = zero_bytes(args.model_size, args.lora_r, args.fsdp, args.adam_mu_dtype, args.tensor)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

"""The trainable state a rank keeps resident under ZeRO-2 (`MaskedAdamW` over
a mesh): f32 masters, Adam's mu (`adam_mu_dtype`) and nu, whole and per rank
of an fsdp axis of each given size, for the train CLI's model at a size and
LoRA rank (the release: 7B, r 128). The model is built on the meta device,
so nothing is allocated:

    python -m rga3_tpu_torch.tools.zero_bytes [--model_size 7b] [--lora_r 128] \\
        [--fsdp 1 2 8 16] [--adam_mu_dtype float32]

Prints one JSON object: the trainable parameters, the bytes a whole state
holds, and for each fsdp size the bytes of the most loaded rank (tensors the
sharding rule gives no dimension stay whole on every rank).
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
from ..parallel.mesh import Mesh
from ..parallel.sharding import infer_param_sharding
from ..train.optimizer import DTYPES, trainable_mask


def zero_bytes(model_size: str = "7b", lora_r: int = 128, fsdp: Sequence[int] = (1, 2, 8, 16),
               adam_mu_dtype: str = "float32") -> Dict:
    qcfg = qwen_config(model_size)
    qcfg = qcfg.replace(text=qcfg.text.replace(lora_rank=lora_r, lora_alpha=2.0 * lora_r))
    scfg = tiny_sam2_config() if model_size == "tiny" else Sam2Config()
    model = UniGR(UniGRConfig(qwen=qcfg, sam2=scfg, seg=SegHeadConfig(out_dim=scfg.d_model)),
                  device="meta", dtype=torch.bfloat16)
    mask = trainable_mask(model)
    params = {n: p for n, p in model.named_parameters() if mask[n]}
    per_element = 4 + DTYPES[adam_mu_dtype].itemsize + 4  # f32 master, mu, f32 nu
    out = {"model_size": model_size, "lora_r": lora_r, "adam_mu_dtype": adam_mu_dtype,
           "trainable": sum(p.numel() for p in params.values()), "per_rank": {}}
    out["whole_bytes"] = out["trainable"] * per_element
    for f in fsdp:
        mesh = Mesh(MeshConfig(fsdp=f), np.arange(f).reshape(1, f, 1))
        dims = infer_param_sharding(model, mesh, params)
        kept = sum(p.numel() // (f if dims[n] is not None else 1) for n, p in params.items())
        whole = sum(p.numel() for n, p in params.items() if dims[n] is None)
        out["per_rank"][f] = {"bytes": kept * per_element, "unsharded_elements": whole}
    return out


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model_size", choices=QWEN_SIZES, default="7b")
    p.add_argument("--lora_r", type=int, default=128)
    p.add_argument("--fsdp", type=int, nargs="+", default=[1, 2, 8, 16])
    p.add_argument("--adam_mu_dtype", choices=sorted(DTYPES), default="float32")
    args = p.parse_args(argv)
    out = zero_bytes(args.model_size, args.lora_r, args.fsdp, args.adam_mu_dtype)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

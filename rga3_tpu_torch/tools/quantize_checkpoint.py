"""Pre-quantize a UniGR (or plain Qwen2.5-VL) HF checkpoint to int8 / int4,
counterpart of `scripts/quantize_checkpoint.py`:

    python -m rga3_tpu_torch.tools.quantize_checkpoint --model_dir <hf-dir> \
        --out <dir> --bits 4 [--arch unigr|qwen] [--device cpu]

The directory is read with `load_unigr_state_dict` / `load_qwen25vl_state_dict`
in f32 into a model of the size whose parameter shapes it matches (7b, 3b
or tiny, with SAM2 Hiera-L or the tiny SAM2), quantized in place on
`--device` (default: the card) by `ops.quant.quantize_for_serving` (int4:
an int4 LM and an int8 vision tower; int8: both int8; SAM2 and the [SEG]
projection stay float), and written by `save_quantized` in the JAX
package's format with its meta (`bits`, `mode`, `arch`, `source`). The
tokenizer and processor files are copied beside it, so the directory is a
`--model_dir` for the server and the benchmark drivers. The last line
printed is `{"out", "mode", "arch"}` as JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from typing import Dict, Optional, Sequence

import torch

from ..config import SegHeadConfig
from ..device import resolve_device
from ..models.qwen25vl.loader import load_qwen25vl_state_dict, load_unigr_state_dict
from ..models.qwen25vl.model import Qwen25VL
from ..models.sam2.config import Sam2Config, tiny_sam2_config
from ..models.unigr.build import QWEN_SIZES, qwen_config
from ..models.unigr.model import UniGR, UniGRConfig
from ..ops.quant import quantize_for_serving, save_quantized

TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "vocab.json", "merges.txt",
                   "preprocessor_config.json", "chat_template.json", "special_tokens_map.json")


def _model(size: str, arch: str, device) -> torch.nn.Module:
    qcfg = qwen_config(size)
    if arch == "qwen":
        return Qwen25VL(qcfg, device=device)
    scfg = tiny_sam2_config() if size == "tiny" else Sam2Config()
    return UniGR(UniGRConfig(qwen=qcfg, sam2=scfg, seg=SegHeadConfig(out_dim=scfg.d_model)),
                 device=device)


def model_for(sd: Dict[str, torch.Tensor], arch: str, device) -> torch.nn.Module:
    """An f32 model on `device` of the size whose state-dict shapes are
    `sd`'s (compared on the meta device); ValueError if none is."""
    shapes = {k: tuple(v.shape) for k, v in sd.items()}
    for size in QWEN_SIZES:
        want = {k: tuple(v.shape) for k, v in _model(size, arch, "meta").state_dict().items()}
        if want == shapes:
            return _model(size, arch, device)
    raise ValueError(f"the checkpoint's {len(shapes)} tensors match no {arch} size of "
                     f"{QWEN_SIZES}")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--bits", type=int, choices=[4, 8], default=8)
    p.add_argument("--arch", choices=["unigr", "qwen"], default="unigr")
    p.add_argument("--device", default=None, help="default: the current CUDA device")
    return p.parse_args(argv)


@torch.no_grad()
def main(argv: Optional[Sequence[str]] = None) -> Dict[str, str]:
    args = parse_args(argv)
    device = resolve_device(args.device)
    mode = "int4" if args.bits == 4 else "int8"
    load = load_unigr_state_dict if args.arch == "unigr" else load_qwen25vl_state_dict
    sd = load(args.model_dir)
    model = model_for(sd, args.arch, device)
    model.load_state_dict(sd, strict=True)
    del sd
    quantize_for_serving(model.qwen if args.arch == "unigr" else model, mode)
    save_quantized(model, args.out, meta={"bits": args.bits, "mode": mode, "arch": args.arch,
                                          "source": os.path.abspath(args.model_dir)})
    for name in TOKENIZER_FILES:
        src = os.path.join(args.model_dir, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(args.out, name))
    out = {"out": args.out, "mode": mode, "arch": args.arch}
    print(json.dumps(out))
    sys.stdout.flush()
    return out


if __name__ == "__main__":
    main()

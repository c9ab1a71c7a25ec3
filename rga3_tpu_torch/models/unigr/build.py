"""UniGR from command-line flags, shared by the port's entry points (the
demo server and the benchmark drivers), counterpart of
`scripts/eval_vos.py`'s `build_segmentor`.

`--model_dir` is a UniGR Hugging Face directory (safetensors or
pytorch_model*.bin), a pre-quantized directory (`ops.quant.save_quantized`,
whose meta decides the quantization), or `dummy`: random weights from
`--seed`, quantized by the flags as a checkpoint would be. Only the
Qwen2.5-VL part is quantized; SAM2 and the [SEG] projection stay float.
`--model_size tiny` is the tests' f32 model; 3b and 7b run in bf16 with
SAM2 Hiera-L (the default `Sam2Config()`).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Tuple

import torch

from ...config import SegHeadConfig
from ...data.processor import QwenVLProcessor
from ...device import resolve_device
from ...ops.quant import (
    QUANT_CKPT_META, is_quantized_dir, load_quantized, quantize_for_serving, set_config_flags,
)
from ..qwen25vl import QWEN25_VL_3B, QWEN25_VL_7B, tiny_config
from ..qwen25vl.loader import load_unigr_state_dict
from ..sam2.config import Sam2Config, tiny_sam2_config
from ..sam2.loader import load_sam2_state_dict
from .model import UniGR, UniGRConfig

QWEN_SIZES = ("3b", "7b", "tiny")


def qwen_config(size: str):
    return {"7b": QWEN25_VL_7B, "3b": QWEN25_VL_3B}.get(size) or tiny_config()


def add_model_args(p: argparse.ArgumentParser) -> None:
    """The flags `build_model` reads."""
    p.add_argument("--model_dir", default=None,
                   help="UniGR HF dir, pre-quantized dir, or 'dummy' (random weights)")
    p.add_argument("--sam_pretrained", default=None,
                   help="SAM2 checkpoint (.pt) for a model_dir without SAM2 weights")
    p.add_argument("--model_size", choices=QWEN_SIZES, default="7b")
    p.add_argument("--int8", action="store_true", help="int8 LM and vision tower")
    p.add_argument("--int4", action="store_true", help="int4 LM and int8 vision tower")
    p.add_argument("--w8a8", action="store_true",
                   help="with --int8: int8 activations in prefill and the vision tower")
    p.add_argument("--kv-int8", dest="kv_int8", action="store_true", help="int8 KV cache")
    p.add_argument("--seed", type=int, default=0, help="of the dummy weights")
    p.add_argument("--device", default=None, help="default: the current CUDA device")



def _quant_flags(args, qcfg):
    """(quantization mode or None, whether `--model_dir` is pre-quantized,
    the Qwen config): the mode from the flags, or from the directory's meta,
    whose config then gets the quantized modules' flags."""
    if args.int8 and args.int4:
        raise ValueError("--int8 and --int4 are exclusive")
    mode = "int4" if args.int4 else ("int8" if args.int8 else None)
    prequantized = args.model_dir != "dummy" and is_quantized_dir(args.model_dir)
    if prequantized:
        with open(os.path.join(args.model_dir, QUANT_CKPT_META)) as f:
            mode = json.load(f)["mode"]
        w8a8 = args.w8a8 and mode == "int8"
        qcfg = qcfg.replace(
            text=qcfg.text.replace(quant_int8=mode == "int8", quant_int4=mode == "int4",
                                   quant_w8a8=w8a8, kv_cache_int8=args.kv_int8),
            vision=qcfg.vision.replace(quant_int8=True, quant_w8a8=w8a8))
    return mode, prequantized, qcfg


def _processor_dir(args, prequantized: bool) -> str:
    """A pre-quantized directory made from dummy weights has no tokenizer:
    it takes the dummy one, as its source did."""
    if args.model_dir == "dummy":
        return "dummy"
    if prequantized:
        with open(os.path.join(args.model_dir, QUANT_CKPT_META)) as f:
            if json.load(f).get("source") == "dummy":
                return "dummy"
    return args.model_dir


def build_model(args, device=None) -> Tuple[UniGR, QwenVLProcessor]:
    """(the UniGR of `args` on `device`, quantized as the flags or the
    directory's meta say; its processor)."""
    device = resolve_device(args.device if device is None else device)
    tiny = args.model_size == "tiny"
    dtype = torch.float32 if tiny else torch.bfloat16
    mode, prequantized, qcfg = _quant_flags(args, qwen_config(args.model_size))
    proc = QwenVLProcessor.from_pretrained(_processor_dir(args, prequantized))
    scfg = tiny_sam2_config() if tiny else Sam2Config()
    cfg = UniGRConfig(qwen=qcfg, sam2=scfg,
                      seg=SegHeadConfig(out_dim=scfg.d_model, seg_token_id=proc.seg_token_id))
    model = UniGR(cfg, device=device, dtype=dtype)
    if args.model_dir == "dummy":
        model.init_weights(torch.Generator(device).manual_seed(args.seed))
    else:
        if prequantized:
            sd, _ = load_quantized(args.model_dir, dtype)
        else:
            sd = load_unigr_state_dict(args.model_dir, dtype)
        if args.sam_pretrained and not any(k.startswith("grounding_encoder.") for k in sd):
            sd.update(("grounding_encoder." + k, v)
                      for k, v in load_sam2_state_dict(args.sam_pretrained, dtype).items())
        model.load_state_dict(sd, strict=True)
        del sd
    if mode and not prequantized:
        w8a8 = args.w8a8 and mode == "int8"
        set_config_flags(model.qwen, {"quant_w8a8": w8a8, "kv_cache_int8": args.kv_int8},
                         {"quant_w8a8": w8a8})
        quantize_for_serving(model.qwen, mode)
    return model.eval(), proc



"""Start the UniGR demo server on the card, counterpart of
`scripts/serve_app.py` with `scripts/eval_vos.py`'s `build_segmentor`:

    python -m rga3_tpu_torch.serve --model_dir <dir> [--sam_pretrained <pt>] \
        [--model_size 7b] [--int4 | --int8 [--w8a8]] [--kv-int8] \
        [--draft_dir <dir> --spec_k 4] [--qa_batch_window_ms 30] [--port 7860]

`--model_dir` is a UniGR Hugging Face directory (safetensors or
pytorch_model*.bin), a pre-quantized directory (`ops.quant.save_quantized`,
whose meta decides the quantization), or `dummy`: random weights from
`--seed`, quantized by the flags as a checkpoint would be. Only the
Qwen2.5-VL part is quantized; SAM2 and the [SEG] projection stay float.
`--draft_dir` (a Qwen2.5-VL-3B directory, or `dummy`; the tiny config with
`--model_size tiny`) is kept unquantized and makes QA decode
speculatively. Without `--model_dir` the server answers with stubs.
`build_service(args)` builds the `UniGRService` that `main` serves.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..config import SegHeadConfig
from ..data.processor import QwenVLProcessor
from ..data.video import load_frames_from_video
from ..device import resolve_device
from ..evaluation.segmentor import UniGRChat, UniGRSegmentor
from ..models.qwen25vl import QWEN25_VL_3B, QWEN25_VL_7B, tiny_config
from ..models.qwen25vl.loader import load_qwen25vl_state_dict, load_unigr_state_dict
from ..models.qwen25vl.model import Qwen25VL
from ..models.sam2.config import Sam2Config, tiny_sam2_config
from ..models.sam2.loader import load_sam2_state_dict
from ..models.unigr import UniGR, UniGRConfig
from ..ops.quant import (
    QUANT_CKPT_META, is_quantized_dir, load_quantized, quantize_for_serving, set_config_flags,
)
from .app import UniGRService, serve

QWEN_SIZES = ("3b", "7b", "tiny")


def qwen_config(size: str):
    return {"7b": QWEN25_VL_7B, "3b": QWEN25_VL_3B}.get(size) or tiny_config()


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
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
    p.add_argument("--draft_dir", default=None,
                   help="Qwen2.5-VL-3B HF dir or 'dummy': speculative decoding draft")
    p.add_argument("--spec_k", type=int, default=4, help="draft proposals an iteration")
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--qa_batch_window_ms", type=int, default=0,
                   help="> 0 coalesces concurrent QA requests into one answer_batch call, "
                   "adding up to this much latency a request")
    p.add_argument("--qa_max_batch", type=int, default=4)
    p.add_argument("--seed", type=int, default=0, help="of the dummy weights")
    p.add_argument("--device", default=None, help="default: the current CUDA device")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)
    return p.parse_args(argv)


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


def build_draft(args, device, dtype) -> Qwen25VL:
    draft = Qwen25VL(qwen_config("tiny" if args.model_size == "tiny" else "3b"), device=device,
                     dtype=dtype)
    if args.draft_dir == "dummy":
        draft.init_weights(torch.Generator(device).manual_seed(args.seed + 1))
    else:
        draft.load_state_dict(load_qwen25vl_state_dict(args.draft_dir, dtype), strict=True)
    return draft.eval()


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


def build_service(args, load_video: Callable = load_frames_from_video) -> UniGRService:
    """The service of `args`: no models without `--model_dir`."""
    kw = dict(qa_batch_window_ms=args.qa_batch_window_ms, qa_max_batch=args.qa_max_batch,
              load_video=load_video)
    if not args.model_dir:
        return UniGRService(**kw)
    model, proc = build_model(args)
    draft = None
    if args.draft_dir:
        draft = build_draft(args, model.device, model.dtype)
    chat = UniGRChat(model, proc, max_new_tokens=args.max_new_tokens, draft_model=draft,
                     spec_k=args.spec_k)
    return UniGRService(chat=chat, segmentor=UniGRSegmentor(model, proc, num_frames_mllm=8),
                        **kw)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    service = build_service(args)
    print(f"serving on {args.host}:{args.port}", flush=True)
    serve(service, port=args.port, host=args.host)


if __name__ == "__main__":
    main()

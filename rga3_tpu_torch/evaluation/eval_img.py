"""Image referring-segmentation CLI (gIoU / cIoU over ReasonSeg and the
RefCOCO family), counterpart of `scripts/eval_img.py`:

    python -m rga3_tpu_torch.evaluation.eval_img --model_dir <dir> \
        --data_root <data> --out <scores.json> [--datasets ReasonSeg:val,refcoco:testA] \
        [--max_samples N] [--model_size 7b] [--int4]

`--datasets all` runs ReasonSeg val and test and the RefCOCO-family splits
on disk; otherwise a comma list of <dataset>:<split> (ReasonSeg or
reason_seg for ReasonSeg). Each image is a one-frame video to
`segment_video`, on the card (`--device cpu` for the plain PyTorch route).
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

from ..models.unigr.build import add_model_args, build_model
from .image_seg_eval import run_all_image_seg_vals, run_reason_seg_val, run_refer_seg_val
from .segmentor import UniGRSegmentor


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_model_args(p)
    p.add_argument("--data_root", required=True)
    p.add_argument("--datasets", default="all",
                   help="comma list of <dataset>:<split> (refcoco:val, refcocog:test, "
                   "ReasonSeg:val, ...) or 'all'")
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if not args.model_dir:
        p.error("--model_dir is required")
    return args


def main(argv: Optional[Sequence[str]] = None, model=None) -> dict:
    """Score the datasets and write them to `--out`; returns the scores.
    `model`, a (UniGR, processor) pair, is used in place of the model of the
    flags."""
    args = parse_args(argv)
    if model is None:
        model = build_model(args)
    seg = UniGRSegmentor(*model, num_frames_mllm=1)
    if args.datasets == "all":
        scores = run_all_image_seg_vals(seg, args.data_root, max_samples=args.max_samples)
    else:
        scores = {}
        for spec in args.datasets.split(","):
            ds, _, split = spec.partition(":")
            split = split or "val"
            if ds.lower() in ("reason_seg", "reasonseg"):
                scores[f"ReasonSeg|{split}"] = run_reason_seg_val(
                    seg, args.data_root, split, max_samples=args.max_samples)
            else:
                scores[f"{ds}|{split}"] = run_refer_seg_val(
                    seg, args.data_root, ds, split, max_samples=args.max_samples)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(scores, f, indent=2)
    print(json.dumps(scores, indent=2))
    return scores


if __name__ == "__main__":
    main()

"""Referring-VOS benchmark CLI (MeViS / ReVOS / ReasonVOS / Ref-DAVIS /
Ref-YTVOS), counterpart of `scripts/eval_vos.py`:

    python -m rga3_tpu_torch.evaluation.eval_vos --stage infer --benchmark mevis \
        --data_root <mevis> --split valid_u --out_dir <out> --model_dir <dir> \
        [--sam_pretrained <pt>] [--model_size 7b] [--int4] \
        [--subset_idx I --subset_num N]
    python -m rga3_tpu_torch.evaluation.eval_vos --stage eval --benchmark mevis \
        --data_root <mevis> --split valid_u --out_dir <out> [--num_workers 8]

`infer` writes the PNG mask tree (`video_seg_eval.run_inference`) on the
card (`--device cpu` for the plain PyTorch route); shard it over N cards
with one process per card (`CUDA_VISIBLE_DEVICES`) and `--subset_idx`.
`eval` scores the tree on the host into `<out_dir>/jf_scores.json`
(`revos_scores.json` with the ReVOS accuracy and robustness splits,
`davis_scores.json` for Ref-DAVIS's per-annotator official tables);
Ref-YTVOS is scored by its server from the written tree.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

from ..models.unigr.build import add_model_args, build_model
from .segmentor import UniGRSegmentor
from .video_seg_eval import resolve_layout, run_eval, run_eval_revos, run_inference

BENCHMARKS = ("mevis", "revos", "reasonvos", "davis", "ytvos")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--stage", choices=["infer", "eval"], required=True)
    p.add_argument("--data_root", required=True)
    p.add_argument("--benchmark", default="mevis", choices=BENCHMARKS,
                   help="the reference driver's question template and layout; revos eval "
                   "adds the accuracy / robustness splits; ytvos has no eval stage")
    p.add_argument("--split", default="valid_u")
    p.add_argument("--out_dir", required=True)
    add_model_args(p)
    p.add_argument("--num_frames_mllm", type=int, default=8)
    p.add_argument("--subset_idx", type=int, default=0)
    p.add_argument("--subset_num", type=int, default=1)
    p.add_argument("--num_workers", type=int, default=8, help="eval worker processes")
    return p.parse_args(argv)


def _write_scores(scores, path: str) -> None:
    print(json.dumps(scores, indent=2))
    with open(path, "w") as f:
        json.dump(scores, f, indent=2)


def main(argv: Optional[Sequence[str]] = None, model=None) -> dict:
    """Run one stage. `model`, a (UniGR, processor) pair, is inferred with
    in place of the model of the flags (a caller that runs several stages
    or drivers on one model). Returns for infer {"n": expressions written,
    "seconds": run_inference's host seconds and the stage's "total",
    "segmentor"}, for eval the scores written."""
    args = parse_args(argv)
    if args.stage == "infer":
        if model is None:
            if not args.model_dir:
                raise SystemExit("--stage infer needs --model_dir")
            model = build_model(args)
        seg = UniGRSegmentor(*model, num_frames_mllm=args.num_frames_mllm)
        seconds = {}
        t0 = time.perf_counter()
        n = run_inference(seg, args.data_root, args.split, args.out_dir,
                          subset_idx=args.subset_idx, subset_num=args.subset_num,
                          benchmark=args.benchmark, seconds=seconds)
        seconds["total"] = time.perf_counter() - t0
        print(f"inferred {n} expressions in {seconds['total']:.2f} s", flush=True)
        if args.benchmark == "ytvos":
            print(f"Ref-YTVOS is scored by its server: zip the {args.out_dir} tree as "
                  "Annotations/ for submission", flush=True)
        return {"n": n, "seconds": seconds, "segmentor": seg}
    if args.benchmark == "ytvos":
        raise SystemExit("Ref-YTVOS has no local eval stage (its server scores the "
                         "submitted tree); run --stage infer and submit the PNG tree")
    if args.benchmark == "davis":
        from .davis_eval import eval_davis_annotators, postprocess_davis

        ann, _ = resolve_layout(args.data_root, args.split, "davis")
        merged = os.path.join(args.out_dir, "merged")
        postprocess_davis(args.out_dir, ann, merged)
        # the unsupervised task's ground truth, else the split's annotations
        gt_dir = os.path.join(args.data_root, "Annotations_unsupervised", "480p")
        if not os.path.isdir(gt_dir):
            gt_dir = os.path.join(args.data_root, args.split, "Annotations")
        scores = eval_davis_annotators(merged, gt_dir)
        _write_scores(scores, os.path.join(args.out_dir, "davis_scores.json"))
    elif args.benchmark == "revos":
        scores = run_eval_revos(args.data_root, args.split, args.out_dir,
                                num_workers=args.num_workers)
        _write_scores(scores, os.path.join(args.out_dir, "revos_scores.json"))
    else:
        scores = run_eval(args.data_root, args.split, args.out_dir, num_workers=args.num_workers)
        _write_scores(scores, os.path.join(args.out_dir, "jf_scores.json"))
    return scores


if __name__ == "__main__":
    main()

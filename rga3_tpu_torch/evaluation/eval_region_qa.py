"""Region-QA benchmark CLI (ViP-Bench and VideoRefer-Bench-Q), counterpart
of `scripts/eval_region_qa.py`:

    python -m rga3_tpu_torch.evaluation.eval_region_qa --bench vipbench --stage infer \
        --question_file <vip>/questions.jsonl --image_folder <vip>/images \
        --out <dir>/answers.json --model_dir <dir> [--batch_size 2] \
        [--subset_idx I --subset_num N]
    python -m rga3_tpu_torch.evaluation.eval_region_qa --bench videorefer --stage infer \
        --question_file <vr>/VideoRefer-Bench-Q.json --video_folder <vr>/videos \
        --out <dir>/preds.jsonl --model_dir <dir> [--num_frames 16] [--no_stom]
    python -m rga3_tpu_torch.evaluation.eval_region_qa --bench videorefer --stage eval \
        --out <dir>/preds.jsonl

The model flags are `models.unigr.build`'s; the chat runs on the card
(`--device cpu` for the plain PyTorch route), STOM's tracker is
`models.stom.default_tracker`'s. ViP-Bench writes the published evaluator's
`v1_<id>` answers file with the "[SEG]" / "segmentation" tokens banned; it
is graded by a GPT judge (`gpt_judge.grade_vipbench` over a transport),
which this CLI does not call. VideoRefer-Bench-Q's eval stage prints the
letter accuracy by question type.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Iterator, Optional, Sequence

from ..models.unigr.build import add_model_args, build_model
from .region_qa_eval import eval_videorefer, run_videorefer_bench_q, run_vipbench_inference
from .segmentor import UniGRChat


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--bench", choices=["vipbench", "videorefer"], required=True)
    p.add_argument("--stage", choices=["infer", "eval"], default="infer")
    p.add_argument("--question_file")
    p.add_argument("--image_folder", help="ViP-Bench image root")
    p.add_argument("--video_folder", help="VideoRefer frames root")
    p.add_argument("--out", required=True,
                   help="answers json (vipbench) / records jsonl (videorefer)")
    add_model_args(p)
    p.add_argument("--num_frames", type=int, default=16)
    p.add_argument("--shape", default="ellipse")
    p.add_argument("--no_stom", action="store_true")
    p.add_argument("--max_new_tokens", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--subset_idx", type=int, default=0)
    p.add_argument("--subset_num", type=int, default=1)
    return p.parse_args(argv)


def build_chat(args, model=None):
    """(UniGRChat, processor) over `model`, a (UniGR or Qwen25VL, processor)
    pair, or over the model of the flags."""
    net, proc = model if model is not None else build_model(args)
    return UniGRChat(net, proc, max_new_tokens=args.max_new_tokens), proc


def load_vipbench_items(question_file: str, image_folder: str, out_path: str,
                        subset_idx: int = 0, subset_num: int = 1) -> Iterator[dict]:
    """ViP-Bench's question-file rows {"question_id", "image", "text"} as a
    lazy stream of {"id", "image" (RGB uint8), "question"}: the shard's rows
    (`i % subset_num == subset_idx`) without those already answered in
    `out_path` (`v1_<id>` keys), dropped before any image is read."""
    import numpy as np
    from PIL import Image

    with open(question_file) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    rows = [r for i, r in enumerate(rows) if i % subset_num == subset_idx]
    if os.path.exists(out_path):
        with open(out_path) as f:
            done = set(json.load(f))
        rows = [r for r in rows if f"v1_{r['question_id']}" not in done]

    def gen():
        for row in rows:
            img = Image.open(os.path.join(image_folder, row["image"])).convert("RGB")
            yield {"id": row["question_id"], "image": np.asarray(img), "question": row["text"]}

    return gen()


def main(argv: Optional[Sequence[str]] = None, model=None) -> dict:
    """Run one stage. `model`, a (UniGR or Qwen25VL, processor) pair, is
    answered with in place of the model of the flags. Returns the printed
    dict: {"bench", "new", "out", "seconds"} for infer, the accuracies for
    VideoRefer's eval."""
    args = parse_args(argv)
    if args.stage == "eval":
        if args.bench == "vipbench":
            print("ViP-Bench is graded by a GPT judge: run "
                  "rga3_tpu_torch.evaluation.gpt_judge.grade_vipbench over a transport "
                  "with the published vip-bench-meta-data.json", file=sys.stderr)
            raise SystemExit(2)
        scores = eval_videorefer(args.out)
        print(json.dumps(scores, indent=2), flush=True)
        return scores
    chat, proc = build_chat(args, model)
    seconds = {}
    t0 = time.perf_counter()
    if args.bench == "videorefer":
        n = run_videorefer_bench_q(chat, args.question_file, args.video_folder, args.out,
                                   num_frames=args.num_frames, shape=args.shape,
                                   use_stom=not args.no_stom, device=args.device,
                                   stats=seconds)
    else:
        items = load_vipbench_items(args.question_file, args.image_folder, args.out,
                                    subset_idx=args.subset_idx, subset_num=args.subset_num)
        n = run_vipbench_inference(chat, items, args.out,
                                   tokenizer=getattr(proc, "tokenizer", None),
                                   batch_size=args.batch_size)
    seconds["total"] = time.perf_counter() - t0
    out = {"bench": args.bench, "new": n, "out": args.out, "seconds": seconds}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

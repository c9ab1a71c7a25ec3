"""VideoInfer benchmark CLI (region-level video QA), counterpart of
`scripts/eval_videoinfer.py`:

    python -m rga3_tpu_torch.evaluation.eval_videoinfer --stage infer \
        --data_root <videoinfer> --out <dir>/pred_0.jsonl --model_dir <dir> \
        [--model_size 7b] [--int4] [--use_stom] [--batch_size 4] \
        [--subset_idx 0 --subset_num 8] [--draft_dir <dir> --spec_k 4]
    python -m rga3_tpu_torch.evaluation.eval_videoinfer --stage merge \
        --out <dir>/pred.jsonl --shards '<dir>/pred_*.jsonl'
    python -m rga3_tpu_torch.evaluation.eval_videoinfer --stage eval \
        --data_root <videoinfer> --out <dir>/pred.jsonl

`infer` answers a shard of the items (`videoinfer.run_inference`: the RGBA
prompt overlay, STOM-propagated with `--use_stom`, the chat on the card;
`--device cpu` for the plain PyTorch route) and resumes past the ids in
`--out`; shard over N cards with one process per card. `--draft_dir`
decodes speculatively and forces `--batch_size 1`. `merge` joins the shards,
`eval` prints BLEU-4 / ROUGE-L / CIDEr / METEOR of the merged predictions
against the answered QA of `<split>.json`.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from ..data.templates import get_sparse_indices
from ..models.unigr.build import add_draft_args, add_model_args, build_draft, build_model
from . import videoinfer as vi
from .caption_metrics import meteor_stages
from .segmentor import UniGRChat


def load_qa_data(data_root: str, split: str = "test") -> Dict:
    with open(os.path.join(data_root, f"{split}.json")) as f:
        return json.load(f)


def load_items(data_root: str, split: str = "test", num_frames: int = 8) -> Iterator[Dict]:
    """The items of the published VideoInfer layout, one a QA:

      <root>/<split>.json  {vid: {"expressions": {exp: {"QA": {qa: {"Q", "A"}},
          "overlayed_frame_idx", "color", "shape", "anno_id"}}}}
      <root>/frames/<vid>/*.jpg  (sorted; a frame's index is its place)
      <root>/visual_prompts/<vid>/<exp>/<shape>.npz  RGBA under "arr_0"
      <root>/mask_dict.json  {str(anno_id): [RLE or None] * T}

    The frames are get_sparse_indices(T, num_frames - 1) and the overlaid
    frame, sorted; an id is "vid____exp____qa" (the GPT batch judge's
    custom_id). The items of one expression share its frames."""
    from PIL import Image

    qa_data = load_qa_data(data_root, split)
    for vid_id, vid in qa_data.items():
        image_files = sorted(glob.glob(os.path.join(data_root, "frames", vid_id, "*.jpg")))
        total = len(image_files)
        for exp_id, exp in vid["expressions"].items():
            key_frame = exp["overlayed_frame_idx"]
            shape = exp["shape"]
            npz_path = os.path.join(data_root, "visual_prompts", vid_id, exp_id, f"{shape}.npz")
            overlay = None
            if os.path.exists(npz_path):
                overlay = np.load(npz_path)["arr_0"].astype(np.uint8)
            sparse = get_sparse_indices(total, num_frames - 1)
            sparse.append(key_frame)
            sparse = sorted(sparse)
            frames = [np.asarray(Image.open(image_files[i]).convert("RGB")) for i in sparse]
            for qa_id, qa in exp["QA"].items():
                yield {
                    "id": f"{vid_id}____{exp_id}____{qa_id}",
                    "vid_id": vid_id,
                    "exp_id": exp_id,
                    "qa_id": qa_id,
                    "frames": frames,
                    "question": qa["Q"],
                    "answer": qa.get("A", ""),
                    "vip_overlay": overlay,
                    "key_idx": sparse.index(key_frame),
                    "shape": shape,
                    "color": exp.get("color"),
                }


def load_answers(data_root: str, split: str = "test") -> Dict[str, str]:
    """id -> ground-truth answer of every QA that has one."""
    return {
        f"{vid}____{exp_id}____{qa_id}": qa["A"]
        for vid, v in load_qa_data(data_root, split).items()
        for exp_id, exp in v["expressions"].items()
        for qa_id, qa in exp["QA"].items()
        if qa.get("A")  # an unanswered probe cannot be scored
    }


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--stage", choices=["infer", "merge", "eval"], required=True)
    p.add_argument("--data_root")
    p.add_argument("--split", default="test")
    p.add_argument("--out", required=True)
    p.add_argument("--shards", default=None, help="merge: a glob of the shards' files")
    add_model_args(p)
    add_draft_args(p)
    p.add_argument("--subset_idx", type=int, default=0)
    p.add_argument("--subset_num", type=int, default=1)
    p.add_argument("--use_stom", action="store_true")
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=4,
                   help="> 1 answers a batch in one prefill and decode (answer_batch)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, model=None) -> dict:
    """Run one stage. `model`, a (UniGR or Qwen25VL, processor) pair, is
    answered with in place of the model of the flags. Returns for infer
    {"n": items written, "seconds": run_inference's legs and the stage's
    "total", "chat"}, for merge {"n", "shards"}, for eval the scores
    printed."""
    args = parse_args(argv)
    if args.stage == "merge":
        shards = sorted(glob.glob(args.shards))
        n = vi.merge_shards(shards, args.out)
        print(f"merged {n} predictions from {len(shards)} shards", flush=True)
        return {"n": n, "shards": shards}
    if args.stage == "eval":
        scores = vi.run_eval(args.out, load_answers(args.data_root, args.split))
        print(f"METEOR stages: {meteor_stages()}", flush=True)
        print(json.dumps(scores, indent=2), flush=True)
        return scores
    if model is None:
        if not args.model_dir:
            raise SystemExit("--stage infer needs --model_dir")
        model = build_model(args)
    net, proc = model
    if args.draft_dir and args.batch_size != 1:
        # speculative decoding is answer()'s; answer_batch would not use the draft
        print("--draft_dir forces --batch_size 1", file=sys.stderr)
        args.batch_size = 1
    draft = build_draft(args, net.device, net.dtype) if args.draft_dir else None
    chat = UniGRChat(net, proc, max_new_tokens=args.max_new_tokens, draft_model=draft,
                     spec_k=args.spec_k)
    seconds: Dict[str, float] = {}
    t0 = time.perf_counter()
    items = list(load_items(args.data_root, args.split))
    seconds["load"] = time.perf_counter() - t0
    n = vi.run_inference(chat, items, args.out, use_stom=args.use_stom,
                         subset_idx=args.subset_idx, subset_num=args.subset_num,
                         batch_size=args.batch_size, device=args.device, stats=seconds)
    seconds["total"] = time.perf_counter() - t0
    print(f"inferred {n} items in {seconds['total']:.2f} s", flush=True)
    return {"n": n, "seconds": seconds, "chat": chat}


if __name__ == "__main__":
    main()

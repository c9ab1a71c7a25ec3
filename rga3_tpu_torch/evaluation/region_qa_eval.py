"""Region-QA benchmarks, the counterpart of
`rga3_tpu/evaluation/region_qa_eval.py`: VideoRefer-Bench-Q (multiple
choice over videos with per-object overlays) and ViP-Bench (GPT-judged QA
on single images with a drawn region).

VideoRefer-Bench-Q draws a coloured ellipse (or `shape`) around each
object's key-frame mask, propagates it to the other frames with STOM, asks
the question with its `<objectN><region>` markers named by colour and
shape, and records the first character of the answer. ViP-Bench answers
with the "[SEG]" and "segmentation" tokens banned and writes the published
evaluator's flat `v1_<id>` answers file. STOM's tracker runs on the card
unless `device` asks for the CPU; the overlays, PIL decoding and the
compositing are host work.
"""
from __future__ import annotations

import json
import os
import random
import re
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..device import DeviceLike
from .caption_metrics import multiple_choice_accuracy


def suppress_token_ids(tokenizer, words=("[SEG]", "segmentation")) -> List[int]:
    """Token ids to ban in free-form QA decoding: the ids of `words`, sorted;
    a word the tokenizer fails on adds none."""
    ids: List[int] = []
    for w in words:
        try:
            ids.extend(tokenizer(w, add_special_tokens=False)["input_ids"])
        except Exception:  # the reference's rule: such a word bans nothing
            pass
    return sorted(set(ids))


def _done_keys(out_path: str, key: str) -> set:
    done = set()
    if os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                try:
                    done.add(json.loads(line)[key])
                except Exception:
                    pass
    return done


def _stom(use_stom: bool, device: DeviceLike):
    if not use_stom:
        return None
    from ..models.stom import STOM

    return STOM(device=device)


def run_videorefer_inference(
    chat,
    items: Sequence[Dict],  # {"id", "frames", "question", "answer",
    # "type", "mask" (key-frame binary mask), "key_idx"}
    out_path: str,
    use_stom: bool = True,
    device: DeviceLike = None,
) -> int:
    """A red ellipse around each item's key-frame mask (propagated by
    `STOM(device=device)` when `use_stom`), then a free-form answer; records
    {"id", "pred", "Answer", "type"} lines and resumes past the ids already
    written."""
    from PIL import Image

    from ..data.visual_prompts import COLOR_POOL, image_blending

    stom = _stom(use_stom, device)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    n = 0
    done = _done_keys(out_path, "id")
    with open(out_path, "a") as out:
        for item in items:
            if item["id"] in done:
                continue
            frames = list(item["frames"])
            key = item.get("key_idx", 0)
            blended, vip = image_blending(
                Image.fromarray(frames[key]), shape="ellipse", mask=item["mask"],
                rgb_value=COLOR_POOL["red"], image_size_anchor=448, return_vip_img=True)
            frames[key] = np.asarray(blended)
            if stom is not None and len(frames) > 1:
                frames = stom.propagate_in_video(frames, vip, key, shape="ellipse")
            pred = chat.answer(item["question"], video_frames=frames)
            out.write(json.dumps({
                "id": item["id"], "pred": pred,
                "Answer": item["answer"], "type": item.get("type", "all"),
            }) + "\n")
            n += 1
    return n


def run_videorefer_bench_q(
    chat,
    question_file: str,
    video_folder: str,
    out_path: str,
    num_frames: int = 16,
    shape: str = "ellipse",
    use_stom: bool = True,
    seed: int = 100,
    device: DeviceLike = None,
    stats: Optional[Dict[str, float]] = None,
) -> int:
    """The published VideoRefer-Bench-Q pipeline over the released layout:

    * `question_file`: a JSON list of {"video", "frame_idx", "annotation"
      (per object, frame_idx -> {"segmentation": COCO RLE}), "Question" with
      `<objectN><region>` markers, "options", "Answer", "type"};
    * `video_folder/<video>/`: the frames as image files, in sorted order.

    An item samples num_frames - 1 frames by linspace plus the key frame
    (duplicates kept), draws each object's `shape` in a distinct colour
    (drawn by `random.Random(seed).sample` over COLOR_POOL) on the key frame
    from its mask, propagates each non-empty overlay with STOM, names the
    objects "the object within {color} {shape}" in the question and the
    options, asks for the option's letter and records {"idx", "video",
    "Answer", "pred": the answer's first character, "type"}; a run resumes
    past the idx already written. STOM is `STOM(device=device)`. `stats`,
    when given, receives the host seconds of the STOM leg (`stom_s`) and of
    the chat leg (`answer_s`)."""
    from PIL import Image

    from ..data.visual_prompts import COLOR_POOL, video_blending_keyframes
    from ..utils import rle as rle_codec

    rng = random.Random(seed)
    stom = _stom(use_stom, device)
    acc = {"stom_s": 0.0, "answer_s": 0.0}

    with open(question_file) as f:
        data = json.load(f)
    done = _done_keys(out_path, "idx")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    n = 0
    with open(out_path, "a") as out:
        for idx, line in enumerate(data):
            if idx in done:
                continue
            key_frame_idxs = [int(line["frame_idx"])]
            frames_root = os.path.join(video_folder, line["video"])
            # frame_idx counts frames in temporal order: sort the names
            frames_name = sorted(os.listdir(frames_root))
            indices = np.linspace(0, len(frames_name) - 1, num_frames - 1, dtype=int).tolist()
            selected = sorted(indices + key_frame_idxs)
            frames = [Image.open(os.path.join(frames_root, frames_name[i])).convert("RGB")
                      for i in selected]
            is_key = [i in key_frame_idxs for i in selected]

            question = line["Question"]
            options = list(line["options"])
            colors = rng.sample(list(COLOR_POOL.keys()), len(line["annotation"]))
            # annotation oi names the oi-th marker of the question; an object
            # without a marker keeps its own index
            obj_ids = [int(i) for i in re.findall(r"<object(\d+)><region>", question)]
            cur = frames
            for oi, anno in enumerate(line["annotation"]):
                oid = obj_ids[oi] if oi < len(obj_ids) else oi
                # only the key frames' masks are drawn (STOM works from the
                # overlay): the other frames' RLEs are not decoded
                masks = []
                for fi, kf in zip(selected, is_key):
                    seg = (anno.get(str(fi)) or {}).get("segmentation")
                    masks.append(rle_codec.decode(seg) if kf and seg is not None
                                 else np.zeros(1))
                color = colors[oi]
                blended, vip = video_blending_keyframes(
                    cur, masks, is_key, color, shape, return_vip_img=True)
                if stom is not None and vip is not None and (np.array(vip)[:, :, 3] > 0).any():
                    t0 = time.perf_counter()
                    cur = stom.propagate_in_video(cur, vip, is_key.index(True), shape=shape)
                    acc["stom_s"] += time.perf_counter() - t0
                else:
                    cur = blended
                marker = f"the object within {color} {shape}"
                question = question.replace(f"<object{oid}><region>", marker)
                options = [o.replace(f"<object{oid}>", marker) for o in options]

            prompt = (question + "\n" + " ".join(options) + "\n"
                      + "Answer with the option's letter from the given choices directly.")
            t0 = time.perf_counter()
            pred = chat.answer(prompt, video_frames=[np.asarray(f) for f in cur])
            acc["answer_s"] += time.perf_counter() - t0
            out.write(json.dumps({
                "idx": idx,
                "video": line["video"],
                "Answer": line["Answer"],
                "pred": pred[0] if pred else "",
                "type": line.get("type", "all"),
            }) + "\n")
            out.flush()
            n += 1
    if stats is not None:
        stats.update(acc)
    return n


def eval_videorefer(pred_path: str) -> Dict[str, float]:
    """Letter accuracy of the records by "type", and "overall"."""
    by_type: Dict[str, List] = {}
    with open(pred_path) as f:
        for line in f:
            d = json.loads(line)
            by_type.setdefault(d.get("type", "all"), []).append(d)
    out = {}
    all_preds, all_ans = [], []
    for tp, items in by_type.items():
        preds = [d["pred"] for d in items]
        ans = [d["Answer"] for d in items]
        out[tp] = multiple_choice_accuracy(preds, ans)
        all_preds += preds
        all_ans += ans
    out["overall"] = multiple_choice_accuracy(all_preds, all_ans)
    return out


def run_vipbench_inference(
    chat,
    items: Sequence[Dict],  # {"id", "image", "question"}
    out_path: str,
    tokenizer=None,
    batch_size: int = 1,
) -> int:
    """Single-image region QA with the ids of `suppress_token_ids(tokenizer)`
    banned; batch_size > 1 answers through `chat.answer_batch`. The answers
    file is the published evaluator's flat {"v1_<question_id>": text} dict,
    rewritten after each batch; ids already in it are skipped."""
    sup = suppress_token_ids(tokenizer) if tokenizer is not None else []
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    results = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
    n = 0
    batched = batch_size > 1 and hasattr(chat, "answer_batch")
    pending: List[Dict] = []

    def key(item):
        return f"v1_{item['id']}"

    def flush():
        nonlocal n
        if not pending:
            return
        preds = chat.answer_batch([it["question"] for it in pending],
                                  images_list=[[it["image"]] for it in pending],
                                  suppress_ids=sup)
        for it, pred in zip(pending, preds):
            results[key(it)] = pred
            n += 1
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2)
        pending.clear()

    for item in items:
        if key(item) in results:
            continue
        if batched:
            pending.append(item)
            if len(pending) >= batch_size:
                flush()
            continue
        results[key(item)] = chat.answer(item["question"], images=[item["image"]],
                                         suppress_ids=sup)
        n += 1
    if batched:
        flush()
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    return n


def eval_vipbench_with_judge(
    pred_path: str,
    gts: Dict[str, Dict],  # id -> {"question", "answer"}
    judge_fn: Callable[[str, str, str], float],  # (q, gt, pred) -> score 0-10
    runs: int = 5,
) -> Dict[str, float]:
    """The judge's score of each answer averaged over `runs`, then over the
    answers with a ground truth. `pred_path` holds the evaluator's flat
    "v1_<id>" dict; `gts` may be keyed either way (bare ids get "v1_")."""
    with open(pred_path) as f:
        preds = json.load(f)
    gts = {(k if k.startswith("v1_") else f"v1_{k}"): v for k, v in gts.items()}
    scores = []
    for pid, pred in preds.items():
        if pid not in gts:
            continue
        g = gts[pid]
        per_run = [judge_fn(g["question"], g["answer"], pred) for _ in range(runs)]
        scores.append(float(np.mean(per_run)))
    return {"score": float(np.mean(scores)) if scores else 0.0, "n": len(scores)}

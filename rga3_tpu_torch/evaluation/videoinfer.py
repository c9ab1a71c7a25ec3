"""VideoInfer region-level video QA: `run_inference`, the counterpart of
`rga3_tpu/evaluation/videoinfer_eval.py`'s.

Each item carries an RGBA overlay drawn on one key frame (`vip_overlay`).
STOM propagates it to every frame (or, without STOM, it is composited onto
the key frame alone) and the chat answers `REFERRING_VQA_PROMPT` over the
frames. Predictions are written as {"id", "pred"} JSON lines and a run
resumes past the ids already in the file.

With `batch_size` > 1 the chat answers a batch at once (`answer_batch`) and
STOM propagates batch k+1 on a worker thread while the chat decodes batch k.
Both stay on the device's default stream: the int4 decode's split-sum
workspace allows no two calls to overlap, and one stream orders them.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.templates import REFERRING_VQA_PROMPT
from ..device import DeviceLike


def run_inference(
    chat,  # UniGRChat-compatible: .answer(question, video_frames=...)
    items: Sequence[Dict],  # [{"id", "frames", "question", "vip_overlay"
    # (RGBA ndarray or None), "key_idx", "shape"}]
    out_path: str,
    use_stom: bool = True,
    subset_idx: int = 0,
    subset_num: int = 1,
    batch_size: int = 1,
    stom=None,
    device: DeviceLike = None,
    stats: Optional[Dict[str, float]] = None,
) -> int:
    """Writes {"id", "pred"} JSON lines to `out_path`, skipping ids already
    there; returns how many it wrote. `stom`: the STOM to propagate with
    (default: `STOM(device=device)`, the repo's CoTracker3 weights on the
    card unless `device` asks for the CPU). `stats`, when given, receives
    the host seconds of the STOM leg (`stom_s`, on the worker thread when
    batched), of the chat leg (`answer_s`) and of the main thread's waits
    for STOM (`stom_wait_s`)."""
    done_ids = set()
    if os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                try:
                    done_ids.add(json.loads(line)["id"])
                except Exception:
                    pass
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    acc = {"stom_s": 0.0, "answer_s": 0.0, "stom_wait_s": 0.0}
    n = 0
    if use_stom and stom is None:
        from ..models.stom import STOM

        stom = STOM(device=device)
    elif not use_stom:
        stom = None

    def prepare(item, pre_propagated=None):
        frames = item["frames"]  # list of (H, W, 3) uint8
        overlay = item.get("vip_overlay")
        if overlay is not None:
            key = item.get("key_idx", 0)
            if pre_propagated is not None:
                frames = pre_propagated
            elif stom is not None:
                t0 = time.perf_counter()
                frames = stom.propagate_in_video(
                    list(frames), overlay, key, shape=item.get("shape", "rectangle"))
                acc["stom_s"] += time.perf_counter() - t0
            else:
                from ..models.stom.stom import _composite_window

                frames = list(frames)
                base = np.ascontiguousarray(np.asarray(frames[key])[..., :3]).copy()
                _composite_window(base, np.asarray(overlay), 0, 0)
                frames[key] = base
        return REFERRING_VQA_PROMPT.format(text=item["question"]), frames

    def stom_props(batch: List) -> Dict[int, List[np.ndarray]]:
        """One tracker call for the batch's overlays: {row: frames}."""
        todo = [(j, it) for j, it in enumerate(batch)
                if stom is not None and it.get("vip_overlay") is not None]
        if not todo:
            return {}
        t0 = time.perf_counter()
        outs = stom.propagate_in_video_batch([
            {"frames": list(it["frames"]), "vip": it["vip_overlay"],
             "key_idx": it.get("key_idx", 0), "shape": it.get("shape", "rectangle")}
            for _, it in todo
        ])
        acc["stom_s"] += time.perf_counter() - t0
        return {j: o for (j, _), o in zip(todo, outs)}

    batched = batch_size > 1 and hasattr(chat, "answer_batch")
    todo_items = [item for i, item in enumerate(items)
                  if i % subset_num == subset_idx and item["id"] not in done_ids]
    with open(out_path, "a") as out:
        if batched:
            from concurrent.futures import ThreadPoolExecutor

            batches = [todo_items[k:k + batch_size]
                       for k in range(0, len(todo_items), batch_size)]
            with ThreadPoolExecutor(max_workers=1) as ex:
                fut = ex.submit(stom_props, batches[0]) if batches else None
                for k, batch in enumerate(batches):
                    t0 = time.perf_counter()
                    props = fut.result()
                    acc["stom_wait_s"] += time.perf_counter() - t0
                    fut = ex.submit(stom_props, batches[k + 1]) if k + 1 < len(batches) else None
                    rows = [prepare(it, pre_propagated=props.get(j))
                            for j, it in enumerate(batch)]
                    t0 = time.perf_counter()
                    preds = chat.answer_batch([q for q, _ in rows],
                                              video_frames_list=[f for _, f in rows])
                    acc["answer_s"] += time.perf_counter() - t0
                    for it, pred in zip(batch, preds):
                        out.write(json.dumps({"id": it["id"], "pred": pred}) + "\n")
                        n += 1
                    out.flush()
        else:
            for item in todo_items:
                question, frames = prepare(item)
                t0 = time.perf_counter()
                pred = chat.answer(question, video_frames=frames)
                acc["answer_s"] += time.perf_counter() - t0
                out.write(json.dumps({"id": item["id"], "pred": pred}) + "\n")
                out.flush()
                n += 1
    if stats is not None:
        stats.update(acc)
    return n

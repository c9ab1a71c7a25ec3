"""VideoInfer baseline drivers, the port's own copy of
`rga3_tpu/evaluation/videoinfer_baselines.py`: other models scored on
VideoInfer for the comparison table.

  * GPT-4o: the system prompt, the JSON-answer contract, an unparseable
    reply asked again at a temperature 0.5 higher (at most three tries,
    then "I don't know."), a transport error answered as
    "{'answer': 'None'}", and a resumable nested merged_result.json, behind
    a transport callable (any OpenAI-compatible endpoint; tests use fakes);
  * a local-model harness: the same job list, key-frame blending and resume
    for any `answer_fn(frames, question)` (an Osprey, VideoLLaMA3 or
    VideoRefer wrapper plugs in there).

Both take the items of `evaluation.eval_videoinfer.load_items` and blend
the fixed RGBA prompt onto the key frame only: the baselines never
propagate it with STOM. PIL is imported where a frame is blended.
"""
from __future__ import annotations

import ast
import base64
import io
import json
import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np

GPT4O_SYSTEM = (
    "You are a helpful assistant."
    "Your task is to watch the video and answer the question."
    "You should response in JSON format, like: {'answer': '...'} "
    "directly. Remember to use escape characters."
)


def blend_key_frame(frames, overlay: Optional[np.ndarray], key_idx: int):
    """PIL RGB frames, the RGBA overlay alpha-composited onto
    frames[key_idx] (the baselines' only visual-prompt handling)."""
    from PIL import Image

    out = []
    for i, f in enumerate(frames):
        img = Image.fromarray(np.asarray(f)).convert("RGB")
        if overlay is not None and i == key_idx:
            img = Image.alpha_composite(
                img.convert("RGBA"), Image.fromarray(overlay, "RGBA")
            ).convert("RGB")
        out.append(img)
    return out


def image_to_base64(image) -> str:
    buf = io.BytesIO()
    image.save(buf, format="JPEG")
    return base64.b64encode(buf.getvalue()).decode("utf-8")


def build_gpt4o_messages(frames, question: str) -> list:
    """N data-URL JPEG image parts (detail high) and the question text,
    under the JSON-contract system prompt."""
    content = [
        {
            "type": "image_url",
            "image_url": {
                "url": f"data:image/jpeg;base64,{image_to_base64(f)}",
                "detail": "high",
            },
        }
        for f in frames
    ]
    content.append({"type": "text", "text": question})
    return [
        {"role": "system", "content": GPT4O_SYSTEM},
        {"role": "user", "content": content},
    ]


def parse_json_answer(content: str) -> Optional[str]:
    """The 'answer' field of a single-quoted dict (`ast.literal_eval`) or
    of JSON, else None; the model's output is never executed."""
    for parser in (ast.literal_eval, json.loads):
        try:
            result = parser(content)
        except Exception:
            continue
        if isinstance(result, dict) and "answer" in result:
            return str(result["answer"])
    return None


def _load_nested(path: str) -> Dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _store(results: Dict, item: Dict, answer: str) -> None:
    results.setdefault(item["vid_id"], {}).setdefault(
        item["exp_id"], {}
    )[item["qa_id"]] = answer


def _done(results: Dict, item: Dict) -> bool:
    return (
        item["qa_id"]
        in results.get(item["vid_id"], {}).get(item["exp_id"], {})
    )


def _save(results: Dict, out_path: str) -> None:
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(results, f, indent=2, ensure_ascii=False)


def run_gpt4o_baseline(
    items: Sequence[Dict],
    transport: Callable,  # (messages, max_tokens, temperature) -> str
    out_path: str,
    max_tokens: int = 64,
    max_tries: int = 3,
    save_every: int = 20,
) -> Dict:
    """The GPT-4o loop: greedy first, then, on an unparseable reply, asked
    again at a temperature 0.5 higher a try; after max_tries the answer is
    "I don't know." A transport exception on a request counts as the reply
    "{'answer': 'None'}". `transport(messages, max_tokens, temperature)`
    returns the reply's text. Resumes from out_path; returns the nested
    {vid: {exp: {qa: answer}}} dict."""
    results = _load_nested(out_path)
    n_new = 0
    for item in items:
        if _done(results, item):
            continue
        frames = blend_key_frame(
            item["frames"], item.get("vip_overlay"), item.get("key_idx", 0)
        )
        messages = build_gpt4o_messages(frames, item["question"])

        def ask(temperature: float) -> str:
            try:
                return transport(
                    messages, max_tokens=max_tokens,
                    temperature=temperature,
                )
            except Exception:  # a failed request answers 'None'
                return "{'answer': 'None'}"

        temperature = 0.0
        answer = None
        for _ in range(max_tries):
            answer = parse_json_answer(ask(temperature))
            if answer is not None:
                break
            temperature += 0.5
        if answer is None:
            answer = "I don't know."
        _store(results, item, answer)
        n_new += 1
        if n_new % save_every == 0:
            _save(results, out_path)
    _save(results, out_path)
    return results


def run_local_baseline(
    items: Sequence[Dict],
    answer_fn: Callable,  # (frames: List[PIL.Image], question) -> str
    out_path: str,
    save_every: int = 20,
) -> Dict:
    """The same job list, blending and resume for a local model, injected
    as `answer_fn(frames, question)`."""
    results = _load_nested(out_path)
    n_new = 0
    for item in items:
        if _done(results, item):
            continue
        frames = blend_key_frame(
            item["frames"], item.get("vip_overlay"), item.get("key_idx", 0)
        )
        _store(results, item, str(answer_fn(frames, item["question"])))
        n_new += 1
        if n_new % save_every == 0:
            _save(results, out_path)
    _save(results, out_path)
    return results

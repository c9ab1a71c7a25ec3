"""GPT-judge plumbing, the port's own copy of
`rga3_tpu/evaluation/gpt_judge.py`: ViP-Bench's five-run grading and the
VideoInfer batch protocol, behind a transport callable.

  * ViP-Bench: a markdown-table correctness prompt; the score is the
    completion's first token as a float in [0, 1]; an unparseable reply is
    asked again with an appended "(digit)" instruction at a temperature
    0.5 higher, up to five tries, then scored 0.0; `num_run` repeats; a
    resumable per-sample grade file; per-capability aggregation (x100, the
    mean over runs, the std of the total).
  * VideoInfer: OpenAI batch-API JSONL requests (`custom_id`
    "vid____exp____qa", response_format json_object) and their outputs
    parsed as {'pred': yes / no, 'score': 0-5}: accuracy = yes / (yes + no)
    and the mean score.

The judge prompts are protocol constants, copied verbatim: scores compare
across models only under the same rubric text.

`transport(messages, max_tokens=..., temperature=...) -> (content,
model_name)` makes the API call; the tests drive the loops with fakes.
`openai_transport()` builds one over the `openai` package, imported when it
is called.
"""
from __future__ import annotations

import ast
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# the ViP-Bench evaluator's prompt (a verbatim protocol constant)
VIPBENCH_JUDGE_PROMPT = """Compare the ground truth and prediction from AI models, to give a correctness score for the prediction. <AND> in the ground truth means it is totally right only when all elements in the ground truth are present in the prediction, and <OR> means it is totally right when any one element in the ground truth is present in the prediction. The correctness score is 0.0 (totally wrong), 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, or 1.0 (totally right). Just complete the last space of the correctness score.

Question | Ground truth | Prediction | Correctness
--- | --- | --- | ---
What is x in the equation within the yellow rectangle? | -1 <AND> -5 | x = 3 | 0.0
What is x in the equation within the yellow rectangle? | -1 <AND> -5 | x = -1 | 0.5
What is x in the equation within the yellow rectangle? | -1 <AND> -5 | x = -5 | 0.5
What is x in the equation within the red rectangle? | -1 <AND> -5 | x = -5 or 5 | 0.5
What is x in the equation within the orange rectangle? | -1 <AND> -5 | x = -1 or x = -5 | 1.0
Can you explain this meme within the blue rectangle? | This meme is poking fun at the fact that the names of the countries Iceland and Greenland are misleading. Despite its name, Iceland is known for its beautiful green landscapes, while Greenland is mostly covered in ice and snow. The meme is saying that the person has trust issues because the names of these countries do not accurately represent their landscapes. | The meme talks about Iceland and Greenland. It's pointing out that despite their names, Iceland is not very icy and Greenland isn't very green. | 0.4
Can you explain this meme within the blue rectangle? | This meme is poking fun at the fact that the names of the countries Iceland and Greenland are misleading. Despite its name, Iceland is known for its beautiful green landscapes, while Greenland is mostly covered in ice and snow. The meme is saying that the person has trust issues because the names of these countries do not accurately represent their landscapes. | The meme is using humor to point out the misleading nature of Iceland's and Greenland's names. Iceland, despite its name, has lush green landscapes while Greenland is mostly covered in ice and snow. The text 'This is why I have trust issues' is a playful way to suggest that these contradictions can lead to distrust or confusion. The humor in this meme is derived from the unexpected contrast between the names of the countries and their actual physical characteristics. | 1.0
"""


def build_vipbench_messages(question: str, answer: str,
                            prediction: str) -> List[Dict]:
    """The grading request: the prompt and one table row to complete."""
    row = " | ".join([
        question,
        answer.replace("<AND>", " <AND> ").replace("<OR>", " <OR> "),
        prediction,
        "",
    ])
    return [{"role": "user", "content": VIPBENCH_JUDGE_PROMPT + "\n" + row}]


def parse_vipbench_score(content: str) -> Optional[float]:
    """The first space-separated token as a float in [0, 1], else None."""
    try:
        score = float(content.split(" ")[0].strip())
    except (ValueError, IndexError):
        return None
    if not 0.0 <= score <= 1.0:
        return None
    return score


def grade_vipbench(
    data: Dict[str, Dict],        # id -> {"question", "answer", "capability"}
    results: Dict[str, str],      # id -> model prediction (answer text)
    transport: Callable[..., Tuple[str, str]],
    grade_file: str,
    num_run: int = 5,
    questions: Optional[Dict[str, str]] = None,  # id -> question override
) -> Dict[str, Dict]:
    """The evaluator's grading loop: resumable (grade_file holds partial
    per-sample run lists), retry protocol per sample (fallback "(digit)"
    prompt, temperature += 0.5, 5 tries then score 0.0), num_run repeats.
    Returns id -> {"model": [...], "content": [...], "score": [...]}."""
    grade_results: Dict[str, Dict] = {}
    if os.path.exists(grade_file):
        with open(grade_file) as f:
            grade_results = json.load(f)

    def need_more_runs() -> bool:
        if any(len(v["score"]) < num_run for v in grade_results.values()):
            return True
        return len(grade_results) < len(data)

    while need_more_runs():
        for j in range(num_run):
            for sid, line in data.items():
                done = grade_results.get(sid, {"score": []})
                if len(done["score"]) >= j + 1:
                    continue
                q = (questions or {}).get(sid, line["question"])
                messages = build_vipbench_messages(
                    q, line["answer"], results[sid]
                )
                temperature = 0.0
                try_time = 1
                score = None
                content, model_name = transport(
                    messages, max_tokens=3, temperature=temperature
                )
                while score is None:
                    score = parse_vipbench_score(content)
                    if score is not None:
                        break
                    if try_time > 5:
                        score = 0.0
                        break
                    # re-ask with an explicit digit instruction and more
                    # temperature
                    retry = build_vipbench_messages(
                        line["question"], line["answer"], results[sid]
                    )
                    retry[0]["content"] += (
                        "\nPredict the correctness of the answer (digit): "
                    )
                    try_time += 1
                    temperature += 0.5
                    content, model_name = transport(
                        retry, max_tokens=3, temperature=temperature
                    )
                sample = grade_results.get(
                    sid, {"model": [], "content": [], "score": []}
                )
                sample["model"].append(model_name)
                sample["content"].append(content)
                sample["score"].append(score)
                grade_results[sid] = sample
                with open(grade_file, "w") as f:
                    json.dump(grade_results, f, indent=4)
    return grade_results


def aggregate_vipbench(
    grade_results: Dict[str, Dict],
    data: Dict[str, Dict],
    num_run: int = 5,
    decimal_places: int = 1,
) -> Dict[str, object]:
    """Per-capability aggregation: scores summed per capability and run,
    x100 / count, the mean over runs; the std and the per-run list of the
    total."""
    caps: Dict[str, int] = {}
    for v in data.values():
        for c in set(v.get("capability", [])):
            caps[c] = caps.get(c, 0) + 1
    cap_scores = {c: np.zeros(num_run) for c in caps}
    total = np.zeros(num_run)
    for sid, v in grade_results.items():
        for i in range(num_run):
            s = v["score"][i]
            for c in set(data[sid].get("capability", [])):
                cap_scores[c][i] += s
            total[i] += s
    out: Dict[str, object] = {}
    for c, arr in cap_scores.items():
        out[c] = round(float((arr / caps[c] * 100).mean()), decimal_places)
    total_pct = total / max(len(data), 1) * 100
    out["total"] = round(float(total_pct.mean()), decimal_places)
    out["std"] = round(float(total_pct.std()), decimal_places)
    out["runs"] = [round(float(x), decimal_places) for x in total_pct]
    return out


# ----------------------------------------------------------------------
# VideoInfer batch protocol

VIDEOINFER_JUDGE_SYSTEM = (
    "You are an intelligent chatbot designed for evaluating the "
    "correctness of generative outputs for question-answer pairs. "
    "Your response should be in JSON format."
    "Your task is to compare the predicted answer with the correct answer "
    "and determine if they match meaningfully. Here's how you can "
    "accomplish the task:"
    "------"
    "##INSTRUCTIONS: "
    "- Focus on the meaningful match between the predicted answer and the "
    "correct answer.\n"
    "- Consider synonyms or paraphrases as valid matches.\n"
    "- Evaluate the correctness of the prediction compared to the answer."
)


def build_videoinfer_judge_user(question: str, gt_answer: str,
                                pred_answer: str) -> str:
    return (
        "Please evaluate the following video-based question-answer "
        "pair:\n\n"
        f"Question: {question}\n"
        f"Correct Answer: {gt_answer}\n"
        f"Predicted Answer: {pred_answer}\n\n"
        "Provide your evaluation only as a yes/no and score where the "
        "score is an integer value between 0 and 5, with 5 indicating "
        "the highest meaningful match. "
        "Please generate the response in the form of a Python dictionary "
        "string with keys 'pred' and 'score', where value of 'pred' is  a "
        "string of 'yes' or 'no' and value of 'score' is in INTEGER, not "
        "STRING."
        "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only "
        "provide the Python dictionary string. "
        "For example, your response should look like this: "
        "{'pred': 'yes', 'score': 4.8}."
    )


def build_videoinfer_batch_requests(
    eval_result: Dict[str, Dict[str, Dict[str, Dict]]],
    model: str = "gpt-4o-batch",
) -> List[Dict]:
    """eval_result[vid][exp_id][qa_id] = {"question", "gt_answer",
    "pred_answer"} -> OpenAI batch-API request records with
    custom_id "vid____exp____qa"."""
    requests = []
    for vid, exps in eval_result.items():
        for exp_id, qas in exps.items():
            for qa_id, sample in qas.items():
                requests.append({
                    "custom_id": f"{vid}____{exp_id}____{qa_id}",
                    "method": "POST",
                    "url": "/chat/completions",
                    "body": {
                        "model": model,
                        "response_format": {"type": "json_object"},
                        "messages": [
                            {"role": "system",
                             "content": VIDEOINFER_JUDGE_SYSTEM},
                            {"role": "user",
                             "content": build_videoinfer_judge_user(
                                 sample["question"],
                                 sample["gt_answer"],
                                 sample["pred_answer"],
                             )},
                        ],
                    },
                })
    return requests


def write_batch_requests(path: str, requests: Sequence[Dict]) -> None:
    with open(path, "w") as f:
        for r in requests:
            json.dump(r, f)
            f.write("\n")


def parse_videoinfer_batch_outputs(
    lines: Sequence[str],
) -> Dict[str, object]:
    """The batch outputs' aggregation: per-sample {'pred','score'}
    dict literal from the batch output JSONL; score clamped to [0, 5],
    accuracy = yes / (yes + no). Returns {accuracy, average_score,
    yes_count, no_count, error_count, per_sample}."""
    yes = no = errors = 0
    score_sum = 0.0
    count = 0
    per_sample: Dict[str, Dict] = {}
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            sample = json.loads(line)
            # failed batch requests carry response=null / an error object
            # without body.choices — count them, don't crash
            msg = sample["response"]["body"]["choices"][0]["message"]
        except (json.JSONDecodeError, KeyError, TypeError, IndexError):
            errors += 1
            continue
        if "content" not in msg:
            continue
        try:
            result = ast.literal_eval(msg["content"])
            rec: Dict = {}
            if "score" in result:
                count += 1
                score = max(min(int(result["score"]), 5), 0)
                rec["score"] = score
                score_sum += score
            if "pred" in result:
                rec["pred"] = result["pred"]
                if "yes" in str(result["pred"]).lower():
                    yes += 1
                elif "no" in str(result["pred"]).lower():
                    no += 1
            per_sample[sample["custom_id"]] = rec
        except Exception:
            errors += 1
            continue
    return {
        "accuracy": yes / max(yes + no, 1),
        "average_score": score_sum / max(count, 1),
        "yes_count": yes,
        "no_count": no,
        "error_count": errors,
        "per_sample": per_sample,
    }


def openai_transport(model: str, client=None) -> Callable:
    """A transport over the `openai` package (imported here, so the module
    needs no `openai` until one is built; tests use fakes)."""
    if client is None:
        import openai

        client = openai.OpenAI()

    def call(messages, max_tokens=3, temperature=0.0):
        resp = client.chat.completions.create(
            model=model, max_tokens=max_tokens, temperature=temperature,
            messages=messages,
        )
        return resp.choices[0].message.content, resp.model

    return call

"""VideoInfer baseline CLI, counterpart of
`scripts/eval_videoinfer_baselines.py`: GPT-4o over an OpenAI-compatible
endpoint (the `openai` package, imported when the transport is built):

    python -m rga3_tpu_torch.evaluation.eval_videoinfer_baselines \
        --data_root <videoinfer> --baseline gpt4o --model gpt-4o \
        --out <dir>/GPT-4o-high-8frames/merged_result.json \
        [--num_frames 8] [--subset_idx I --subset_num N]

The items are `eval_videoinfer.load_items`'s, sharded by `i % subset_num ==
subset_idx`, the prompt overlay blended onto the key frame only (no STOM);
the nested answers resume from `--out`. Local models go through
`videoinfer_baselines.run_local_baseline` with an `answer_fn` of their own.
Nothing here runs on the card.
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional, Sequence

from .eval_videoinfer import load_items
from .gpt_judge import openai_transport
from .videoinfer_baselines import run_gpt4o_baseline


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_root", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--baseline", choices=["gpt4o"], default="gpt4o")
    p.add_argument("--model", default="gpt-4o")
    p.add_argument("--num_frames", type=int, default=8)
    p.add_argument("--subset_idx", type=int, default=0)
    p.add_argument("--subset_num", type=int, default=1)
    p.add_argument("--out", required=True)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, transport: Optional[Callable] = None) -> dict:
    """Answer the shard's items; returns the nested {vid: {exp: {qa:
    answer}}} results. `transport(messages, max_tokens, temperature) -> text`
    replaces the OpenAI endpoint (whose transport returns (text, model): the
    text is what the baseline parses)."""
    args = parse_args(argv)
    if transport is None:
        call = openai_transport(args.model)

        def transport(messages, max_tokens, temperature):
            return call(messages, max_tokens=max_tokens, temperature=temperature)[0]

    items = (item for i, item in enumerate(load_items(args.data_root, args.split, args.num_frames))
             if i % args.subset_num == args.subset_idx)
    results = run_gpt4o_baseline(items, transport, args.out)
    n = sum(len(qas) for exps in results.values() for qas in exps.values())
    print(f"{n} answers -> {args.out}", flush=True)
    return results


if __name__ == "__main__":
    main()
